"""The (data, cluster) mesh over the ranks of a torch.distributed world.

The replacement for the reference's process topology (MPI ranks x GPUs,
``gaussian.cu:133-139``) and the port of the JAX package's 2-D device mesh:

  ``data``    -- events sharded along it (the reference's only strategy:
                 contiguous event shards per GPU, gaussian.cu:347-377)
  ``cluster`` -- clusters sharded along it (the cross-device form of the
                 reference's per-cluster grid dimension, estep1's
                 blockIdx.y, gaussian_kernel.cu:396)

A world of S x C ranks forms the mesh row-major: rank r sits at data index
r // C and cluster index r % C (the layout of
``np.asarray(devices).reshape(shape)``). Each rank holds two process
groups: its mesh row (the C ranks of its data index: the cluster axis) and
its mesh column (the S ranks of its cluster index: the data axis). A group
of one rank is None, and collectives over it are skipped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch.distributed as dist

from .distributed import rank, world_size

DATA_AXIS = "data"
CLUSTER_AXIS = "cluster"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and its two process groups."""

    shape: Tuple[int, int]
    rank: int
    data_group: Optional[object]     # the data axis (size S), or None
    cluster_group: Optional[object]  # the cluster axis (size C), or None

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def cluster_size(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def cluster_index(self) -> int:
        return self.rank % self.shape[1]


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """Build the mesh over the world. ``shape=None`` puts every rank on the
    data axis. Every rank must call this, in the same order as its other
    group-creating calls: each ``dist.new_group`` is collective."""
    world, me = world_size(), rank()
    if shape is None:
        shape = (world, 1)
    S, C = (int(v) for v in shape)
    if S * C != world:
        raise ValueError(
            f"mesh shape {(S, C)} needs {S * C} ranks, the world has {world}")
    data_group = cluster_group = None
    if C > 1:
        for i in range(S):
            g = dist.new_group([i * C + j for j in range(C)])
            if i == me // C:
                cluster_group = g
    if S > 1:
        for j in range(C):
            g = dist.new_group([i * C + j for i in range(S)])
            if j == me % C:
                data_group = g
    return Mesh((S, C), me, data_group, cluster_group)


def pad_clusters(num_clusters: int, cluster_size: int) -> int:
    """Padded K: a multiple of the cluster-axis size (inactive tail slots)."""
    return int(math.ceil(num_clusters / cluster_size) * cluster_size)


def shard_chunks(mesh: Mesh, data_chunks, wts_chunks):
    """This rank's contiguous block of the [num_chunks, B, D] chunk grid and
    its [num_chunks, B] weights (the per-GPU event slice of
    gaussian.cu:347-377). num_chunks must be a multiple of the data axis
    (``chunk_events(..., num_shards=)``)."""
    c = data_chunks.shape[0]
    if c % mesh.data_size:
        raise ValueError(f"{c} chunks do not split over a data axis of "
                         f"{mesh.data_size}")
    block = c // mesh.data_size
    lo = mesh.data_index * block
    return data_chunks[lo:lo + block], wts_chunks[lo:lo + block]


def cluster_slice(mesh: Mesh, state):
    """This rank's rows of a state whose K is a multiple of the cluster
    axis (views, no copy)."""
    k = state.num_clusters_padded // mesh.cluster_size
    lo = mesh.cluster_index * k
    return type(state)(**{f.name: getattr(state, f.name)[lo:lo + k]
                          for f in dataclasses.fields(state)})
