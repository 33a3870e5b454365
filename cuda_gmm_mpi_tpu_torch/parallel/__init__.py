"""The mesh path: EM over the ranks of a torch.distributed world, events
sharded over the ``data`` axis and clusters over the ``cluster`` axis."""

from . import distributed, elastic
from .mesh import (
    CLUSTER_AXIS, DATA_AXIS, Mesh, cluster_slice, make_mesh, pad_clusters,
    shard_chunks,
)
from .sharded_em import ShardedGMMModel, make_psum_reduce, pad_state_clusters

__all__ = ["CLUSTER_AXIS", "DATA_AXIS", "Mesh", "ShardedGMMModel",
           "cluster_slice", "distributed", "elastic", "make_mesh", "make_psum_reduce",
           "pad_clusters", "pad_state_clusters", "shard_chunks"]
