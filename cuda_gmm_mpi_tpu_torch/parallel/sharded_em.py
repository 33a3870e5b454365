"""Sharded EM: the per-K EM loop on every rank of a (data, cluster) mesh.

The port of the JAX package's ``parallel/sharded_em.py``. JAX runs the mesh
as one SPMD program over devices; here each rank is a process running the
same host loop (``em_while_loop``) on its own shard:

  - events sharded over the ``data`` axis: each rank computes the fused
    statistics of its own block of chunks, and one all_reduce SUM over the
    data group of the whole SuffStats, packed into one flat buffer, stands
    in for the reference's four MPI_Allreduce calls of N / means / R sums /
    loglik (gaussian.cu:516,566,605,658);
  - clusters sharded over the ``cluster`` axis: each rank holds K / C
    clusters; the E-step's log-sum-exp becomes a MAX then a SUM all_reduce
    over the cluster group (K5 + K6 on the kernel path, ``posteriors`` on
    the torch-ops path), and the M-step updates the rank's own clusters,
    with pi normalised by an all_reduce of the soft count;
  - the parameters stay replicated over the data axis: every rank of a
    column computes the same update from the same reduced statistics, so no
    broadcast is needed (the reference's MPI_Bcast after a merge,
    gaussian.cu:918-924).

The order search (models/order_search.py) gathers the clusters of a mesh
row before each merge scan (:meth:`ShardedGMMModel.gather_state`), runs the
same scan on every rank and keeps its own rows again
(:meth:`ShardedGMMModel.rebucket_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import GMMConfig
from ..models.gmm import GMMModel, _em_loop, _memberships, setup_device
from ..ops.estep import posteriors
from ..ops.mstep import SuffStats
from ..state import compact_to
from . import distributed
from .mesh import cluster_slice, make_mesh, pad_clusters, shard_chunks


def pad_state_clusters(state, cluster_size: int):
    """Pad the state's K axis to a multiple of the cluster-axis size with
    inert (inactive, identity-R) slots. No-op when already aligned."""
    K = state.num_clusters_padded
    pad = pad_clusters(K, cluster_size) - K
    if pad == 0:
        return state
    D = state.num_dimensions
    dt, dev = state.R.dtype, state.R.device
    zk = torch.zeros(pad, dtype=state.N.dtype, device=dev)
    eye = torch.eye(D, dtype=dt, device=dev).expand(pad, D, D)
    cat = lambda a, b: torch.cat([a, b])
    return state.replace(
        N=cat(state.N, zk), pi=cat(state.pi, zk),
        constant=cat(state.constant, zk), avgvar=cat(state.avgvar, zk),
        means=cat(state.means, torch.zeros((pad, D), dtype=dt, device=dev)),
        R=cat(state.R, eye), Rinv=cat(state.Rinv, eye),
        active=cat(state.active, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)))


def make_psum_reduce(data_group):
    """Stats reduction hook: one all_reduce SUM over the data axis of the
    whole SuffStats (loglik, Nk, M1, M2 packed into one flat buffer, so it
    is one collective). Identity when the data axis has one rank."""
    def reduce(stats: SuffStats) -> SuffStats:
        if data_group is None:
            return stats
        leaves = [getattr(stats, f.name) for f in dataclasses.fields(stats)]
        flat = torch.cat([t.reshape(-1) for t in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=data_group)
        parts = torch.split(flat, [t.numel() for t in leaves])
        return SuffStats(*(p.reshape(t.shape) for p, t in zip(parts, leaves)))

    return reduce


class ShardedGMMModel:
    """GMMModel's interface (``run_em``, ``memberships``) for one rank of a
    mesh, so that ``fit_gmm`` drives the order search the same way.

    ``estep_backend``/``estep_backend_reason`` name the statistics path:
    'cuda' is K1 + K2 per rank on a data-only mesh and K5 + K6 (M-step in
    torch ops) when the cluster axis is sharded; 'torch' the torch-ops
    path. ``collective_backend`` is the world's ('nccl', 'gloo', or 'none'
    for a single process).
    """

    def __init__(self, config: GMMConfig = GMMConfig(), mesh=None,
                 stats_fn=None):
        from ..ops.kernels import make_mstep_fn, make_stats_fn, resolve_estep_backend

        self.config = config
        self.device = setup_device(config)
        self.mesh = mesh if mesh is not None else make_mesh(config.mesh_shape)
        sharded = self.cluster_size > 1
        if stats_fn is None:
            self.estep_backend, self.estep_backend_reason = \
                resolve_estep_backend(config, cluster_sharded=sharded)
            stats_fn = make_stats_fn(config, cluster_sharded=sharded,
                                     cluster_group=self.mesh.cluster_group)
            self.mstep_fn = make_mstep_fn(config, cluster_sharded=sharded)
        else:
            self.estep_backend = "custom"
            self.estep_backend_reason = "caller-supplied stats_fn"
            self.mstep_fn = None
        self.stats_fn = stats_fn
        self.collective_backend = distributed.backend() or "none"
        # Buckets must stay evenly partitionable over the cluster axis.
        self.bucket_multiple = self.cluster_size
        self._reduce = make_psum_reduce(self.mesh.data_group)
        self._k_cols = None  # the unpadded K of the last prepared state
        self.last_health = None
        self.last_lls = None
        self._armed_faults = {}

    armed_fault = GMMModel.armed_fault

    @property
    def data_size(self) -> int:
        return self.mesh.data_size

    @property
    def cluster_size(self) -> int:
        return self.mesh.cluster_size

    def place(self, array) -> torch.Tensor:
        """A host array as a tensor of the model's device and dtype."""
        return torch.as_tensor(np.asarray(array, self.config.dtype),
                               device=self.device)

    def prepare(self, state, data_chunks, wts_chunks):
        """(this rank's state, its chunk block, its weights) from the full
        state and the full chunk grid (a multiple of the data axis)."""
        chunks, wts = shard_chunks(self.mesh, data_chunks, wts_chunks)
        return self.prepare_state(state), self.place(chunks), self.place(wts)

    def prepare_state(self, state):
        """This rank's clusters of a full state: K padded to the cluster
        axis with inert slots, then the rank's rows, on the device."""
        self._k_cols = state.num_clusters_padded
        padded = pad_state_clusters(state.to(self.device), self.cluster_size)
        return cluster_slice(self.mesh, padded)

    def local_events(self, n_events: int, data_chunks) -> int:
        """The real events in front of this rank's chunk block (the global
        grid holds ``n_events`` real rows, then zero-weight padding); at
        least 1, so a block of padding still hands the kernels a row (of
        weight 0)."""
        rows = data_chunks.shape[0] * data_chunks.shape[1]
        lo = self.mesh.data_index * rows
        return min(max(n_events - lo, 1), rows)

    def run_em(self, state, data_chunks, wts_chunks, epsilon: float,
               min_iters: Optional[int] = None,
               max_iters: Optional[int] = None,
               n_events: Optional[int] = None, *, sweep: bool = False):
        """EM on this rank's shard; returns (state, loglik, iters) with the
        loglik of all events. ``n_events`` is the real events of the whole
        grid; the kernels get this rank's share of them. The health
        counters (``last_health``) are the whole mesh's: the statistics'
        lanes come summed over the data axis, the state's over the cluster
        group."""
        state, ll, iters, _, _, _ = self.run_em_resumable(
            state, data_chunks, wts_chunks, epsilon, min_iters, max_iters,
            n_events=n_events, sweep=sweep)
        return state, ll, iters

    def run_em_resumable(self, state, data_chunks, wts_chunks, epsilon,
                         min_iters: Optional[int] = None,
                         max_iters: Optional[int] = None,
                         n_events: Optional[int] = None, *,
                         sweep: bool = False, poll_iters: int = 25,
                         should_stop=None, resume: Optional[dict] = None):
        """:meth:`GMMModel.run_em_resumable` on this rank's shard."""
        cfg = self.config
        stats_fn = self.stats_fn
        if n_events is not None and self.estep_backend == "cuda":
            stats_fn = functools.partial(
                stats_fn, n_events=self.local_events(n_events, data_chunks))
        inj = self.armed_fault(state, data_chunks, sweep=sweep)
        run = _em_loop(
            state, data_chunks, wts_chunks, epsilon,
            cfg.min_iters if min_iters is None else min_iters,
            cfg.max_iters if max_iters is None else max_iters,
            diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
            matmul_precision=cfg.matmul_precision,
            precompute_features=cfg.precompute_features, stats_fn=stats_fn,
            mstep_fn=self.mstep_fn, reduce_stats=self._reduce,
            cluster_group=self.mesh.cluster_group,
            covariance_type=cfg.covariance_type,
            dynamic_range=cfg.covariance_dynamic_range,
            regression_scale=cfg.health_regression_scale,
            nan_iter=None if inj is None else int(inj["iter"]),
            should_stop=should_stop, poll_iters=poll_iters, resume=resume)
        self.last_health, self.last_lls = run.health, run.lls
        return (run.state, run.loglik, run.iters, run.lls, run.stopped,
                run.extra)

    def gather_state(self, state):
        """The full state of this rank's mesh row, with the cluster padding
        dropped: one all_reduce SUM over the cluster group of a zero buffer
        in which each rank fills its own rows (exact: x + 0 = x)."""
        group = self.mesh.cluster_group
        if group is not None:
            fields = [f.name for f in dataclasses.fields(state)]
            dt = state.R.dtype
            leaves = [getattr(state, f).to(dt) for f in fields]
            k = state.num_clusters_padded
            C, j = self.cluster_size, self.mesh.cluster_index
            buf = torch.zeros((C, sum(t.numel() for t in leaves)), dtype=dt,
                              device=state.R.device)
            buf[j] = torch.cat([t.reshape(-1) for t in leaves])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            parts = torch.split(buf, [t.numel() for t in leaves], dim=1)
            full = {f: p.reshape((C * k,) + t.shape[1:])
                    for f, p, t in zip(fields, parts, leaves)}
            full["active"] = full["active"] > 0.5
            state = type(state)(**full)
        return state.take(torch.arange(self._k_cols, device=state.N.device))

    def rebucket_state(self, full_state, num_clusters: int):
        """This rank's rows of a gathered state, narrowed to
        ``num_clusters`` (rounded up to the cluster axis) when that is
        narrower."""
        num_clusters = pad_clusters(num_clusters, self.cluster_size)
        if num_clusters < full_state.num_clusters_padded:
            full_state = compact_to(full_state, num_clusters)
        return self.prepare_state(full_state)

    def assert_same_merge(self, k_active: int, pair) -> None:
        """Every rank must have made the same merge choice from its copy of
        the gathered state: one all_reduce MAX of (v, -v) over the world,
        which returns (max, -min). Raises on every rank if they differ."""
        if not distributed.is_initialized():
            return
        v = torch.tensor([k_active, *pair], dtype=torch.float64,
                         device=self.device)
        both = torch.cat([v, -v])
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        hi, lo = both[:3].tolist(), (-both[3:]).tolist()
        if hi != lo:
            raise RuntimeError(
                f"ranks disagree on the merge: K in {lo[0]:.0f}..{hi[0]:.0f}, "
                f"pair between ({lo[1]:.0f}, {lo[2]:.0f}) and "
                f"({hi[1]:.0f}, {hi[2]:.0f})")

    # The output pass runs on one rank over the gathered, compacted state,
    # through the single-device posteriors (GMMModel's).
    @property
    def inference_block(self) -> int:
        return self.config.chunk_size

    def infer_posteriors(self, state, xb):
        """(w [B, K], logZ [B]) for one block of events, on this rank."""
        cfg = self.config
        return posteriors(state, torch.as_tensor(xb, device=self.device),
                          diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
                          matmul_precision=cfg.matmul_precision)

    def memberships(self, state, data_chunks, return_logz: bool = False):
        """Posteriors [N_padded, K] (and with ``return_logz`` the log
        evidence [N_padded]) from a full (gathered) state."""
        return _memberships(self, state, data_chunks, return_logz)
