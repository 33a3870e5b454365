"""Sharded EM: the per-K EM loop on every rank of a (data, cluster) mesh.

The port of the JAX package's ``parallel/sharded_em.py``. JAX runs the mesh
as one SPMD program over devices; here each rank is a process running the
same device-controlled EM loop (``em_program_run``, eagerly: the
collectives go through the host) on its own shard:

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
from ..models.gmm import (
    GMMModel, _memberships, em_program_run, em_while_loop_batched,
    lane_loop_mstep, lane_loop_stats, resolve_iters_batched, setup_device,
)
from ..ops.estep import posteriors
from ..ops.mstep import SuffStats, accumulate_stats, apply_mstep
from ..state import compact_to, lane, stack_states
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
        from ..ops.kernels import (
            make_batched_stats_fn, make_fleet_stats_fn, make_mstep_fn,
            make_stats_fn, resolve_estep_backend,
        )

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
            # Restart batches: K3 + K4 per rank on a data-only mesh; the
            # lanes of the mesh's own loop where these are None.
            self.batched_stats_fn = make_batched_stats_fn(
                config, cluster_sharded=sharded)
            self.batched_mstep_fn = make_mstep_fn(
                config, cluster_sharded=sharded, batched=True)
            self.fleet_stats_fn = make_fleet_stats_fn(
                config, cluster_sharded=sharded)
        else:
            self.estep_backend = "custom"
            self.estep_backend_reason = "caller-supplied stats_fn"
            self.mstep_fn = None
            self.batched_stats_fn = self.batched_mstep_fn = None
            self.fleet_stats_fn = None
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
    armed_fleet_fault = GMMModel.armed_fleet_fault

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
        inj = self.armed_fault(state, data_chunks, sweep=sweep)
        lo = cfg.min_iters if min_iters is None else min_iters
        hi = cfg.max_iters if max_iters is None else max_iters
        run = self._run_em(state, data_chunks, wts_chunks, epsilon, lo, hi,
                           n_events, None if inj is None else int(inj["iter"]),
                           should_stop=should_stop, poll_iters=poll_iters,
                           resume=resume)
        self.last_health, self.last_lls = run.health, run.lls
        return (run.state, run.loglik, run.iters, run.lls, run.stopped,
                run.extra)

    def _run_em(self, state, data_chunks, wts_chunks, epsilon, lo: int,
                hi: int, n_events: Optional[int], nan_iter: Optional[int], *,
                should_stop=None, poll_iters: int = 25,
                resume: Optional[dict] = None):
        """One EM run on this rank's shard at bounds (lo, hi) with
        ``nan_iter`` as the armed fault (:meth:`GMMModel._run_em`); the
        kernels get this rank's share of the ``n_events`` real events."""
        cfg = self.config
        stats_fn = self.stats_fn
        if n_events is not None and self.estep_backend == "cuda":
            stats_fn = functools.partial(
                stats_fn, n_events=self.local_events(n_events, data_chunks))
        # The device-controlled loop, run eagerly: its collectives (the
        # statistics' all_reduce, the counts over the cluster group) go
        # through the host every iteration, as each rank steps in lockstep.
        return em_program_run(
            state, data_chunks, wts_chunks, epsilon, lo, hi,
            nan_iter=nan_iter,
            regression_scale=cfg.health_regression_scale,
            should_stop=should_stop, poll_iters=poll_iters, resume=resume,
            diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
            matmul_precision=cfg.matmul_precision,
            precompute_features=cfg.precompute_features, stats_fn=stats_fn,
            mstep_fn=self.mstep_fn, reduce_stats=self._reduce,
            cluster_group=self.mesh.cluster_group,
            covariance_type=cfg.covariance_type,
            dynamic_range=cfg.covariance_dynamic_range)

    # -- restart batches on the mesh (the JAX package's sharded_em.py:
    # 453-528): the lane axis is replicated over the mesh and the clusters
    # sharded like one state's (``batched_state_pspecs``).

    def prepare_states_batched(self, states):
        """This rank's clusters of every lane of a whole restart-batched
        state: each lane padded to the cluster axis with inert slots, then
        the rank's rows (``prepare_states_batched``)."""
        self._k_cols = int(states.N.shape[-1])
        R = int(states.N.shape[0])
        return stack_states([
            cluster_slice(self.mesh, pad_state_clusters(
                lane(states, r).to(self.device), self.cluster_size))
            for r in range(R)])

    def gather_states_batched(self, states):
        """Every lane's whole state from this rank's rows (the batched
        sibling of :meth:`gather_state`; ``host_batched_state``)."""
        if self.mesh.cluster_group is None:
            return states
        R = int(states.N.shape[0])
        return stack_states([self.gather_state(lane(states, r))
                             for r in range(R)])

    def run_em_batched(self, states, data_chunks, wts_chunks, epsilon: float,
                       min_iters=None, max_iters=None,
                       n_events: Optional[int] = None, *, sweep: bool = False,
                       poll_iters: int = 25, should_stop=None, freeze=None,
                       resume: Optional[dict] = None):
        """:meth:`GMMModel.run_em_batched` on this rank's shard.

        On a data-only mesh each iteration is one batched statistics pass
        over the rank's events (K3 on the kernel path), one all_reduce of
        the [R, ...] statistics over the data axis, and one batched M-step
        (K4): the JAX package's "one batched kernel launch per iteration
        per device + one fused collective". With the cluster axis sharded
        the lanes run the mesh's own statistics and M-step one after
        another (K5/K6 and the torch-ops update, or the torch-ops
        collective-LSE path), as the JAX package vmaps its unbatched
        sharded loop."""
        cfg = self.config
        lo, hi = resolve_iters_batched(cfg, states.N.shape[0], min_iters,
                                       max_iters)
        group = self.mesh.cluster_group
        numerics = dict(diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
                        matmul_precision=cfg.matmul_precision)
        stats_fn = self.batched_stats_fn
        if stats_fn is None and self.cluster_size > 1 and not getattr(
                self, "_lanes_logged", False):
            from ..utils.logging_ import get_logger

            self._lanes_logged = True
            get_logger(cfg).info(
                "restart batch on a cluster-sharded mesh: the two-pass "
                "statistics (%s) have no batched form; the %d lanes run "
                "the mesh's own loop one after another",
                self.estep_backend_reason, int(states.N.shape[0]))
        if stats_fn is not None:
            if n_events is not None and self.estep_backend == "cuda":
                stats_fn = functools.partial(
                    stats_fn,
                    n_events=self.local_events(n_events, data_chunks))
        else:
            one = self.stats_fn
            if one is None:
                one = functools.partial(accumulate_stats, cluster_group=group,
                                        **numerics)
            elif n_events is not None and self.estep_backend == "cuda":
                one = functools.partial(
                    one, n_events=self.local_events(n_events, data_chunks))
            stats_fn = lane_loop_stats(one, diag_only=cfg.diag_only)
        reduce = self._reduce

        def batched_stats(s, c, w, lane_mask=None):
            return reduce(stats_fn(s, c, w, lane_mask=lane_mask))

        mstep_fn = self.batched_mstep_fn or lane_loop_mstep(
            self.mstep_fn or functools.partial(
                apply_mstep, diag_only=cfg.diag_only, cluster_group=group,
                covariance_type=cfg.covariance_type))
        inj = self.armed_fault(states, data_chunks, sweep=sweep, batched=True)
        run = em_while_loop_batched(
            states, data_chunks, wts_chunks, epsilon, lo, hi,
            batched_stats_fn=batched_stats, mstep_fn=mstep_fn,
            dynamic_range=cfg.covariance_dynamic_range,
            regression_scale=cfg.health_regression_scale,
            nan_iter=None if inj is None else int(inj["iter"]),
            nan_restart=(None if inj is None or "restart" not in inj
                         else int(inj["restart"])),
            should_stop=should_stop, poll_iters=poll_iters, freeze=freeze,
            resume=resume, cluster_group=group)
        self.last_health, self.last_lls = run.health, run.lls
        self.last_stop = (run.stopped, run.extra)
        return run.state, run.loglik, run.iters

    # -- fleet fits on the mesh (tenancy/; the JAX package's sharded_em.py:
    # 521-604). The port's mesh is one process per rank: every rank runs
    # ``fit_fleet`` on every tenant's whole data, packs the whole group and
    # places only its own data shard of each lane's chunk grid
    # (:meth:`prepare_fleet`). The pad chunks interleave per data shard
    # (tenancy/packing.py), so the leading chunks of rank s's block of a
    # lane are exactly the solo fit's block s. 'scan' runs each lane
    # through this rank's solo EM run on that block (K1/K2 on a data mesh,
    # K5/K6 on a cluster-sharded diag mesh), with the solo fit's per-rank
    # real events, so a sharded fleet tenant is bit-identical to its
    # sharded solo fit; 'vmap' runs the group as one batched loop (K3's
    # per-lane-events form, one all_reduce of the [T, ...] statistics and
    # K4 on a data mesh; the lanes one by one on a cluster-sharded one).
    # Lanes pad to the cluster-axis multiple (``prepare_states_batched``).
    supports_fleet = True
    run_em_fleet = GMMModel.run_em_fleet

    def prepare_fleet(self, data_chunks, wts_chunks):
        """This rank's data shard of every lane of one packed group's [T,
        C, B, D] chunk grid and [T, C, B] weights, on the device (C is a
        multiple of the data axis)."""
        per = int(np.shape(data_chunks)[1]) // self.data_size
        s = slice(self.mesh.data_index * per, (self.mesh.data_index + 1) * per)
        return (self.place(np.asarray(data_chunks)[:, s]),
                self.place(np.asarray(wts_chunks)[:, s]))

    def _fleet_batched_hooks(self, local_events):
        """:meth:`GMMModel._fleet_batched_hooks` on this rank: the lanes'
        statistics summed over the data axis, the M-step the mesh's."""
        cfg = self.config
        group = self.mesh.cluster_group
        stats_fn = self.fleet_stats_fn
        if stats_fn is not None:
            stats_fn = functools.partial(
                stats_fn, max_events=int(local_events.max()),
                n_events=torch.as_tensor(local_events, dtype=torch.int32,
                                         device=self.device))
        else:
            stats_fn = lane_loop_stats(
                self.stats_fn or functools.partial(
                    accumulate_stats, cluster_group=group,
                    diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
                    matmul_precision=cfg.matmul_precision),
                diag_only=cfg.diag_only, per_lane_events=True)
        reduce = self._reduce

        def batched_stats(s, c, w, lane_mask=None):
            return reduce(stats_fn(s, c, w, lane_mask=lane_mask))

        mstep_fn = self.batched_mstep_fn or lane_loop_mstep(
            self.mstep_fn or functools.partial(
                apply_mstep, diag_only=cfg.diag_only, cluster_group=group,
                covariance_type=cfg.covariance_type))
        return batched_stats, mstep_fn, group

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
