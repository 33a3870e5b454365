"""GMM-EM model: the EM loop for a fixed (masked) cluster count.

The reference's EM while-loop (``gaussian.cu:479-755``) with its control
on the device (models/em_program.py): on one CUDA device each EM iteration
is one replay of a CUDA graph captured once per padded width (the JAX
package's one jitted ``lax.while_loop`` per width), elsewhere the same
iteration runs eagerly; the host reads one scalar per iteration to decide
whether to go on. ``GMMModel.run_em`` and ``em_while_loop`` both run it.
``_em_loop``, the host loop of earlier slices that reads the loglik and
the counters every iteration, stays as the reference the device loop is
held to (``GMMModel(_eager_em=True)`` and ``em_while_loop(...,
_eager_em=True)`` run it). Loop
semantics match ``gaussian.cu:525-755``:

  change = 2*epsilon (+1) initially (:525)
  while iters < MIN_ITERS or (|change| > epsilon and iters < MAX_ITERS): (:532)
      params  <- M-step(stats) + constants                  (:541-701)
      stats   <- fused E-step(params); loglik = stats.loglik (:713-741)
      change  = loglik - old_loglik                         (:748)

with ``|change| > epsilon`` spelled ``not (|change| <= epsilon)``, so a
non-finite change reads as not converged.

**Health** (health.py): every iteration computes the counter lanes on the
device -- non-finite loglik/params, a loglik regression beyond
``health_regression_scale * epsilon``, empty clusters, covariance dynamic
range, the E-step's sanitized rows -- and sums them on the device (the
host loop reads them with the loglik, in one transfer per iteration). A
fatal lane stops the loop (the JAX package's ``~fatal`` in its loop
condition); the totals land on the model's ``last_health`` and the loglik
trajectory on ``last_lls``.

**Supervision**: with ``should_stop`` the loop asks the run supervisor
every ``preempt_poll_iters`` iterations, at an armed ``preempt``
iteration and where it ends (the JAX package's segment boundaries, which
here are only checks between iterations), and a resumed run restarts at a
checkpointed iteration with its loglik trajectory.

``em_while_loop_batched`` runs the same loop for a batch of restarts (a
state with a leading restart axis R) with per-lane bounds, masked
freeze-out and per-lane health rows ([R, NUM_FLAGS]): each lane iterates
exactly as its own ``em_while_loop`` would. It stays a host loop (one [R]
read per iteration), uncaptured.

``GMMModel.make_fused_sweep`` builds the whole-sweep program
(models/fused_sweep.py) on the model's EM programs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import health
from ..config import GMMConfig
from ..ops.estep import features, posteriors
from ..ops.mstep import SuffStats, accumulate_stats, apply_mstep, zeros_stats
from ..state import lane, stack_states, where_lanes
from ..testing import faults


def resolve_device(config: GMMConfig) -> torch.device:
    """The torch device of an entry point. There is no silent fallback: a
    CUDA request on a machine without a GPU raises."""
    if config.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' (--device=cpu) to run on the CPU")
    return torch.device(config.device)


def setup_device(config: GMMConfig) -> torch.device:
    """:func:`resolve_device`; on CUDA, TF32 is turned off for the torch-ops
    products (matmul) and any cuDNN call, which then run in full fp32 at
    every ``matmul_precision``: 'high' and 'default' spell their bf16
    passes out themselves (ops/estep.py::kdot), as the kernels do
    (csrc/fused_stats.cu)."""
    device = resolve_device(config)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def resolve_iters_batched(config: GMMConfig, num_restarts: int,
                          min_iters, max_iters):
    """Per-restart iteration bounds as int64 [R] vectors (lo, hi).

    Scalars (or None -> the config's values) broadcast to every restart;
    [R] vectors pass through. lo is clamped to hi. A restart whose
    ``max_iters`` is 0 runs no EM iteration: the batched restart paths' handle
    for freezing a lane.
    """
    lo = config.min_iters if min_iters is None else min_iters
    hi = config.max_iters if max_iters is None else max_iters
    lo = np.broadcast_to(np.asarray(lo, np.int64), (num_restarts,))
    hi = np.broadcast_to(np.asarray(hi, np.int64), (num_restarts,))
    return np.minimum(lo, hi), hi.copy()


def lane_loop_stats(stats_fn: Callable, diag_only: bool = False,
                    per_lane_events: bool = False) -> Callable:
    """A batched stats hook that runs the unbatched ``stats_fn`` lane by
    lane (the torch-ops backend of the batched loop); frozen lanes get zero
    statistics, as K3 gives them. With ``per_lane_events`` lane r reads its
    own events, ``data_chunks[r]`` / ``wts_chunks[r]`` (a fleet group's
    [T, C, B, D] grids)."""
    def batched(states, data_chunks, wts_chunks, lane_mask=None):
        R, K, D = states.means.shape
        live = [True] * R if lane_mask is None else lane_mask.tolist()
        return stack_states([
            stats_fn(lane(states, r),
                     data_chunks[r] if per_lane_events else data_chunks,
                     wts_chunks[r] if per_lane_events else wts_chunks)
            if live[r]
            else zeros_stats(K, D, data_chunks.dtype, data_chunks.device,
                             diag_only=diag_only)
            for r in range(R)])

    return batched


def lane_loop_mstep(mstep_fn: Callable) -> Callable:
    """A batched M-step hook that runs the unbatched ``mstep_fn`` lane by
    lane (the torch-ops backend of the batched loop)."""
    def batched(states, stats):
        return stack_states([mstep_fn(lane(states, r), lane(stats, r))
                             for r in range(states.N.shape[0])])

    return batched


def chunk_events(data: np.ndarray, chunk_size: int, num_shards: int = 1,
                 num_chunks: Optional[int] = None,
                 sample_weight: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and reshape events to [num_chunks, chunk_size, D] plus a [num_chunks,
    chunk_size] weight row (1 for events, 0 for padding). The chunk count is
    padded to a multiple of ``num_shards`` (the data-axis size), so every
    data shard holds the same number of chunks.

    ``sample_weight`` ([n] nonnegative) replaces the 1s of the weight row
    (padding stays 0). Every statistic multiplies the posteriors and the
    log-evidence by this row, so an integer weight w equals replicating the
    event w times."""
    n, d = data.shape
    if sample_weight is not None and np.asarray(sample_weight).shape != (n,):
        raise ValueError(
            f"sample_weight must be [{n}], got "
            f"{np.asarray(sample_weight).shape}")
    if num_chunks is not None:
        total = num_chunks * chunk_size
        if total < n:
            raise ValueError(
                f"num_chunks={num_chunks} x chunk_size={chunk_size} < {n} events")
        if num_chunks % max(num_shards, 1):
            raise ValueError(
                f"num_chunks={num_chunks} not divisible by num_shards={num_shards}")
    else:
        step = chunk_size * num_shards
        total = n + ((-n) % step)
    padded = np.zeros((total, d), dtype=data.dtype)
    padded[:n] = data
    wts = np.zeros((total,), dtype=data.dtype)
    wts[:n] = 1.0 if sample_weight is None else sample_weight
    num_chunks = total // chunk_size
    return (padded.reshape(num_chunks, chunk_size, d),
            wts.reshape(num_chunks, chunk_size))


class GMMModel:
    """EM for a Gaussian mixture with fixed padded K; active clusters masked.

    ``estep_backend``/``estep_backend_reason`` name the statistics path that
    runs ('cuda' = kernels K1/K2, and K3/K4 for restart batches and 'vmap'
    fleet groups; 'torch' = torch ops) and why.

    Multi-tenant fleet fits (tenancy/): ``run_em_fleet`` runs the EM of a
    packed group of tenants, each lane with its own chunk grid, epsilon and
    bounds. 'scan' runs every live lane through the solo loop on its own
    events (K1/K2, one captured program per lane inside
    :meth:`fleet_programs`), so each tenant's bits are its solo fit's;
    'vmap' runs the group as one batched loop (K3's per-lane-events form
    and K4).
    """

    # Bucket widths must be a multiple of this (the cluster-axis size on
    # parallel.ShardedGMMModel).
    bucket_multiple = 1
    # The (data, cluster) mesh of parallel.ShardedGMMModel; None: one device.
    mesh = None
    # The fused sweep's per-K emission (checkpoints, per-K seconds) runs on
    # this model (models/fused_sweep.py).
    supports_fused_emit = True
    # The fleet EM loop (``run_em_fleet``) runs on this model; streaming
    # overrides this off (no single EM program to map tenants over).
    supports_fleet = True

    def __init__(self, config: GMMConfig = GMMConfig(),
                 stats_fn: Optional[Callable] = None,
                 mstep_fn: Optional[Callable] = None, *,
                 _eager_em: bool = False):
        self.config = config
        self.device = setup_device(config)
        # The last EM run's health counters (int64 [NUM_FLAGS], or
        # [R, NUM_FLAGS] after run_em_batched) and loglik trajectory.
        self.last_health = None
        self.last_lls = None
        self._armed_faults = {}
        # The EM programs (models/em_program.py) and fused sweeps built on
        # this model, for the events in ``_programs_data``; on CUDA their
        # graphs share one memory pool. ``fit_gmm`` releases them when its
        # fit ends. ``_eager_em`` (tests and chip_smoke.py) runs the host
        # loop ``_em_loop`` instead.
        self._eager_em = _eager_em
        self._programs: dict = {}
        self._programs_data = None
        self._graph_pool = None
        # Inside fleet_programs(): {event key: (programs, events, weights)},
        # every fleet lane's programs kept side by side.
        self._fleet_programs = None
        # (padded width, seconds) of every EM-program capture on this model.
        self.capture_log: list = []
        if stats_fn is None and mstep_fn is None:
            from ..ops.kernels import (
                make_batched_stats_fn, make_fleet_stats_fn, make_mstep_fn,
                make_stats_fn, resolve_estep_backend,
            )

            self.estep_backend, self.estep_backend_reason = \
                resolve_estep_backend(config)
            stats_fn = make_stats_fn(config)
            mstep_fn = make_mstep_fn(config)
            self.batched_stats_fn = make_batched_stats_fn(config)
            self.batched_mstep_fn = make_mstep_fn(config, batched=True)
            self.fleet_stats_fn = make_fleet_stats_fn(config)
        else:
            self.estep_backend = "custom"
            self.estep_backend_reason = "caller-supplied stats_fn/mstep_fn"
            self.batched_stats_fn = self.batched_mstep_fn = None
            self.fleet_stats_fn = None
        self.stats_fn = stats_fn
        self.mstep_fn = mstep_fn
        diag_only = config.diag_only
        # The batched loop's hooks where no batched kernel serves: the
        # unbatched hooks (or torch ops) lane by lane.
        if self.batched_stats_fn is None:
            self.batched_stats_fn = lane_loop_stats(
                stats_fn or functools.partial(accumulate_stats,
                                              **self.numerics),
                diag_only=diag_only)
        if self.batched_mstep_fn is None:
            self.batched_mstep_fn = lane_loop_mstep(
                mstep_fn or functools.partial(
                    apply_mstep, diag_only=diag_only,
                    covariance_type=config.covariance_type))

    @property
    def numerics(self) -> dict:
        """The torch-ops E-step's switches from the config."""
        cfg = self.config
        return dict(diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
                    matmul_precision=cfg.matmul_precision)

    def place(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a tensor of the model's device and dtype."""
        return torch.as_tensor(np.asarray(array, self.config.dtype),
                               device=self.device)

    def armed_fault(self, state, data_chunks, *, sweep: bool,
                    batched: bool = False):
        """The ``nan_loglik`` plan (testing.faults) armed on the EM
        "executable" this call runs, or None.

        The JAX package consumes the plan when it traces an EM executable
        and compiles it in: one executable per model, call variant (the
        sweep's donating call, ``sweep=True``, or any other call: a
        recovery rung, a library call) and input shapes. The port keeps
        that table per model and arms an entry the first time it runs it,
        so the fault fires on the same runs: every rerun of an armed entry
        fires again, and a rung-rebuilt model (a new table) runs clean. A
        plan with ``restart`` set arms only the batched loop's entries."""
        key = (sweep, batched, tuple(state.means.shape[-2:]),
               tuple(data_chunks.shape), data_chunks.dtype)
        if key not in self._armed_faults:
            plan = faults.peek("nan_loglik")
            if plan is not None and "restart" in plan and not batched:
                plan = None
            else:
                plan = faults.take("nan_loglik")
            self._armed_faults[key] = plan
        return self._armed_faults[key]

    def armed_fleet_fault(self, states, data_chunks, mode: str):
        """The ``nan_loglik`` plan armed on this model's fleet EM of this
        mode and group shape, or None: consumed once per (model, mode, group
        shape), as the JAX package traces one fleet executable per shape,
        and fired on every run of it. A plan with ``restart`` set fires on
        that lane of the group only, else on every lane."""
        key = ("fleet", mode, tuple(states.means.shape),
               tuple(data_chunks.shape), data_chunks.dtype)
        if key not in self._armed_faults:
            self._armed_faults[key] = faults.take("nan_loglik")
        return self._armed_faults[key]

    def run_em(self, state, data_chunks, wts_chunks, epsilon: float,
               min_iters: Optional[int] = None,
               max_iters: Optional[int] = None,
               n_events: Optional[int] = None, *, sweep: bool = False):
        """Full EM at the current active K. Returns (state, loglik, iters);
        the health counters land on ``last_health`` and the loglik
        trajectory (the initial E-step's first) on ``last_lls``.

        ``n_events`` (the real events, in front of the chunk grid's
        zero-weight padding) lets K1 skip the padding rows. ``sweep``
        marks the order search's per-K call (``armed_fault``)."""
        state, ll, iters, _, _, _ = self.run_em_resumable(
            state, data_chunks, wts_chunks, epsilon, min_iters, max_iters,
            n_events=n_events, sweep=sweep)
        return state, ll, iters

    def run_em_resumable(self, state, data_chunks, wts_chunks, epsilon,
                         min_iters: Optional[int] = None,
                         max_iters: Optional[int] = None,
                         n_events: Optional[int] = None, *,
                         sweep: bool = False, poll_iters: int = 25,
                         should_stop: Optional[Callable[[int], bool]] = None,
                         resume: Optional[dict] = None):
        """:meth:`run_em` under a run supervisor: ``should_stop(done)`` is
        asked every ``poll_iters`` iterations, at an armed ``preempt``
        iteration and where the loop ends; ``resume={"em_iter": i,
        "em_lls": [...]}`` restarts at iteration ``i`` from a checkpointed
        mid-EM state. Returns ``(state, loglik, iters, lls, stopped,
        extra)``: ``stopped`` when ``should_stop`` tripped (the state is
        the one to checkpoint), ``extra`` the resume payload then."""
        cfg = self.config
        lo = cfg.min_iters if min_iters is None else min_iters
        hi = cfg.max_iters if max_iters is None else max_iters
        inj = self.armed_fault(state, data_chunks, sweep=sweep)
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
                resume: Optional[dict] = None) -> "EMRun":
        """One EM run at bounds (lo, hi) with ``nan_iter`` as the armed
        fault: the body of :meth:`run_em_resumable` and of a 'scan' fleet
        lane."""
        cfg = self.config
        if self._eager_em:
            run = _em_loop(
                state, data_chunks, wts_chunks, epsilon, lo, hi,
                stats_fn=self._stats_fn(n_events), mstep_fn=self.mstep_fn,
                precompute_features=cfg.precompute_features,
                covariance_type=cfg.covariance_type,
                dynamic_range=cfg.covariance_dynamic_range,
                regression_scale=cfg.health_regression_scale,
                nan_iter=nan_iter, should_stop=should_stop,
                poll_iters=poll_iters, resume=resume, **self.numerics)
        else:
            prog = self.em_program(state, data_chunks, wts_chunks, n_events,
                                   max(lo, hi, cfg.max_iters) + 1)
            run = prog.run(state, epsilon=epsilon, min_iters=lo,
                           max_iters=hi, nan_iter=nan_iter,
                           regression_scale=cfg.health_regression_scale,
                           should_stop=should_stop, poll_iters=poll_iters,
                           resume=resume)
        return run

    def _stats_fn(self, n_events: Optional[int]):
        """The statistics hook, told the real events on the kernel path."""
        if n_events is not None and self.estep_backend == "cuda":
            return functools.partial(self.stats_fn, n_events=n_events)
        return self.stats_fn

    def programs(self, data_chunks, wts_chunks, n_events) -> dict:
        """The cache of EM programs and fused sweeps on these events. A
        program reads its events in place, so a call with other events
        drops the cache (and frees its graphs) first."""
        key = (data_chunks.data_ptr(), wts_chunks.data_ptr(),
               tuple(data_chunks.shape), n_events)
        if self._fleet_programs is not None:
            return self._fleet_programs.setdefault(
                key, ({}, data_chunks, wts_chunks))[0]
        if self._programs_data is None or self._programs_data[0] != key:
            self.release_programs()
            self._programs_data = (key, data_chunks, wts_chunks)
        return self._programs

    def release_programs(self) -> None:
        """Drop the EM programs and fused sweeps (and the recovery rungs'
        models' too): their graphs, their memory pool and their hold on the
        events. The next run builds them again, in a new pool (the
        allocator takes no new capture into a pool whose graphs are
        gone)."""
        self._programs, self._programs_data, self._graph_pool = {}, None, None
        if self._fleet_programs is not None:
            self._fleet_programs = {}
        for m in self.__dict__.get("_recovery_models", {}).values():
            m.release_programs()

    @contextlib.contextmanager
    def fleet_programs(self):
        """Inside the block each event set keeps its EM programs side by
        side (a fleet group's lanes are views of one [T, C, B, D] grid, and
        :meth:`programs` would otherwise drop one lane's graphs for the
        next at every sweep step); on the way out they are released with
        the rest."""
        self.release_programs()
        self._fleet_programs = {}
        try:
            yield
        finally:
            self._fleet_programs = None
            self.release_programs()

    @property
    def captures(self) -> bool:
        """Whether this model's EM programs are CUDA graphs: a single CUDA
        device, unless ``_eager_em``."""
        return self.device.type == "cuda" and not self._eager_em

    def graph_pool(self):
        """The memory pool every CUDA graph of this model shares."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def em_program(self, state, data_chunks, wts_chunks,
                   n_events: Optional[int], length: int):
        """The EM program (models/em_program.py) of this model at the
        state's padded width on these events, built on first use: one
        CUDA-graph capture per width on the card (the JAX package's one
        executable per width), the same loop run eagerly elsewhere.
        ``length`` is its trajectory's slots (at least max_iters + 1)."""
        from .em_program import EMProgram

        cache = self.programs(data_chunks, wts_chunks, n_events)
        key = ("em", state.num_clusters_padded, length)
        prog = cache.get(key)
        if prog is None:
            cfg = self.config
            estep, mstep, count = em_hooks(
                data_chunks, wts_chunks,
                precompute_features=cfg.precompute_features,
                stats_fn=self._stats_fn(n_events), mstep_fn=self.mstep_fn,
                covariance_type=cfg.covariance_type,
                dynamic_range=cfg.covariance_dynamic_range, **self.numerics)
            prog = cache[key] = EMProgram(
                estep, mstep, count, state, length, capture=self.captures,
                pool=self.graph_pool() if self.captures else None)
            if self.captures:
                self.capture_log.append((state.num_clusters_padded,
                                         prog.capture_s))
        return prog

    def graph_pool_bytes(self) -> int:
        """Device memory of this model's CUDA-graph pool (0 without one)."""
        from .em_program import pool_bytes

        return 0 if self._graph_pool is None else pool_bytes(self._graph_pool)

    def make_fused_sweep(self, with_emit: bool = False,
                         emit_light: bool = False, **static):
        """The whole-sweep program (models/fused_sweep.py) as a callable
        ``fused(state, data_chunks, wts_chunks, epsilon, min_iters,
        max_iters, resume=None, emit_cb=None)``; ``static`` holds
        ``start_k``, ``stop_number``, ``target_k``, ``num_events``,
        ``num_dimensions``. With ``with_emit`` each completed K is handed
        to ``emit_cb`` on the host between the sweep's replays: the whole
        payload, or with ``emit_light`` only the step scalars. The program
        is cached per width and ``static`` on the model's events (the JAX
        package's ``cached_fused_sweep``)."""
        from .fused_sweep import fused_sweep

        def fused(state, data_chunks, wts_chunks, epsilon, min_iters,
                  max_iters, resume=None, emit_cb=None):
            return fused_sweep(
                state, data_chunks, wts_chunks, epsilon, min_iters,
                max_iters, resume, model=self,
                emit_cb=emit_cb if with_emit else None,
                emit_light=emit_light, **static)

        return fused

    def run_em_batched(self, states, data_chunks, wts_chunks, epsilon: float,
                       min_iters=None, max_iters=None,
                       n_events: Optional[int] = None, *, sweep: bool = False,
                       poll_iters: int = 25,
                       should_stop: Optional[Callable[[int], bool]] = None,
                       freeze=None, resume: Optional[dict] = None):
        """Full EM for a batch of restarts: ``states`` has a leading restart
        axis R on every leaf. Returns (states, loglik [R], iters [R]), the
        last two as numpy arrays; per-lane health rows [R, NUM_FLAGS] land
        on ``last_health`` and the lanes' loglik trajectories on
        ``last_lls``.

        ``min_iters``/``max_iters`` take scalars or [R] vectors; a lane
        with ``max_iters=0`` (or set in ``freeze``, [R] bool) is frozen: it
        runs no E-step, its state passes through untouched and its loglik
        is NaN. ``n_events`` and ``sweep`` as in :meth:`run_em`;
        ``should_stop``/``poll_iters``/``resume`` as in
        :meth:`run_em_resumable` (the resume payload carries every lane's
        trajectory, ``em_lens``, ``em_frozen`` and ``em_fatal``), with
        ``self.last_stop`` = (stopped, extra) after the call.
        """
        lo, hi = resolve_iters_batched(self.config, states.N.shape[0],
                                       min_iters, max_iters)
        stats_fn = self.batched_stats_fn
        if n_events is not None and self.estep_backend == "cuda":
            stats_fn = functools.partial(stats_fn, n_events=n_events)
        cfg = self.config
        # No unbatched stats_fn: the batched E-step is torch ops lane by lane.
        feats = (hoisted_features(
            data_chunks, precompute_features=cfg.precompute_features,
            diag_only=cfg.diag_only, quad_mode=cfg.quad_mode)
            if self.stats_fn is None else None)
        if feats is not None:
            stats_fn = lane_loop_stats(
                functools.partial(accumulate_stats, feats_chunks=feats,
                                  **self.numerics),
                diag_only=cfg.diag_only)
        inj = self.armed_fault(states, data_chunks, sweep=sweep,
                               batched=True)
        run = em_while_loop_batched(
            states, data_chunks, wts_chunks, epsilon, lo, hi,
            batched_stats_fn=stats_fn, mstep_fn=self.batched_mstep_fn,
            dynamic_range=cfg.covariance_dynamic_range,
            regression_scale=cfg.health_regression_scale,
            nan_iter=None if inj is None else int(inj["iter"]),
            nan_restart=(None if inj is None or "restart" not in inj
                         else int(inj["restart"])),
            should_stop=should_stop, poll_iters=poll_iters, freeze=freeze,
            resume=resume)
        self.last_health, self.last_lls = run.health, run.lls
        self.last_stop = (run.stopped, run.extra)
        return run.state, run.loglik, run.iters

    def prepare_states_batched(self, states):
        """A restart-batched state on the model's device (the mesh's rows
        of it on ``parallel.ShardedGMMModel``)."""
        return states.to(self.device)

    def gather_states_batched(self, states):
        """The whole restart-batched state (a mesh row's clusters gathered
        on ``parallel.ShardedGMMModel``)."""
        return states

    def local_events(self, n_events: int, data_chunks) -> int:
        """The real events in front of this model's block of a grid that
        holds ``n_events``: all of them on one device (a mesh rank's share
        on ``parallel.ShardedGMMModel``)."""
        return n_events

    # -- multi-tenant fleet fits (tenancy/) -------------------------------

    def prepare_fleet(self, data_chunks, wts_chunks):
        """One packed group's [T, C, B, D] chunk grid and [T, C, B] weights
        on the model's device (a mesh rank's data shard of every lane on
        ``parallel.ShardedGMMModel``)."""
        return self.place(data_chunks), self.place(wts_chunks)

    def run_em_fleet(self, states, data_chunks, wts_chunks, epsilons,
                     min_iters=None, max_iters=None, *, n_events,
                     solo_chunks=None, donate: bool = False,
                     mode: str = "scan"):
        """Full EM for a FLEET of independent datasets: the JAX package's
        ``run_em_fleet`` (models/gmm.py:646-745).

        ``states`` carries a leading tenant axis T on every leaf (this
        model's placement: ``prepare_states_batched``); ``data_chunks`` [T,
        C, B, D] / ``wts_chunks`` [T, C, B] hold each tenant's own packed
        chunk grid (:meth:`prepare_fleet`); ``epsilons`` [T] each tenant's
        convergence threshold and ``n_events`` [T] its real events;
        ``solo_chunks`` [T] its solo fit's chunk count (None: the whole
        grid), whose leading chunks of each data shard are the solo fit's
        block of it (tenancy/packing.py). ``min_iters``/``max_iters`` take
        scalars or [T] vectors; a lane whose ``max_iters`` is 0 is frozen:
        its state passes through untouched, its loglik is NaN.

        ``mode='scan'``: every live lane runs this model's solo EM run on
        its own solo block (``run_em``'s body: K1/K2 on the kernel path,
        one captured program per lane inside :meth:`fleet_programs`), so
        each lane's bits are its solo fit's. ``mode='vmap'``: one batched
        loop over the group (``em_while_loop_batched`` with per-lane
        epsilon; on the kernel path one launch of K3's per-lane-events form
        and one K4 launch per iteration), at reduction-order tolerance.
        ``donate`` is accepted for the JAX package's signature: a torch
        tensor has no buffer donation.

        Returns ``(states, loglik [T], iters [T])`` (numpy vectors); the
        int64 [T, NUM_FLAGS] health rows land on ``last_health``. An armed
        ``nan_loglik`` fault (:meth:`armed_fleet_fault`) fires on the lane
        its ``restart`` key names, or on every lane."""
        cfg = self.config
        T = int(states.N.shape[0])
        lo, hi = resolve_iters_batched(cfg, T, min_iters, max_iters)
        eps = np.broadcast_to(np.asarray(epsilons, np.float64), (T,))
        n = np.broadcast_to(np.asarray(n_events, np.int64), (T,))
        S = int(getattr(self, "data_size", 1))
        C, B = int(data_chunks.shape[1]), int(data_chunks.shape[2])
        per_solo = (np.full((T,), C, np.int64) if solo_chunks is None
                    else np.asarray(solo_chunks, np.int64) // S)
        inj = self.armed_fleet_fault(states, data_chunks, mode)
        nan_iter = None if inj is None else int(inj["iter"])
        nan_lane = (None if inj is None or "restart" not in inj
                    else int(inj["restart"]))
        if mode == "vmap":
            local = np.asarray([self.local_events(
                int(n[t]), data_chunks[t, :per_solo[t]]) for t in range(T)],
                np.int64)
            stats_fn, mstep_fn, group = self._fleet_batched_hooks(local)
            run = em_while_loop_batched(
                states, data_chunks, wts_chunks, eps, lo, hi,
                batched_stats_fn=stats_fn, mstep_fn=mstep_fn,
                dynamic_range=cfg.covariance_dynamic_range,
                regression_scale=cfg.health_regression_scale,
                nan_iter=nan_iter, nan_restart=nan_lane, cluster_group=group)
            self.last_health, self.last_lls = run.health, run.lls
            return run.state, run.loglik, run.iters
        if mode != "scan":
            raise ValueError(f"unknown fleet mode {mode!r}")
        out, lls = [], []
        ll = np.full((T,), np.nan)
        iters = np.zeros((T,), np.int64)
        rows = np.zeros((T, health.NUM_FLAGS), np.int64)
        for t in range(T):
            s_t = lane(states, t)
            if hi[t] == 0:
                out.append(s_t)
                lls.append([])
                continue
            c = int(per_solo[t])
            run = self._run_em(
                s_t, data_chunks[t, :c], wts_chunks[t, :c], float(eps[t]),
                int(lo[t]), int(hi[t]), int(n[t]),
                nan_iter if nan_lane in (None, t) else None)
            out.append(run.state)
            ll[t], iters[t], rows[t] = run.loglik, run.iters, run.health
            lls.append(run.lls)
        self.last_health, self.last_lls = rows, lls
        return stack_states(out), ll, iters

    def _fleet_batched_hooks(self, local_events):
        """(batched stats hook, batched M-step hook, cluster group) of a
        'vmap' fleet group whose lanes hold ``local_events`` [T] real
        events: K3's per-lane-events form on the kernel path, else the
        unbatched statistics lane by lane on each lane's own events."""
        stats_fn = self.fleet_stats_fn
        if stats_fn is not None:
            stats_fn = functools.partial(
                stats_fn, max_events=int(local_events.max()),
                n_events=torch.as_tensor(local_events, dtype=torch.int32,
                                         device=self.device))
        else:
            stats_fn = lane_loop_stats(
                self.stats_fn or functools.partial(accumulate_stats,
                                                   **self.numerics),
                diag_only=self.config.diag_only, per_lane_events=True)
        return stats_fn, self.batched_mstep_fn, None

    @property
    def inference_block(self) -> int:
        """Events per output-path step."""
        return self.config.chunk_size

    def infer_posteriors(self, state, xb):
        """(w [B, K], logZ [B]) for one block of events (torch-ops path)."""
        return posteriors(state, torch.as_tensor(xb, device=self.device),
                          **self.numerics)

    def memberships(self, state, data_chunks, return_logz: bool = False):
        """Posteriors [N_padded, K] recomputed from the final parameters
        (the loop ends on an E-step, so these are its memberships). Padded
        tail rows are garbage; callers slice to the true event count. With
        ``return_logz`` also the per-event log evidence [N_padded]."""
        return _memberships(self, state, data_chunks, return_logz)


def _memberships(model, state, data_chunks, return_logz: bool):
    """``memberships`` of a model with ``infer_posteriors``: the chunks'
    posteriors (and log evidence) copied to the host."""
    outs = [model.infer_posteriors(state, data_chunks[i])
            for i in range(data_chunks.shape[0])]
    w = np.concatenate([o[0].cpu().numpy() for o in outs], axis=0)
    if return_logz:
        return w, np.concatenate([o[1].cpu().numpy() for o in outs], axis=0)
    return w


def hoisted_features(data_chunks: torch.Tensor, *, precompute_features: bool,
                     diag_only: bool, quad_mode: str):
    """The [C, B, F] features of ``quad_mode`` for every chunk, when
    ``precompute_features`` applies to the torch-ops E-step (full
    covariance, 'expanded' or 'packed'); else None. Built by the same
    function the inline path calls on each chunk."""
    if (not precompute_features or diag_only
            or quad_mode not in ("expanded", "packed")):
        return None
    return torch.stack([features(c, quad_mode) for c in data_chunks])


@dataclasses.dataclass
class EMRun:
    """One EM run: the final state, its loglik and iteration count (numpy
    [R] arrays for a batch), the health counters (int64 [NUM_FLAGS] or
    [R, NUM_FLAGS]), the loglik trajectory (a list, or one list per lane:
    the initial E-step's loglik, then one per iteration), whether the
    supervisor stopped it, and the resume payload of a stopped run."""

    state: object
    loglik: object
    iters: object
    health: np.ndarray
    lls: list
    stopped: bool = False
    extra: dict = dataclasses.field(default_factory=dict)


def _read(*parts) -> list:
    """The device->host read of one EM iteration: scalars and counter
    vectors concatenated into one tensor, fetched in one transfer."""
    return torch.cat([p.reshape(-1).to(parts[0].dtype)
                      for p in parts]).tolist()


def _preempt_iter() -> Optional[int]:
    """The EM iteration an armed ``preempt`` plan stops at (the supervisor
    consumes it at that poll), or None."""
    inj = faults.peek("preempt")
    if inj is not None and "iter" in inj and int(inj.get("block", -1)) == -1:
        return int(inj["iter"])
    return None


def em_while_loop(state, data_chunks, wts_chunks, epsilon: float,
                  min_iters: int, max_iters: int, **kw):
    """The per-K EM algorithm. Returns (state, loglik, iters);
    :func:`em_program_run` takes the keyword arguments and returns the
    whole :class:`EMRun` (health counters and trajectory too)."""
    run = em_program_run(state, data_chunks, wts_chunks, epsilon, min_iters,
                         max_iters, **kw)
    return run.state, run.loglik, run.iters


def em_program_run(state, data_chunks, wts_chunks, epsilon: float,
                   min_iters: int, max_iters: int, *,
                   regression_scale: float = 10.0,
                   nan_iter: Optional[int] = None,
                   should_stop: Optional[Callable[[int], bool]] = None,
                   poll_iters: int = 25, resume: Optional[dict] = None,
                   _eager_em: bool = False, **hooks) -> EMRun:
    """One EM run as an :class:`~.em_program.EMProgram` on these events
    (``hooks`` are :func:`em_hooks`' arguments, the rest
    :func:`_em_loop`'s): captured as CUDA graphs on a single CUDA device,
    run eagerly on the CPU and on a mesh (``reduce_stats`` or
    ``cluster_group`` set: its collectives go through the host every
    iteration). ``_eager_em`` runs the host loop :func:`_em_loop`, the
    reference the program is held to, instead."""
    from .em_program import EMProgram

    loop = dict(regression_scale=regression_scale, nan_iter=nan_iter,
                should_stop=should_stop, poll_iters=poll_iters,
                resume=resume)
    if _eager_em:
        return _em_loop(state, data_chunks, wts_chunks, epsilon, min_iters,
                        max_iters, **loop, **hooks)
    capture = (data_chunks.device.type == "cuda"
               and hooks.get("reduce_stats") is None
               and hooks.get("cluster_group") is None)
    prog = EMProgram(*em_hooks(data_chunks, wts_chunks, **hooks), state,
                     max(min_iters, max_iters) + 1, capture=capture,
                     pool=torch.cuda.graph_pool_handle() if capture else None)
    return prog.run(state, epsilon=epsilon, min_iters=min_iters,
                    max_iters=max_iters, **loop)


def em_hooks(data_chunks, wts_chunks, *, diag_only: bool = False,
             quad_mode: str = "expanded", matmul_precision: str = "highest",
             precompute_features: bool = False,
             stats_fn: Optional[Callable] = None,
             mstep_fn: Optional[Callable] = None,
             reduce_stats: Optional[Callable] = None, cluster_group=None,
             covariance_type: Optional[str] = None,
             dynamic_range: float = 1e3):
    """The three functions of one EM iteration on these events: ``estep(
    state) -> SuffStats`` (``stats_fn``, or the torch-ops pass with the
    hoisted features of ``precompute_features``; then ``reduce_stats``),
    ``mstep(state, stats) -> state`` (``mstep_fn``, or ``apply_mstep``) and
    ``count(state, stats, ll, ll_prev=None, tol=None)``, the health
    counters. The arguments are :func:`_em_loop`'s."""
    feats = None
    if stats_fn is None:
        feats = hoisted_features(
            data_chunks, precompute_features=precompute_features,
            diag_only=diag_only, quad_mode=quad_mode)

    def estep(s) -> SuffStats:
        if stats_fn is not None:
            stats = stats_fn(s, data_chunks, wts_chunks)
        else:
            stats = accumulate_stats(s, data_chunks, wts_chunks,
                                     diag_only=diag_only, quad_mode=quad_mode,
                                     matmul_precision=matmul_precision,
                                     cluster_group=cluster_group,
                                     feats_chunks=feats)
        return reduce_stats(stats) if reduce_stats is not None else stats

    def mstep(s, stats):
        if mstep_fn is not None:
            return mstep_fn(s, stats)
        return apply_mstep(s, stats, diag_only=diag_only,
                           cluster_group=cluster_group,
                           covariance_type=covariance_type)

    count = functools.partial(health.iteration_counts,
                              dynamic_range=dynamic_range,
                              cluster_group=cluster_group)
    return estep, mstep, count


def _em_loop(state, data_chunks, wts_chunks, epsilon: float,
             min_iters: int, max_iters: int, *, diag_only: bool = False,
             quad_mode: str = "expanded",
             matmul_precision: str = "highest",
             precompute_features: bool = False,
             stats_fn: Optional[Callable] = None,
             mstep_fn: Optional[Callable] = None,
             reduce_stats: Optional[Callable] = None,
             cluster_group=None,
             covariance_type: Optional[str] = None,
             dynamic_range: float = 1e3, regression_scale: float = 10.0,
             nan_iter: Optional[int] = None,
             should_stop: Optional[Callable[[int], bool]] = None,
             poll_iters: int = 25, resume: Optional[dict] = None) -> EMRun:
    """The per-K EM loop with its health counters (see the module
    docstring).

    ``stats_fn(state, data_chunks, wts_chunks) -> SuffStats`` replaces the
    torch-ops statistics pass (K1 rides this hook); ``mstep_fn(state,
    stats) -> state`` replaces ``apply_mstep`` (K2 + constants).
    ``reduce_stats(stats) -> SuffStats`` is applied to every E-step's
    statistics before the loglik is read (the data-axis all_reduce of a
    mesh, parallel/sharded_em.py); ``cluster_group`` is the process group
    of a sharded cluster axis, handed to the torch-ops E- and M-step and
    to the health counts. ``quad_mode`` and ``matmul_precision`` are the
    torch-ops E-step's switches; ``precompute_features`` hoists its
    [C, B, F] features out of the loop (built once here, when no
    ``stats_fn`` is bound, for full covariance in 'expanded'/'packed'
    mode, as the JAX package's loop does). ``covariance_type`` is the
    torch-ops M-step's family (None: 'diag' or 'full' from
    ``diag_only``). The loglik and the change are computed in the data's
    dtype, as on the device in the reference, and read to the host with
    the counters once per iteration (and once after the initial E-step).

    ``dynamic_range``/``regression_scale`` parametrize the counters;
    ``nan_iter`` is an armed ``nan_loglik`` fault (the loglik of that
    iteration becomes NaN); ``should_stop``/``poll_iters``/``resume`` as
    in :meth:`GMMModel.run_em_resumable`.
    """
    estep, mstep, count = em_hooks(
        data_chunks, wts_chunks, diag_only=diag_only, quad_mode=quad_mode,
        matmul_precision=matmul_precision,
        precompute_features=precompute_features, stats_fn=stats_fn,
        mstep_fn=mstep_fn, reduce_stats=reduce_stats,
        cluster_group=cluster_group, covariance_type=covariance_type,
        dynamic_range=dynamic_range)
    eps_t = torch.tensor(epsilon, dtype=data_chunks.dtype)
    eps = float(eps_t)
    reg_tol = (regression_scale * eps_t).to(data_chunks.device)
    stats = estep(state)  # initial E-step (gaussian.cu:487-516)
    ll = stats.loglik
    vals = _read(ll, count(state, stats, ll))
    totals = np.rint(vals[1:]).astype(np.int64)
    lls = [vals[0]]
    change = 2.0 * eps + 1.0  # :525
    iters = 0
    if resume:
        iters = int(resume.get("em_iter", 0))
        lls = [float(x) for x in np.asarray(resume.get("em_lls", ()),
                                            np.float64).reshape(-1)] or lls
        if len(lls) >= 2:
            change = float(torch.tensor(lls[-1], dtype=data_chunks.dtype)
                           - torch.tensor(lls[-2], dtype=data_chunks.dtype))

    def more() -> bool:
        return iters < min_iters or (not abs(change) <= eps
                                     and iters < max_iters)

    fatal = bool(health.fatal_rows(totals))
    stopped = False
    preempt = _preempt_iter() if should_stop is not None else None
    seg0 = iters
    if should_stop is not None and not fatal and not more() and not resume:
        stopped = should_stop(iters)
    while not (fatal or stopped) and more():
        state = mstep(state, stats)  # :541-701
        stats = estep(state)  # :713-741
        ll_new = stats.loglik
        if nan_iter is not None and iters + 1 == nan_iter:
            ll_new = torch.full_like(ll_new, torch.nan)
        vals = _read(ll_new, ll_new - ll,  # :748
                     count(state, stats, ll_new, ll, reg_tol))
        counts = np.rint(vals[2:]).astype(np.int64)
        ll, change = ll_new, vals[1]
        lls.append(vals[0])
        totals += counts
        iters += 1
        fatal = bool(health.fatal_rows(counts))
        if should_stop is not None and not fatal and (
                not more() or iters == preempt
                or iters - seg0 >= poll_iters):
            seg0 = iters
            stopped = should_stop(iters)
    extra = {"em_lls": np.asarray(lls, np.float64)} if stopped else {}
    return EMRun(state, lls[-1], iters, totals, lls, stopped, extra)


def em_while_loop_batched(states, data_chunks, wts_chunks, epsilon,
                          min_iters_r, max_iters_r, *,
                          batched_stats_fn: Callable, mstep_fn: Callable,
                          dynamic_range: float = 1e3,
                          regression_scale: float = 10.0,
                          nan_iter: Optional[int] = None,
                          nan_restart: Optional[int] = None,
                          should_stop: Optional[Callable[[int], bool]] = None,
                          poll_iters: int = 25, freeze=None,
                          resume: Optional[dict] = None,
                          cluster_group=None) -> EMRun:
    """EM for a batch of restarts as one host loop over the whole batch,
    returning the :class:`EMRun` (states, loglik [R] and iters [R] as
    numpy arrays, [R, NUM_FLAGS] health rows): the port of the JAX
    package's ``em_while_loop_batched`` (models/gmm.py:1006-1144). Each
    iteration runs the M-step on every lane (one K4 launch on the kernel
    path), then the E-step with the lanes still live as ``lane_mask`` (one
    K3 launch), and freezes every other lane's carry (state, statistics, loglik,
    change, iterations, health) with a per-lane ``where``. A lane is live
    while it is not fatal and ``iters < lo | (~(|change| <= eps) & iters <
    hi)``, the per-lane spelling of :func:`_em_loop`'s test, so each lane
    runs the iterations its own loop would. The [R] loglik and change and
    the [R, NUM_FLAGS] counters are read to the host once per iteration.
    A lane whose ``max_iters`` is 0, or set in ``freeze``, never runs: the
    initial E-step masks it too, its loglik is NaN and its counters stay
    0. ``epsilon`` is one threshold for every lane or [R] of them (a fleet
    group's tenants: each lane tests its own, rounded to the data's dtype
    lane by lane as the scalar is). ``nan_iter``/``nan_restart`` is an
    armed ``nan_loglik`` fault (on lane ``nan_restart`` only, when set);
    ``should_stop``, ``poll_iters`` and ``resume`` as in
    :meth:`GMMModel.run_em_batched`. On a mesh the
    hooks reduce the statistics over the data axis themselves, and
    ``cluster_group`` (a sharded cluster axis) sums the state's counters
    over the ranks of a mesh row.
    """
    lo = np.asarray(min_iters_r, np.int64)
    hi = np.asarray(max_iters_r, np.int64)
    R = lo.shape[0]
    dev = data_chunks.device
    dt = data_chunks.dtype
    eps_t = torch.tensor(np.broadcast_to(np.asarray(epsilon, np.float64),
                                         (R,)), dtype=dt)
    eps = eps_t.to(torch.float64).numpy()
    reg_tol = (regression_scale * eps_t).to(dev)
    frozen = (np.zeros((R,), bool) if freeze is None
              else np.asarray(freeze, bool).copy())
    fatal = np.zeros((R,), bool)
    done = 0
    iters = np.zeros((R,), np.int64)
    change = 2.0 * eps + 1.0  # gaussian.cu:525
    lls = [[] for _ in range(R)]
    if resume:
        done = int(resume.get("em_iter", 0))
        rows = np.asarray(resume.get("em_lls", np.zeros((R, 0))),
                          np.float64).reshape(R, -1)
        lens = np.asarray(resume.get("em_lens", [rows.shape[1]] * R),
                          np.int64)
        lls = [[float(x) for x in rows[r][:int(lens[r])]] for r in range(R)]
        frozen |= np.asarray(resume.get("em_frozen", frozen), bool)
        fatal |= np.asarray(resume.get("em_fatal", fatal), bool)
        for r in range(R):
            iters[r] = max(len(lls[r]) - 1, 0)
            if len(lls[r]) >= 2:
                change[r] = float(torch.tensor(lls[r][-1], dtype=dt)
                                  - torch.tensor(lls[r][-2], dtype=dt))
    frozen |= fatal
    runs_np = (hi > 0) & ~frozen
    runs = torch.as_tensor(runs_np, device=dev)
    stats = batched_stats_fn(states, data_chunks, wts_chunks,
                             lane_mask=runs)  # gaussian.cu:487-516
    ll = torch.where(runs, stats.loglik, torch.nan)
    c0 = health.iteration_counts(states, stats, ll,
                                 dynamic_range=dynamic_range,
                                 cluster_group=cluster_group)
    vals = np.asarray(_read(ll, torch.where(runs[:, None], c0, 0.0)))
    totals = np.rint(vals[R:].reshape(R, health.NUM_FLAGS)).astype(np.int64)
    for r in np.flatnonzero(runs_np):
        if not lls[r]:
            lls[r].append(float(vals[r]))
    fatal |= health.fatal_rows(totals) & runs_np
    rid = torch.arange(R, device=dev)

    def live_lanes():
        return ~fatal & ~frozen & (
            (iters < lo) | (~(np.abs(change) <= eps) & (iters < hi)))

    stopped = False
    preempt = _preempt_iter() if should_stop is not None else None
    seg0 = done
    if (should_stop is not None and not live_lanes().any() and not resume
            and not fatal.any()):
        stopped = should_stop(done)
    while not stopped:
        live = live_lanes()
        if not live.any():
            break
        live_t = torch.as_tensor(live, device=dev)
        new_states = mstep_fn(states, stats)  # :541-701
        new_stats = batched_stats_fn(new_states, data_chunks, wts_chunks,
                                     lane_mask=live_t)  # :713-741
        ll_new = new_stats.loglik
        if nan_iter is not None:
            hit = torch.as_tensor(iters + 1 == nan_iter, device=dev)
            if nan_restart is not None:
                hit = hit & (rid == nan_restart)
            ll_new = torch.where(hit, torch.nan, ll_new)
        counts = health.iteration_counts(new_states, new_stats, ll_new, ll,
                                         reg_tol,
                                         dynamic_range=dynamic_range,
                                         cluster_group=cluster_group)
        vals = np.asarray(_read(ll_new, ll_new - ll, counts))  # :748
        counts = np.rint(vals[2 * R:].reshape(R, health.NUM_FLAGS)).astype(
            np.int64)
        states = where_lanes(live_t, new_states, states)
        stats = where_lanes(live_t, new_stats, stats)
        ll = torch.where(live_t, ll_new, ll)
        change = np.where(live, vals[R:2 * R], change)
        iters = iters + live
        totals[live] += counts[live]
        for r in np.flatnonzero(live):
            lls[r].append(float(vals[r]))
        fatal |= live & health.fatal_rows(counts)
        done += 1
        if should_stop is not None and not (live & fatal).all() and (
                not live_lanes().any() or done == preempt
                or done - seg0 >= poll_iters):
            seg0 = done
            stopped = should_stop(done)
    extra = {}
    if stopped:
        L = max((len(l) for l in lls), default=0)
        em_lls = np.full((R, max(L, 1)), np.nan, np.float64)
        for r in range(R):
            em_lls[r, :len(lls[r])] = lls[r]
        extra = {
            "em_iter": np.int64(done),
            "em_lls": em_lls,
            "em_lens": np.asarray([len(l) for l in lls], np.int64),
            "em_frozen": (frozen | ~live_lanes()).astype(np.int8),
            "em_fatal": fatal.astype(np.int8),
        }
    ll_out = np.asarray([l[-1] if l else np.nan for l in lls], np.float64)
    return EMRun(states, ll_out, iters, totals, lls, stopped, extra)
