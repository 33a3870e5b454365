"""Fleet fits: many independent GMMs, group by group.

The port of the JAX package's ``tenancy/fleet.py``: T independent datasets
-- per-tenant N_t / K_t / seed, shared D and covariance family -- pack into
pow2 (event-bucket, cluster-bucket) groups (``tenancy/packing.py``) and
each group runs its whole model-order sweep with one fleet EM call per
step (``GMMModel.run_em_fleet``: per-tenant data, weights, epsilon and
iteration bounds ride a leading tenant axis).

Contracts (tests/test_torch_tenancy.py):

- **solo parity** -- in the default ``fleet_mode='scan'`` every tenant's
  fitted model is BIT-IDENTICAL to a solo ``fit_gmm`` of that tenant at the
  same seed and config with ``sweep_k_buckets='off'`` (the fleet sweep is
  fixed-width), on one device and on a mesh, full and diag covariance: the
  per-tenant host recipe is the solo code path itself, the packing pad is
  inert, and each lane runs the solo EM run on its own events (K1/K2 on
  the card, one captured program per lane). ``fleet_mode='vmap'`` runs a
  group as one batched loop (K3's per-lane-events form and K4 on the card)
  at reduction-order tolerance.
- **per-tenant freeze-out** -- a tenant that converges (or finishes its
  sweep) freezes (``max_iters=0`` lanes pass through untouched) while its
  groupmates keep iterating.
- **drop-one containment** -- per-tenant health ROWS ([T, NUM_FLAGS]): a
  tenant whose EM goes fatal is DROPPED from the group (``recovery``
  action ``drop_tenant``) and its survivors' results are untouched;
  ``recovery='off'`` raises instead, naming the tenants.
- **preempt/resume** -- with a checkpoint dir, every completed sweep step
  is durable per group (``checkpoint_dir/group<i>/``); a stop between
  steps exits 75 and ``resume='auto'`` continues bit-identically.

Telemetry: ``fleet_start`` / per-tenant ``tenant_done`` / a closing
``fleet_summary``, rendered by ``gmm report`` ("Fleet" section); with
``metrics_port`` the live plane and the ``fleet`` > ``fleet_group`` spans.

The port's mesh is one process per rank: every rank runs ``fit_fleet`` on
every tenant's whole data (as the port's mesh ``fit_gmm`` does) and holds
its data shard of each lane (``ShardedGMMModel.prepare_fleet``). A lost
peer ends the fit (exit 75 in the CLI; the group checkpoints resume it),
unless ``elastic`` is set: then, under one ``ElasticRecovery`` budget for
the whole fleet, the world shrinks over the survivors, the model and its
mesh are built anew over them, and the group in flight refits from its own
``group<i>`` checkpoint, packed again for the new data axis. Groups that
finished are not refitted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import health, supervisor, telemetry
from ..config import GMMConfig
from ..ops.formulas import model_score
from ..ops.merge import eliminate_and_reduce_batched
from ..state import clone_state, compact, lane, stack_states, where_lanes
from ..telemetry import exporter as tl_exporter
from ..telemetry import spans as tl_spans
from ..utils.logging_ import get_logger
from .packing import TenantSpec, pack_group, plan_fleet


@dataclasses.dataclass
class TenantResult:
    """One tenant's outcome: a fitted model, or why it was dropped."""

    name: str
    index: int        # position in the fleet's tenant list
    group: int        # packed-group index
    result: Optional[object] = None   # GMMResult; None when dropped
    error: Optional[str] = None       # the drop diagnosis

    @property
    def dropped(self) -> bool:
        return self.result is None


@dataclasses.dataclass
class FleetResult:
    """All tenants' outcomes plus the fleet-level accounting."""

    tenants: List[TenantResult]
    groups: List[dict]    # per-group {tenants, n_bucket, k_bucket, ...}
    mode: str
    wall_s: float

    def __getitem__(self, name: str) -> TenantResult:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def dropped(self) -> List[TenantResult]:
        return [t for t in self.tenants if t.dropped]

    @property
    def fitted(self) -> List[TenantResult]:
        return [t for t in self.tenants if not t.dropped]


def _reject_unsupported(config: GMMConfig) -> None:
    """Loud rejection of config combinations a fleet fit cannot
    honor -- silently ignoring a requested mode would fit tenants under
    different semantics than the flag promised. The JAX package also
    refuses its Pallas kernels here (they batch restarts over SHARED event
    tiles); the port's config already refuses ``estep_backend='pallas'``,
    and its counterpart ``'cuda'`` is honoured: 'scan' lanes run K1/K2 and
    'vmap' groups K3's per-lane-events form, which reads each lane's own
    events."""
    why = None
    if config.stream_events:
        why = "stream_events has no single EM program to map tenants over"
    elif config.fused_sweep:
        why = "fused_sweep runs one whole-sweep program per dataset"
    elif config.n_init > 1:
        why = "n_init restarts nest a second batch axis (fit tenants solo)"
    elif config.precompute_features:
        why = "precompute_features would hold [T, C, B, F] features"
    elif config.recovery_reseed_empty:
        why = "recovery_reseed_empty is a solo target-K refinement pass"
    if why is not None:
        raise ValueError(f"fit_fleet cannot honor this config: {why}")


def fit_fleet(tenants: List[TenantSpec], config: GMMConfig = GMMConfig(),
              model=None, verbose: Optional[bool] = None) -> FleetResult:
    """Fit every tenant's mixture -- the fleet library entry point.

    Mirrors ``fit_gmm``'s ambient-subsystem contract: ``metrics_file``
    activates a run-scoped telemetry recorder (an already-active ambient
    recorder is reused), ``max_runtime_s`` a signal-free deadline
    supervisor, ``metrics_port`` the live plane; a preemption surfaces as
    :class:`~cuda_gmm_mpi_tpu_torch.supervisor.PreemptedError` for the
    CLI's exit-75 contract. With ``autotune`` other than 'off' the
    ``fleet_mode`` comes from the tuning database
    (``tuning.resolve_fleet_config_ex``). Runs on ``config.device``
    ('cuda' by default).
    """
    _reject_unsupported(config)
    with contextlib.ExitStack() as stack:
        if config.metrics_file and not telemetry.current().active:
            rec = telemetry.RunRecorder(config.metrics_file)
            stack.enter_context(telemetry.use(rec))
            stack.enter_context(rec)
        if config.max_runtime_s is not None \
                and not supervisor.current().active:
            stack.enter_context(supervisor.use(supervisor.RunSupervisor(
                max_runtime_s=config.max_runtime_s,
                install_signals=False)))
        if config.metrics_port is not None:
            # The live plane and a fleet-rooted span trace; entirely gated,
            # so metrics_port=None keeps streams byte-identical.
            from ..parallel import elastic

            stack.enter_context(tl_exporter.live_plane(
                config.metrics_port,
                registry_provider=lambda: telemetry.current().metrics,
                gauges_provider=elastic.live_gauges, device=config.device))
            rec = telemetry.current()
            tid = stack.enter_context(tl_spans.trace())
            if rec.active:
                rec.set_context(trace_id=tid)
                stack.callback(rec.set_context, trace_id=None)
            stack.enter_context(tl_spans.span("fleet"))
        if config.autotune != "off" and tenants:
            # fleet_mode from the nearest recorded profile at the fleet's
            # LARGEST packed shape (db/static only -- a fleet fit never
            # burns tenant wall probing); `tune` events ride the stream.
            from ..tuning import resolve_fleet_config_ex

            config, _ = resolve_fleet_config_ex(
                config,
                max(int(np.shape(t.data)[0]) for t in tenants),
                int(np.shape(tenants[0].data)[1]),
                max(int(t.num_clusters) for t in tenants),
                log=get_logger(config))
        return _fit_fleet(tenants, config, model, verbose)


def _fit_fleet(tenants, config, model, verbose) -> FleetResult:
    from ..models.order_search import _platform

    log = get_logger(config)
    rec = telemetry.current()
    verbose = config.enable_print if verbose is None else verbose
    t_start = time.perf_counter()

    model = model or _fleet_model(config)
    if not getattr(model, "supports_fleet", False):
        raise ValueError(f"{type(model).__name__} has no fleet EM loop")

    data_axis = int(getattr(model, "data_size", 1))
    groups = plan_fleet(tenants, config, data_axis=data_axis,
                        cluster_axis=int(getattr(model, "cluster_size", 1)))
    mode = config.fleet_mode
    d = int(np.shape(tenants[0].data)[1])
    log.info("fleet fit: %d tenants in %d packed group(s), mode=%s",
             len(tenants), len(groups), mode)
    if rec.active:
        rec.set_context(path="fleet")
        rec.emit(
            "fleet_start",
            tenants=len(tenants), groups=len(groups), mode=mode,
            platform=_platform(model),
            num_dimensions=d, dtype=config.dtype,
            covariance_type=config.covariance_type,
            criterion=config.criterion,
            chunk_size=int(config.chunk_size),
            group_shapes=[{"tenants": len(g.indices),
                           "n_bucket": int(g.n_bucket),
                           "k_bucket": int(g.k_bucket)}
                          for g in groups],
        )

    out: List[Optional[TenantResult]] = [None] * len(tenants)
    group_meta: List[dict] = []
    # One elastic-recovery budget spans the whole fleet fit: a peer loss
    # during any group shrinks the world once and every later group fits
    # over the survivors too (membership generations only move forward).
    recovery = None
    for gi, group in enumerate(groups):
        ckpt = None
        if config.checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpointer

            ckpt = SweepCheckpointer(
                os.path.join(config.checkpoint_dir, f"group{gi}"),
                keep=config.checkpoint_keep,
                retries=config.checkpoint_retries,
                allow_world_change=config.elastic)
        t0 = time.perf_counter()
        # Non-lexical span (a preempt raises through _run_group; an
        # un-ended span simply never emits -- see telemetry/spans.py).
        g_span = tl_spans.begin("fleet_group", group=gi,
                                tenants=len(group.indices))
        while True:
            # The chunk count a multiple of the data axis (an elastic
            # shrink may leave another axis than the plan's).
            num_chunks = -(-group.num_chunks // data_axis) * data_axis
            group = dataclasses.replace(
                group, num_chunks=num_chunks,
                n_bucket=num_chunks * int(config.chunk_size))
            packed = pack_group(group, tenants, config, data_axis=data_axis,
                                device=model.device)
            # A 'scan' lane keeps its captured programs for the whole group.
            hold = getattr(model, "fleet_programs", contextlib.nullcontext)
            try:
                with hold():
                    results = _run_group(model, config, packed, ckpt, rec,
                                         log, verbose, mode, gi)
                break
            except supervisor.PreemptedError:
                raise
            except RuntimeError as e:
                # The JAX package's per-group elastic continue: shrink, then
                # refit THIS group from its own checkpoint directory.
                lost = (e if isinstance(e, supervisor.PeerLostError)
                        else supervisor.current().peer_loss_from(e))
                if lost is None:
                    raise
                if recovery is None:
                    recovery = supervisor.ElasticRecovery.maybe(config)
                if recovery is None:
                    if lost is e:
                        raise
                    raise lost from e
                config = recovery.recover(lost, config)
                if recovery.rebuilt:
                    # The process group changed: a model (and mesh) over the
                    # survivors (the old one's programs went with ``hold``).
                    model = _fleet_model(config)
                    data_axis = int(getattr(model, "data_size", 1))
        tl_spans.end(g_span)
        group_meta.append({
            "tenants": len(group.indices),
            "n_bucket": int(group.n_bucket),
            "k_bucket": int(group.k_bucket),
            "num_chunks": int(group.num_chunks),
            "seconds": round(time.perf_counter() - t0, 6),
        })
        for lane_i, i in enumerate(group.indices):
            tr = results[lane_i]
            out[i] = tr
            if rec.active:
                fields: Dict[str, object] = dict(
                    tenant=tr.name, dropped=tr.dropped, group=gi,
                    num_events=int(packed.n_events[lane_i]))
                if tr.dropped:
                    fields["error"] = tr.error
                else:
                    r = tr.result
                    fields.update(
                        k=int(r.ideal_num_clusters),
                        score=_json_float(r.min_rissanen),
                        loglik=_json_float(r.final_loglik),
                        iters=int(sum(row[3] for row in r.sweep_log)),
                        criterion=config.criterion)
                rec.emit("tenant_done", **fields)
                rec.metrics.count("tenants_dropped" if tr.dropped
                                  else "tenants_fitted")
            if verbose:
                if tr.dropped:
                    print(f"tenant {tr.name}: DROPPED ({tr.error})")
                else:
                    print(f"tenant {tr.name}: "
                          f"{config.criterion}="
                          f"{tr.result.min_rissanen:.6e} "
                          f"K={tr.result.ideal_num_clusters}")

    wall = time.perf_counter() - t_start
    fleet = FleetResult(tenants=[t for t in out if t is not None],
                        groups=group_meta, mode=mode,
                        wall_s=round(wall, 6))
    if rec.active:
        rec.emit("fleet_summary",
                 tenants=len(fleet.tenants),
                 dropped=len(fleet.dropped),
                 groups=len(groups), mode=mode,
                 wall_s=round(wall, 6),
                 metrics=rec.metrics.snapshot())
        rec.set_context(path=None)
    return fleet


def _fleet_model(config):
    """The model a fleet fit builds: one rank of ``config.mesh_shape``'s
    mesh, or one device."""
    if config.mesh_shape is not None:
        from ..parallel import ShardedGMMModel

        return ShardedGMMModel(config)
    from ..models.gmm import GMMModel

    return GMMModel(config)


def _json_float(x) -> Optional[float]:
    x = float(x)
    return x if math.isfinite(x) else None


def _pad_merges(merges) -> np.ndarray:
    """[T, S, 4] NaN-padded per-tenant merge rows (k_active, c1, c2,
    distance) of a checkpoint payload."""
    S = max((len(m) for m in merges), default=0)
    out = np.full((len(merges), max(S, 1), 4), np.nan, np.float64)
    for t, rows in enumerate(merges):
        for i, (k, pair, dist) in enumerate(rows):
            out[t, i] = (k, pair[0], pair[1], dist)
    return out


def _run_group(model, config, packed, ckpt, rec, log, verbose, mode,
               group_index) -> List[TenantResult]:
    """One packed group through the whole per-tenant model-order sweep.

    The fleet mirror of the batched-restart sweep (``restarts._run_batch``)
    with per-LANE datasets: every lane carries its own k trajectory,
    epsilon, event count and stop target; one fleet EM call and one
    order-reduction pass per step serve every live lane.
    """
    from ..models.order_search import (
        _COV_CODE, _CRITERION_CODE, GMMResult, _resume_mismatch,
        _shutdown_and_raise, compute_envelope,
    )
    from ..models.restarts import _batched_host, _pad_sweep_logs

    sup = supervisor.current()
    T = len(packed.names)
    d = packed.chunks.shape[-1]
    dev = model.device
    mesh = getattr(model, "mesh", None)
    per_solo = packed.solo_chunks // packed.data_axis

    # ``states`` is the model's placement (on a cluster-sharded mesh this
    # rank's clusters of every lane); scoring, the best states, the merge
    # scan and the checkpoints use the gathered states.
    states = model.prepare_states_batched(stack_states(packed.states))
    chunks_d, wts_d = model.prepare_fleet(packed.chunks, packed.wts)
    if rec.active:
        rec.metrics.count("h2d_bytes", int(packed.chunks.nbytes)
                          + int(packed.wts.nbytes))

    K0 = packed.k0.copy()
    k_r = packed.k0.copy()
    stop_r = np.where(packed.targets > 0, packed.targets, 1)
    alive = np.ones((T,), bool)
    dropped = np.zeros((T,), bool)
    drop_error: List[Optional[str]] = [None] * T
    min_riss_r = np.full((T,), np.inf)
    ideal_k_r = k_r.copy()
    best_ll_r = np.full((T,), -np.inf)
    sweep_logs: List[list] = [[] for _ in range(T)]
    merges: List[list] = [[] for _ in range(T)]
    health_lane = np.zeros((T, health.NUM_FLAGS), np.int64)
    best_states = clone_state(stack_states(packed.states))

    step = 0
    if ckpt is not None and config.resume != "never":
        restored = ckpt.restore()
        if restored is not None and (
                "fleet" not in restored
                or int(restored["state"].N.shape[0]) != T
                or not np.array_equal(np.asarray(restored["k0"],
                                                 np.int64), K0)
                or not np.array_equal(
                    np.asarray(restored["n_events"], np.int64),
                    packed.n_events)
                or _resume_mismatch(restored, config, log)):
            restored = None
        if restored is not None:
            states = model.prepare_states_batched(restored["state"])
            best_states = restored["best_state"].to(dev)
            k_r = np.asarray(restored["k"], np.int64).copy()
            alive = np.asarray(restored["alive"], bool).copy()
            dropped = np.asarray(restored["dropped"], bool).copy()
            min_riss_r = np.asarray(restored["min_rissanen"],
                                    np.float64).copy()
            ideal_k_r = np.asarray(restored["ideal_k"], np.int64).copy()
            best_ll_r = np.asarray(restored["best_ll"], np.float64).copy()
            lens = np.asarray(restored["sweep_len"], np.int64)
            rows_log = np.asarray(restored["sweep_log"], np.float64)
            sweep_logs = [
                [(int(row[0]), float(row[1]), float(row[2]), int(row[3]),
                  float(row[4])) for row in rows_log[t][:int(lens[t])]]
                for t in range(T)
            ]
            health_lane = np.asarray(restored["health_lane"],
                                     np.int64).copy()
            mlens = np.asarray(restored["merge_len"], np.int64)
            mrows = np.asarray(restored["merge_log"], np.float64)
            merges = [[(int(m[0]), (int(m[1]), int(m[2])), float(m[3]))
                       for m in mrows[t][:int(mlens[t])]] for t in range(T)]
            step = int(np.asarray(restored["step"])) + 1
            log.info("resumed fleet group %d from checkpoint: step %d",
                     group_index, step)
            if rec.active:
                rec.metrics.count("resumes")

    def host_payload():
        return {
            "state": _batched_host(model.gather_states_batched(states)),
            "best_state": _batched_host(best_states),
            "min_rissanen": np.asarray(min_riss_r, np.float64),
            "ideal_k": np.asarray(ideal_k_r, np.int64),
            "best_ll": np.asarray(best_ll_r, np.float64),
            "k": np.asarray(k_r, np.int64),
            "alive": alive.astype(np.int64),
            "dropped": dropped.astype(np.int64),
            "k0": K0,
            "targets": packed.targets,
            "n_events": packed.n_events,
            "fleet": 1,
            "num_clusters": int(packed.group.k_bucket),
            "criterion_code": _CRITERION_CODE[config.criterion],
            "cov_code": _COV_CODE[config.covariance_type],
            "health_lane": health_lane,
            "sweep_log": _pad_sweep_logs(sweep_logs),
            "sweep_len": np.asarray([len(l) for l in sweep_logs],
                                    np.int64),
            "merge_log": _pad_merges(merges),
            "merge_len": np.asarray([len(m) for m in merges], np.int64),
        }

    while alive.any():
        k_top = int(k_r[alive].max())
        if sup.active and sup.poll_world(where="fleet", k=k_top,
                                         em_iter=step):
            _shutdown_and_raise(sup, rec, log, ckpt,
                                step=step - 1 if step else None, k=k_top,
                                checkpointed=ckpt is not None and step > 0)
        t0 = time.perf_counter()
        live = alive.copy()
        lo_t = np.where(live, min(config.min_iters, config.max_iters), 0)
        hi_t = np.where(live, config.max_iters, 0)
        states, ll_np, iters_np = model.run_em_fleet(
            states, chunks_d, wts_d, packed.epsilons, min_iters=lo_t,
            max_iters=hi_t, n_events=packed.n_events,
            solo_chunks=packed.solo_chunks, donate=True, mode=mode)
        counts = np.asarray(model.last_health, np.int64).reshape(
            T, health.NUM_FLAGS)
        full = model.gather_states_batched(states)
        dt = time.perf_counter() - t0

        # --- per-tenant fault containment (drop-one) ---------------------
        fatal_t = health.fatal_rows(counts) & live
        if fatal_t.any():
            if config.recovery == "off":
                bad = [packed.names[t] for t in np.flatnonzero(fatal_t)]
                total = counts[fatal_t].sum(axis=0)
                raise health.NumericalFaultError(
                    f"numerical fault in tenant(s) {', '.join(bad)} at "
                    f"K={k_top} and recovery is 'off'",
                    health.fault_bundle(total, k=k_top, where="fleet",
                                        config=config))
            for t in np.flatnonzero(fatal_t):
                health_lane[t] += counts[t]
                word = health.pack_word(counts[t])
                names = health.flag_names(word)
                drop_error[t] = (
                    f"fatal numerical fault at K={int(k_r[t])} "
                    f"(flags={names})")
                log.warning(
                    "tenant %s hit a fatal numerical fault at K=%d; "
                    "dropped from the fleet (survivors continue)",
                    packed.names[t], int(k_r[t]))
                if rec.active:
                    rec.set_context(tenant=packed.names[t])
                    rec.emit("health", k=int(k_r[t]), where="fleet",
                             flags=int(word), flag_names=names,
                             counters=health.counts_dict(counts[t]))
                    rec.emit("recovery", k=int(k_r[t]), attempt=1,
                             action="drop_tenant", outcome="dropped",
                             flags=int(word), flag_names=names)
                    rec.metrics.count("tenant_drops")
                    rec.set_context(tenant=None)
            alive &= ~fatal_t
            dropped |= fatal_t
            live &= ~fatal_t

        # --- scoring + best-model save per live lane ---------------------
        improved = np.zeros((T,), bool)
        for t in np.flatnonzero(live):
            health_lane[t] += counts[t]
            word = health.pack_word(counts[t])
            ll_f = float(ll_np[t])
            k = int(k_r[t])
            riss = model_score(ll_f, k, int(packed.n_events[t]), d,
                               criterion=config.criterion,
                               covariance_type=config.covariance_type)
            score_ok = math.isfinite(riss)
            if not score_ok:
                health_lane[t, health.NONFINITE_SCORE] += 1
                log.warning("non-finite %s score at K=%d (tenant %s); "
                            "excluded from best-model selection",
                            config.criterion, k, packed.names[t])
            sweep_logs[t].append((k, ll_f, riss, int(iters_np[t]), dt))
            if rec.active and word:
                rec.set_context(tenant=packed.names[t])
                rec.emit("health", k=k, where="fleet", flags=int(word),
                         flag_names=health.flag_names(word),
                         counters=health.counts_dict(counts[t]))
                rec.metrics.count("health_events")
                rec.set_context(tenant=None)
            if rec.active:
                rec.metrics.count("em_iters", int(iters_np[t]))
            if verbose:
                print(f"tenant {packed.names[t]} K={k}: "
                      f"loglik={ll_f:.6e} {config.criterion}={riss:.6e} "
                      f"iters={int(iters_np[t])} ({dt:.2f}s)")
            if score_ok and (
                k == K0[t]
                or (riss < min_riss_r[t] and packed.targets[t] == 0)
                or k == packed.targets[t]
            ):  # gaussian.cu:839, per lane, NaN-score-guarded
                improved[t] = True
                min_riss_r[t] = riss
                ideal_k_r[t] = k
                best_ll_r[t] = ll_f
        if improved.any():
            best_states = where_lanes(torch.as_tensor(improved, device=dev),
                                      full, best_states)
        if rec.active:
            rec.heartbeat("fleet", k=k_top)

        # --- sweep advance per lane --------------------------------------
        finished = live & (k_r <= stop_r)
        alive &= ~finished
        live &= ~finished
        if not alive.any():
            break
        # The solo fit's eliminate_and_reduce on each live lane, in both
        # modes (the batched restart path's form).
        next_states, k_active, min_d, pairs = eliminate_and_reduce_batched(
            full, live, diag_only=config.diag_only)
        merge_mask = np.zeros((T,), bool)
        for t in np.flatnonzero(live):
            k_new = int(k_active[t])
            if k_new < 2:
                alive[t] = False
                continue
            if not math.isfinite(float(min_d[t])):
                log.warning("no valid merge pair at K=%d (tenant %s); "
                            "stopping that tenant's sweep", k_new,
                            packed.names[t])
                alive[t] = False
                continue
            if rec.active:
                rec.set_context(tenant=packed.names[t])
                rec.emit("merge", k_active=k_new, next_k=k_new - 1,
                         min_distance=float(min_d[t]),
                         pair=[int(pairs[t][0]), int(pairs[t][1])])
                rec.metrics.count("merges")
                rec.set_context(tenant=None)
            if mesh is not None:
                model.assert_same_merge(k_new, pairs[t])
            merge_mask[t] = True
            merges[t].append((k_new, pairs[t], float(min_d[t])))
            k_r[t] = k_new - 1
            if k_r[t] < stop_r[t]:
                alive[t] = False
        if merge_mask.any():
            states = model.prepare_states_batched(where_lanes(
                torch.as_tensor(merge_mask, device=dev), next_states, full))

        if ckpt is not None and alive.any():
            if rec.active:
                rec.metrics.count("checkpoint_saves")
            ckpt.save(step, host_payload())
        step += 1

    # --- per-tenant results -------------------------------------------------
    results: List[TenantResult] = []
    for t in range(T):
        if dropped[t]:
            results.append(TenantResult(
                name=packed.names[t], index=packed.group.indices[t],
                group=group_index, result=None,
                error=drop_error[t] or "dropped"))
            continue
        compact_state, n_active = compact(lane(best_states, t))
        # The tenant's training drift envelope: its own solo block of the
        # packed rows through its winning parameters.
        envelope = None
        if config.envelope:
            envelope = compute_envelope(
                model, compact_state, chunks_d[t, :int(per_solo[t])],
                int(packed.n_events[t]), int(n_active))
        results.append(TenantResult(
            name=packed.names[t], index=packed.group.indices[t],
            group=group_index,
            result=GMMResult(
                state=compact_state.to("cpu"),
                ideal_num_clusters=int(n_active),
                min_rissanen=float(min_riss_r[t]),
                final_loglik=float(best_ll_r[t]),
                epsilon=float(packed.epsilons[t]),
                num_events=int(packed.n_events[t]),
                num_dimensions=d,
                # In the compute dtype, as the solo fit keeps its shift.
                data_shift=packed.shifts[t].astype(np.dtype(config.dtype)),
                sweep_log=sweep_logs[t],
                merges=merges[t],
                model=model,
                host_range=(0, int(packed.n_events[t])),
                health=health.health_summary(
                    health_lane[t],
                    io_retries=(ckpt.io_retries if ckpt is not None
                                else 0)),
                envelope=envelope,
            )))
    return results
