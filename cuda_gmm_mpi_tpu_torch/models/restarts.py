"""Batched restarts: the ``n_init`` restarts of one fit in batches, each
batch one EM loop over a leading restart axis.

The port of the JAX package's ``models/restarts.py``. The restarts are
independent fits of the same device-resident data, so a batch of them
shares every launch:

- seeding: each init's seed rows come from ``order_search._seed_rows`` with
  the sequential path's recipe (init 0 the caller's ``init_means`` or
  ``seed_method``, init i >= 1 k-means++ at ``seed + i``), and
  ``seed_states_batched`` stacks the states; the events' weight row (the
  fit's ``sample_weight``) is shared by every lane;
- EM: ``GMMModel.run_em_batched`` -- on the kernel path one K3 launch and
  one K4 launch per iteration for the whole batch, with per-lane freeze-out
  so each lane iterates as its own fit would ('spherical' and 'tied' run
  K3 and the torch-ops M-step lane by lane: K4 takes full and diag);
- order reduction: ``eliminate_and_reduce_batched`` (one host read per
  lane per sweep step), merged lanes selected with ``where_lanes``.

- health: per-lane counter rows ([R, NUM_FLAGS]). A lane that goes fatal
  is DROPPED from the batch and its siblings keep their results (they are
  never rolled back for it); only when every live lane of a step is fatal
  does the batch roll back and climb the recovery ladder
  (``_recover_batched``), the JAX package's containment contract;
- checkpoints: with ``checkpoint_dir`` each batch checkpoints under
  ``<dir>/batch<b0>`` after every sweep step, and under a run supervisor a
  stop mid-EM writes every lane's trajectory into one emergency sub-step;
  ``resume='auto'`` restores it;
- telemetry: one ``run_start`` and one ``run_summary`` per init, each
  init-tagged, the per-lane ``em_iter``/``em_done``/``merge``/``health``/
  ``recovery`` records, and one ``restart_select`` naming the winner and
  the dropped inits.

The batched sweep is FIXED-WIDTH (no pow2 rebucketing): lanes reach
different active counts at the same step, and one batched state serves
them all. At the main path's K = 100 -> 96 the sequential path keeps
width 100 as well; at small K it rebuckets, so the two agree to rounding
there, not to the bit. ``restart_batch_size=1`` keeps the sequential
path, which picks the same winner at the same seeds.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import health, supervisor, telemetry
from ..ops.formulas import convergence_epsilon, model_score
from ..ops.merge import eliminate_and_reduce_batched
from ..ops.seeding import seed_states_batched
from ..state import (
    GMMState, clone_state, compact, lane, stack_states, where_lanes,
)
from ..testing import faults
from ..utils.logging_ import get_logger


def _host_memory_bytes() -> Optional[int]:
    """Total host memory via sysconf; None when the platform hides it."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, ValueError, OSError):
        return None
    if pages <= 0 or page <= 0:
        return None
    return int(pages) * int(page)


def restart_batch_auto_cap(config, n_events: int, n_dims: int,
                           num_clusters: int, device=None) -> int:
    """Largest restart batch the memory budgets admit.

    Host term (the JAX package's): per restart, one torch-ops chunk pass's
    [B, K] posteriors and [B, F] features plus a few [K, D, D] buffers, 3x
    for temporaries, against 1/4 of host memory (GMM_RESTART_MEM_BYTES
    overrides the budget). Device term, on the kernel path: per lane, K3's
    [G, K_pad, T+D+1] partial buffer and, three times over (the carry, the
    new values, the selected copy), the [K, F] statistics and the state,
    against 1/4 of the card's free memory.
    """
    from ..ops.kernels import resolve_estep_backend

    env = os.environ.get("GMM_RESTART_MEM_BYTES")
    if env not in (None, ""):
        budget = int(env)
    else:
        host = _host_memory_bytes()
        budget = host // 4 if host else 2 << 30
    itemsize = np.dtype(config.dtype).itemsize
    B = max(1, min(int(config.chunk_size), int(n_events)))
    K, D = int(num_clusters), int(n_dims)
    per_restart = itemsize * (B * (K + D * D + D) * 3 + K * D * D * 4)
    cap = max(1, int(budget // max(per_restart, 1)))
    if resolve_estep_backend(config)[0] == "cuda":
        from ..ops.kernels.fused_stats import K1_GRID, stats_tile

        diag = config.diag_only
        F = D if diag else D * D
        T = D if diag else D * (D + 1) // 2
        k_pad = stats_tile(K, D, diag, config.matmul_precision,
                           config.pallas_block_b).k_pad
        partial = 4 * K1_GRID * k_pad * (T + D + 1) + 8 * K1_GRID
        stats = itemsize * K * (F + D + 1)
        state = itemsize * K * (2 * D * D + D + 4) + K
        per_lane = partial + 3 * (stats + state)
        free = torch.cuda.mem_get_info(device)[0]
        cap = min(cap, max(1, (free // 4) // per_lane))
    return cap


def resolve_restart_batch_size(config, data, num_clusters: int,
                               device=None) -> int:
    """The restart batch size this fit will run: 1 (the sequential path)
    for a single init, a streaming fit (its host-driven block loop is no
    single EM program a restart axis can batch, JAX restarts.py:144) or a
    fused sweep (each init runs the whole-sweep program), else
    ``config.restart_batch_size`` or, when that is None, the memory cap;
    clamped to [1, n_init]."""
    if config.n_init <= 1:
        return 1
    why = ("stream_events has no single EM program to batch"
           if config.stream_events else
           "fused_sweep runs the whole-sweep device program per init"
           if config.fused_sweep else None)
    if why is not None:
        # The inits run one after another.
        if (config.restart_batch_size or 1) > 1:
            from ..utils.logging_ import get_logger

            get_logger(config).info(
                "batched restarts disabled (%s); running the %d inits "
                "sequentially", why, config.n_init)
        return 1
    requested = config.restart_batch_size
    if requested is None:
        n_events, n_dims = getattr(data, "shape", None) or np.shape(data)
        requested = restart_batch_auto_cap(config, int(n_events), int(n_dims),
                                           int(num_clusters), device=device)
    return max(1, min(int(requested), config.n_init))


def _json_scores(scores) -> list:
    """JSON-safe score list (non-finite -> None) for restart_select."""
    return [float(x) if x is not None and math.isfinite(float(x)) else None
            for x in scores]


def _recover_batched(model, config, rollback, chunks, wts, epsilon, k_r,
                     live, *, n_events, rec, log, faulty_counts,
                     batch_indices):
    """Climb the escalation ladder for a WHOLE-batch fatal EM step (the
    JAX package's ``_recover_batched``): every live lane's rollback state
    is repaired and the batch retries on the rung's model. The first rung
    with ANY clean live lane wins; still-fatal lanes go back for the drop
    path. Returns ``(model, states, ll, iters, counts, lls, clean_live)``;
    raises :class:`health.NumericalFaultError` when recovery is off or the
    ladder is exhausted."""
    R = int(live.shape[0])
    total = np.asarray(faulty_counts, np.int64)[live].sum(axis=0)
    k_top = int(np.max(np.asarray(k_r)[live]))
    if config.recovery != "retry":
        raise health.NumericalFaultError(
            f"numerical fault in every live restart of the batch at "
            f"K={k_top} (flags={health.flag_names(health.pack_word(total))})"
            f" and recovery is {config.recovery!r}",
            health.fault_bundle(total, k=k_top, where="batched_restarts",
                                config=config))
    ladder = health.escalation_ladder(config)
    attempts = []
    group = (model.mesh.cluster_group
             if getattr(model, "mesh", None) is not None else None)
    for attempt, rung in enumerate(ladder, start=1):
        m2, cfg2 = health.rung_model(model, config, rung)
        boost = float(config.recovery_boost) ** attempt
        states2 = stack_states([
            health.repair_state(lane(rollback, r), diag_only=cfg2.diag_only,
                                boost=boost, cluster_group=group)
            if live[r] else lane(rollback, r) for r in range(R)])
        lo_r = np.where(live, min(config.min_iters, config.max_iters), 0)
        hi_r = np.where(live, config.max_iters, 0)
        states2, ll_np, iters_np = m2.run_em_batched(
            states2, chunks, wts, epsilon, min_iters=lo_r, max_iters=hi_r,
            n_events=n_events)
        counts = m2.last_health
        clean = ~health.fatal_rows(counts)
        clean_live = live & clean
        record = {"attempt": attempt, "action": rung["action"],
                  "boost": boost, "clean": int(clean_live.sum()),
                  "live": int(live.sum())}
        attempts.append(record)
        log.warning("batched recovery attempt %d (%s): %d/%d restarts clean "
                    "[estep backend %s: %s]", attempt, rung["action"],
                    record["clean"], record["live"], m2.estep_backend,
                    m2.estep_backend_reason)
        if rec.active:
            for r in np.flatnonzero(live):
                word_r = health.pack_word(counts[r])
                rec.set_context(init=int(batch_indices[r]))
                rec.emit("recovery", k=int(k_r[r]), attempt=attempt,
                         action=rung["action"],
                         outcome="recovered" if clean[r] else "fatal",
                         flags=int(word_r),
                         flag_names=health.flag_names(word_r))
                rec.metrics.count("recovery_attempts")
            rec.set_context(init=None)
            if clean_live.any():
                rec.metrics.count("recoveries")
        if clean_live.any():
            return (m2, states2, ll_np, iters_np, counts, m2.last_lls,
                    clean_live)
    raise health.NumericalFaultError(
        f"numerical fault in every restart of the batch at K={k_top} not "
        f"recovered after {len(ladder)} escalation attempt(s)",
        health.fault_bundle(total, k=k_top, where="batched_restarts",
                            attempts=attempts, config=config))


def fit_restarts_batched(prepared, num_clusters: int,
                         target_num_clusters: int, config, model,
                         verbose: bool, batch_size: int, init_means=None):
    """``n_init`` restarts in batches of ``batch_size``, one batched sweep
    each, on ``prepared`` (``order_search._prepare_data``'s result), init 0
    seeded from ``init_means`` when given; returns the GMMResult of the
    winner, the same init the sequential path picks at the same seeds
    (``init_index``). Its ``timings`` sum the host-clock seconds of the
    batches' seeding, EM and merge scans; its ``health`` the batches'
    counters, recoveries and dropped restarts; its ``envelope`` the
    winner's (no ``profile``: the per-init run_summary records carry an
    empty phase profile, as the JAX package's do)."""
    from .order_search import (
        GMMResult, _emit_run_start, _emit_run_summary, _host_bounds,
        compute_envelope,
    )

    log = get_logger(config)
    rec = telemetry.current()
    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    data, chunks, wts, n_events, n_dims, shift, var_mean = prepared
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462
    mesh = getattr(model, "mesh", None)
    if rec.active:
        rec.set_context(path="sharded" if mesh is not None else "in-memory",
                        mesh=list(mesh.shape) if mesh is not None else None)
    winner = None
    timings = dict.fromkeys(("seed", "em", "merge"), 0.0)
    all_scores = [None] * config.n_init
    dropped_inits = []
    health_totals = np.zeros((health.NUM_FLAGS,), np.int64)
    n_recoveries = n_drops = io_retries = 0
    for b0 in range(0, config.n_init, batch_size):
        idxs = list(range(b0, min(b0 + batch_size, config.n_init)))
        if rec.active:
            # One run_start (and below one run_summary) PER INIT, each
            # init-tagged, as the sequential path writes them.
            for g in idxs:
                rec.set_context(init=g)
                if g:
                    rec.metrics.count("restarts")
                _emit_run_start(rec, model, config, n_events, n_dims,
                                num_clusters, target_num_clusters, epsilon,
                                restart_batch_size=int(batch_size))
            rec.set_context(init=None)
        ckpt = None
        if config.checkpoint_dir:
            from ..utils.checkpoint import SweepCheckpointer

            ckpt = SweepCheckpointer(
                os.path.join(config.checkpoint_dir, f"batch{b0}"),
                keep=config.checkpoint_keep,
                retries=config.checkpoint_retries,
                allow_world_change=config.elastic)
        out = _run_batch(model, config, data, num_clusters, stop_number,
                         target_num_clusters, chunks, wts, n_events, n_dims,
                         shift, var_mean, epsilon, idxs, verbose,
                         init_means, rec, log, ckpt)
        model = out["model"]  # sticky escalation spans batches
        for part, secs in out["timings"].items():
            timings[part] += secs
        health_totals += out["health_lane"].sum(axis=0)
        n_recoveries += out["recoveries"]
        n_drops += int(out["dropped"].sum())
        if ckpt is not None:
            io_retries += ckpt.io_retries
        for j, g in enumerate(idxs):
            all_scores[g] = float(out["min_riss"][j])
            if out["dropped"][j]:
                dropped_inits.append(int(g))
            if rec.active:
                rec.set_context(init=g)
                logs = out["sweep_logs"][j]
                _emit_run_summary(
                    rec, model, config, None, logs, int(out["n_active"][j]),
                    float(out["min_riss"][j]), float(out["best_ll"][j]),
                    [row[4] for row in logs],
                    buckets=dict(mode="off", em_widths=[out["width"]],
                                 em_compiles=1, rebuckets=0),
                    health_section=health.health_summary(
                        out["health_lane"][j],
                        recoveries=out["recoveries"],
                        restart_drops=int(out["dropped"][j])))
                rec.set_context(init=None)
            if verbose:
                print(f"init {g}: {config.criterion}="
                      f"{out['min_riss'][j]:.6e} K={out['n_active'][j]}")
        # The sequential first-best rule across batches: within a batch
        # _run_batch already picked first-best, so comparing batch winners
        # in batch order is the same rule.
        w = out["winner"]
        if (winner is None or math.isnan(winner["min_riss"])
                or w["min_riss"] < winner["min_riss"]):
            winner = w
    if rec.active:
        rec.emit("restart_select", winner=int(winner["init"]),
                 scores=_json_scores(all_scores),
                 criterion=config.criterion, mode="batched",
                 batch_size=int(batch_size), dropped=dropped_inits)
    if verbose:
        print(f"best of {config.n_init} inits: "
              f"{config.criterion}={winner['min_riss']:.6e} "
              f"K={winner['n_active']}")
    # The training envelope of the winning init's parameters.
    envelope = (compute_envelope(model, winner["state"], chunks, n_events,
                                 winner["n_active"])
                if config.envelope else None)
    return GMMResult(
        state=winner["state"], ideal_num_clusters=winner["n_active"],
        min_rissanen=float(winner["min_riss"]),
        final_loglik=float(winner["best_ll"]), epsilon=epsilon,
        num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=winner["sweep_log"],
        merges=winner["merges"], model=model, init_index=winner["init"],
        timings=timings,
        host_range=_host_bounds(n_events, config.chunk_size, model)[:2],
        health=health.health_summary(health_totals, recoveries=n_recoveries,
                                     io_retries=io_retries,
                                     restart_drops=n_drops),
        envelope=envelope)


def _pad_sweep_logs(sweep_logs) -> np.ndarray:
    """[R, S, 5] NaN-padded per-restart sweep rows (checkpoint payload)."""
    R = len(sweep_logs)
    S = max((len(l) for l in sweep_logs), default=0)
    out = np.full((R, max(S, 1), 5), np.nan, np.float64)
    for r, rows in enumerate(sweep_logs):
        for i, row in enumerate(rows):
            out[r, i, :] = np.asarray(row, np.float64)
    return out


def _batched_host(states) -> GMMState:
    """A restart-batched state on the CPU (checkpoint payloads)."""
    if states.N.device.type == "cuda":
        torch.cuda.synchronize(states.N.device)
    return states.to("cpu")


def _run_batch(model, config, data, num_clusters, stop_number,
               target_num_clusters, chunks, wts, n_events, n_dims, shift,
               var_mean, epsilon, batch_indices, verbose,
               init_means, rec, log, ckpt) -> dict:
    """One batch of restarts through the whole fixed-width sweep.

    A ragged tail batch runs at its own width: PyTorch compiles nothing per
    batch shape, so padding it to the full batch would only add work. A
    lane whose sweep has ended -- or that was dropped for a fatal fault --
    is frozen: EM skips it (``max_iters`` 0) and so does the merge scan.
    """
    from .order_search import (
        _COV_CODE, _CRITERION_CODE, _emit_em_iters, _emit_health,
        _emit_score_health, _resume_mismatch, _seed_rows,
        _shutdown_and_raise,
    )

    sup = supervisor.current()
    R = len(batch_indices)
    dtype = np.dtype(config.dtype)
    dev = model.device
    mesh = getattr(model, "mesh", None)
    t0 = time.perf_counter()
    rows = np.stack([
        np.asarray(_seed_rows(
            data, num_clusters, n_events,
            seed_method=config.seed_method if g == 0 else "kmeans++",
            seed=config.seed + g,
            init_means=init_means if g == 0 else None), dtype)
        for g in batch_indices]) - np.asarray(shift, dtype)[None, None, :]
    states = seed_states_batched(
        rows, n_events, var_mean, num_clusters,
        covariance_dynamic_range=config.covariance_dynamic_range,
        dtype=dtype, device=dev)
    pois = faults.take("singular_cov")
    if pois is not None:
        # Lane 0 of the batch, as the sequential path poisons its first fit.
        c = int(pois.get("cluster", 0))
        R_, Rinv = states.R.clone(), states.Rinv.clone()
        R_[0, c] = 0.0
        Rinv[0, c] = float("inf")
        states = states.replace(R=R_, Rinv=Rinv)
    width = int(states.N.shape[-1])
    # ``states`` is the model's placement (on a mesh: this rank's clusters
    # of every lane); scoring, the best states, the merge scan and the
    # checkpoints use the whole states (``full``).
    best_states = clone_state(states)
    states = model.prepare_states_batched(states)
    timings = {"seed": time.perf_counter() - t0, "em": 0.0, "merge": 0.0}

    k_r = np.full((R,), num_clusters, np.int64)
    alive = np.ones((R,), bool)
    dropped = np.zeros((R,), bool)
    min_riss_r = np.full((R,), np.inf)
    ideal_k_r = np.full((R,), num_clusters, np.int64)
    best_ll_r = np.full((R,), -np.inf)
    sweep_logs = [[] for _ in range(R)]
    merges = [[] for _ in range(R)]
    health_lane = np.zeros((R, health.NUM_FLAGS), np.int64)
    n_recoveries = 0
    recovery_on = config.recovery == "retry"
    supervised = sup.active and ckpt is not None

    step = 0
    resume_em = None
    resume_sub_step = None
    if ckpt is not None and config.resume != "never":
        def usable(tree):
            return tree is not None and not (
                "batched" not in tree
                or int(np.asarray(tree["num_clusters"])) != num_clusters
                or int(tree["state"].N.shape[0]) != R
                or _resume_mismatch(tree, config, log))

        restored = ckpt.restore_substep()
        if not usable(restored):
            restored = ckpt.restore()
            if not usable(restored):
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
            sweep_logs = [[tuple(row) for row in rows_log[r][:int(lens[r])]]
                          for r in range(R)]
            if "em_iter" in restored:
                step = resume_sub_step = int(np.asarray(restored["step"]))
                resume_em = {key: np.asarray(restored[key]) for key in (
                    "em_iter", "em_lls", "em_lens", "em_frozen", "em_fatal")}
                log.info("resuming INSIDE the interrupted batched fit: EM "
                         "iteration %d (sub-step %d)",
                         int(resume_em["em_iter"]), step)
            else:
                step = int(np.asarray(restored["step"])) + 1
                log.info("resumed batched restart sweep from checkpoint: "
                         "step %d", step)
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
            "num_clusters": int(num_clusters),
            "criterion_code": _CRITERION_CODE[config.criterion],
            "cov_code": _COV_CODE[config.covariance_type],
            "batched": 1,
            "batch_indices": np.asarray(batch_indices, np.int64),
            "sweep_log": _pad_sweep_logs(sweep_logs),
            "sweep_len": np.asarray([len(l) for l in sweep_logs], np.int64),
        }

    while alive.any():
        k_top = int(k_r[alive].max())
        if sup.active and sup.poll_world(where="sweep", k=k_top):
            _shutdown_and_raise(sup, rec, log, ckpt,
                                step=step - 1 if step else None, k=k_top,
                                checkpointed=ckpt is not None and step > 0)
        t0 = time.perf_counter()
        live = alive.copy()
        lo_r = np.where(live, min(config.min_iters, config.max_iters), 0)
        hi_r = np.where(live, config.max_iters, 0)
        rollback = clone_state(states) if recovery_on else None
        if supervised or resume_em is not None:
            states, ll_np, iters_np = model.run_em_batched(
                states, chunks, wts, epsilon, min_iters=lo_r,
                max_iters=hi_r, n_events=n_events, sweep=True,
                poll_iters=config.preempt_poll_iters,
                should_stop=((lambda done, _k=k_top: sup.poll_world(
                    where="em", k=_k, em_iter=done))
                    if sup.active else None),
                freeze=~live, resume=resume_em)
            resume_em = None
            stopped, extra = model.last_stop
            if stopped:
                payload = None
                if sup.lost_peer is None or mesh is None \
                        or mesh.cluster_group is None:
                    # (A lost peer's clusters cannot be gathered: the
                    # completed steps stay durable.)
                    payload = host_payload()
                    payload.update(extra)
                _shutdown_and_raise(
                    sup, rec, log, ckpt, step=step, k=k_top,
                    em_iter=int(extra.get("em_iter", 0)), payload=payload)
            if resume_sub_step is not None and ckpt is not None:
                ckpt.discard_substeps(resume_sub_step)
                resume_sub_step = None
        else:
            states, ll_np, iters_np = model.run_em_batched(
                states, chunks, wts, epsilon, min_iters=lo_r,
                max_iters=hi_r, n_events=n_events, sweep=True)
        counts = model.last_health
        lls = model.last_lls
        dt = time.perf_counter() - t0  # EM only, as in fit_gmm's sweep_log
        timings["em"] += dt

        # --- per-restart fault containment
        fatal_r = health.fatal_rows(counts) & live
        if fatal_r.any():
            for r in np.flatnonzero(fatal_r):
                health_lane[r] += counts[r]
                if rec.active:
                    rec.set_context(init=int(batch_indices[r]))
                    _emit_health(rec, k_r[r], counts[r])
                    rec.set_context(init=None)
            if not (live & ~fatal_r).any():
                # EVERY live restart fatal: only now does the ladder run
                # (rolling the whole batch back).
                (model, states, ll_np, iters_np, counts, lls,
                 clean_live) = _recover_batched(
                    model, config, rollback, chunks, wts, epsilon, k_r,
                    live, n_events=n_events, rec=rec, log=log,
                    faulty_counts=counts, batch_indices=batch_indices)
                n_recoveries += 1
                still_fatal = live & ~clean_live
                live = clean_live
                alive &= ~still_fatal
                dropped |= still_fatal
                dt = time.perf_counter() - t0
            else:
                # Drop-one-keep-survivors: the poisoned lanes leave the
                # batch; their siblings' results of this step stand.
                for r in np.flatnonzero(fatal_r):
                    log.warning(
                        "restart %d hit a fatal numerical fault at K=%d; "
                        "dropped from the batch (survivors continue)",
                        int(batch_indices[r]), int(k_r[r]))
                    if rec.active:
                        word = health.pack_word(counts[r])
                        rec.set_context(init=int(batch_indices[r]))
                        rec.emit("recovery", k=int(k_r[r]), attempt=1,
                                 action="drop_restart", outcome="dropped",
                                 flags=int(word),
                                 flag_names=health.flag_names(word))
                        rec.metrics.count("restart_drops")
                        rec.set_context(init=None)
                alive &= ~fatal_r
                dropped |= fatal_r
                live &= ~fatal_r
        del rollback

        # --- scoring + best-model save per live lane
        improved = np.zeros((R,), bool)
        for r in np.flatnonzero(live):
            g = int(batch_indices[r])
            health_lane[r] += counts[r]
            ll_f = float(ll_np[r])
            k = int(k_r[r])
            riss = model_score(ll_f, k, n_events, n_dims,
                               criterion=config.criterion,
                               covariance_type=config.covariance_type)
            score_ok = math.isfinite(riss)
            if not score_ok:
                health_lane[r, health.NONFINITE_SCORE] += 1
                log.warning("non-finite %s score at K=%d (init %d); "
                            "excluded from best-model selection",
                            config.criterion, k, g)
            sweep_logs[r].append((k, ll_f, riss, int(iters_np[r]), dt))
            if rec.active:
                rec.set_context(init=g)
                _emit_health(rec, k, counts[r])
                if not score_ok:
                    _emit_score_health(rec, k)
                rec.metrics.count("em_iters", int(iters_np[r]))
                rec.metrics.series("active_k", k)
                _emit_em_iters(rec, k, lls[r], int(iters_np[r]), dt, epsilon)
                rec.emit("em_done", k=k, loglik=ll_f, score=float(riss),
                         criterion=config.criterion,
                         iters=int(iters_np[r]), seconds=round(dt, 6))
                rec.set_context(init=None)
            if verbose:
                print(f"init {g} K={k}: loglik={ll_f:.6e} "
                      f"{config.criterion}={riss:.6e} "
                      f"iters={int(iters_np[r])} ({dt:.2f}s)")
            # gaussian.cu:839 per lane; a NaN score never takes the slot.
            if score_ok and (
                    k == num_clusters
                    or (riss < min_riss_r[r] and target_num_clusters == 0)
                    or k == target_num_clusters):
                improved[r] = True
                min_riss_r[r], ideal_k_r[r], best_ll_r[r] = riss, k, ll_f
        if rec.active:
            rec.heartbeat("sweep", k=k_top)
        full = model.gather_states_batched(states)
        if improved.any():
            best_states = where_lanes(torch.as_tensor(improved, device=dev),
                                      full, best_states)

        # --- sweep advance per lane
        finished = live & (k_r <= stop_number)
        alive &= ~finished
        live &= ~finished
        if not alive.any():
            break
        t0 = time.perf_counter()
        next_states, k_active, min_d, pairs = eliminate_and_reduce_batched(
            full, live, diag_only=config.diag_only)
        merge_mask = np.zeros((R,), bool)
        for r in np.flatnonzero(live):
            k_new = int(k_active[r])
            if k_new < 2:
                alive[r] = False
                continue
            if not math.isfinite(float(min_d[r])):
                print(f"no valid merge pair at K={k_new} (init "
                      f"{batch_indices[r]}); stopping that restart's sweep",
                      file=sys.stderr)
                alive[r] = False
                continue
            if rec.active:
                rec.set_context(init=int(batch_indices[r]))
                rec.emit("merge", k_active=k_new, next_k=k_new - 1,
                         min_distance=float(min_d[r]),
                         pair=[int(pairs[r][0]), int(pairs[r][1])])
                rec.metrics.count("merges")
                rec.set_context(init=None)
            if mesh is not None:
                model.assert_same_merge(k_new, pairs[r])
            merge_mask[r] = True
            merges[r].append((k_new, pairs[r], float(min_d[r])))
            k_r[r] = k_new - 1
            if k_r[r] < stop_number:
                alive[r] = False
        if merge_mask.any():
            states = model.prepare_states_batched(where_lanes(
                torch.as_tensor(merge_mask, device=dev), next_states, full))
        timings["merge"] += time.perf_counter() - t0
        if ckpt is not None and alive.any():
            if rec.active:
                rec.metrics.count("checkpoint_saves")
            ckpt.save(step, host_payload())
        step += 1

    # --- batch winner: the sequential first-best rule, in lane order
    widx = 0
    for r in range(1, R):
        if math.isnan(min_riss_r[widx]) or min_riss_r[r] < min_riss_r[widx]:
            widx = r
    compact_state, n_active_w = compact(lane(best_states, widx))
    n_active = ideal_k_r.copy()
    n_active[widx] = n_active_w
    return {
        "model": model,
        "timings": timings,
        "min_riss": min_riss_r,
        "best_ll": best_ll_r,
        "n_active": n_active,
        "dropped": dropped,
        "sweep_logs": sweep_logs,
        "health_lane": health_lane,
        "recoveries": n_recoveries,
        "width": width,
        "winner": {
            "init": int(batch_indices[widx]),
            "min_riss": float(min_riss_r[widx]),
            "best_ll": float(best_ll_r[widx]),
            "state": compact_state.to("cpu"),
            "n_active": int(n_active_w),
            "sweep_log": sweep_logs[widx],
            "merges": merges[widx],
        },
    }
