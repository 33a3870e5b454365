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

The batched sweep is FIXED-WIDTH (no pow2 rebucketing): lanes reach
different active counts at the same step, and one batched state serves
them all. At the main path's K = 100 -> 96 the sequential path keeps
width 100 as well; at small K it rebuckets, so the two agree to rounding
there, not to the bit. ``restart_batch_size=1`` keeps the sequential
path, which picks the same winner at the same seeds.

Not ported yet: health counters and drop-one containment, the recovery
ladder, checkpoint/resume and the supervisor, and telemetry events.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..ops.formulas import convergence_epsilon, model_score
from ..ops.merge import eliminate_and_reduce_batched
from ..ops.seeding import seed_states_batched
from ..state import clone_state, compact, lane, where_lanes


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
        from ..ops.kernels.fused_stats import K1_GRID, TILE

        diag = config.diag_only
        F = D if diag else D * D
        T = D if diag else D * (D + 1) // 2
        k_pad = -(-K // TILE) * TILE
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
    for a single init, else ``config.restart_batch_size`` or, when that is
    None, the memory cap; clamped to [1, n_init]."""
    if config.n_init <= 1:
        return 1
    requested = config.restart_batch_size
    if requested is None:
        n_events, n_dims = np.shape(data)
        requested = restart_batch_auto_cap(config, int(n_events), int(n_dims),
                                           int(num_clusters), device=device)
    return max(1, min(int(requested), config.n_init))


def fit_restarts_batched(prepared, num_clusters: int,
                         target_num_clusters: int, config, model,
                         verbose: bool, batch_size: int, init_means=None):
    """``n_init`` restarts in batches of ``batch_size``, one batched sweep
    each, on ``prepared`` (``order_search._prepare_data``'s result), init 0
    seeded from ``init_means`` when given;
    returns the GMMResult of the winner, the same init the sequential path
    picks at the same seeds (``init_index``). Its ``timings`` sum the
    host-clock seconds of the batches' seeding, EM and merge scans."""
    from .order_search import GMMResult

    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    data, chunks, wts, n_events, n_dims, shift, var_mean = prepared
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462
    winner = None
    timings = dict.fromkeys(("seed", "em", "merge"), 0.0)
    for b0 in range(0, config.n_init, batch_size):
        idxs = list(range(b0, min(b0 + batch_size, config.n_init)))
        out = _run_batch(model, config, data, num_clusters, stop_number,
                         target_num_clusters, chunks, wts, n_events, n_dims,
                         shift, var_mean, epsilon, idxs, verbose,
                         init_means)
        for part, secs in out["timings"].items():
            timings[part] += secs
        if verbose:
            for j, g in enumerate(idxs):
                print(f"init {g}: {config.criterion}="
                      f"{out['min_riss'][j]:.6e} K={out['n_active'][j]}")
        # The sequential first-best rule across batches: within a batch
        # _run_batch already picked first-best, so comparing batch winners
        # in batch order is the same rule.
        w = out["winner"]
        if (winner is None or math.isnan(winner["min_riss"])
                or w["min_riss"] < winner["min_riss"]):
            winner = w
    if verbose:
        print(f"best of {config.n_init} inits: "
              f"{config.criterion}={winner['min_riss']:.6e} "
              f"K={winner['n_active']}")
    return GMMResult(
        state=winner["state"], ideal_num_clusters=winner["n_active"],
        min_rissanen=float(winner["min_riss"]),
        final_loglik=float(winner["best_ll"]), epsilon=epsilon,
        num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=winner["sweep_log"],
        merges=winner["merges"], model=model, init_index=winner["init"],
        timings=timings)


def _run_batch(model, config, data, num_clusters, stop_number,
               target_num_clusters, chunks, wts, n_events, n_dims, shift,
               var_mean, epsilon, batch_indices, verbose,
               init_means=None) -> dict:
    """One batch of restarts through the whole fixed-width sweep.

    A ragged tail batch runs at its own width: PyTorch compiles nothing per
    batch shape, so padding it to the full batch would only add work. A
    lane whose sweep has ended is frozen: EM skips it (``max_iters`` 0)
    and so does the merge scan.
    """
    from .order_search import _seed_rows

    R = len(batch_indices)
    dtype = np.dtype(config.dtype)
    dev = model.device
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
    timings = {"seed": time.perf_counter() - t0, "em": 0.0, "merge": 0.0}

    k_r = np.full((R,), num_clusters, np.int64)
    alive = np.ones((R,), bool)
    min_riss_r = np.full((R,), np.inf)
    ideal_k_r = np.full((R,), num_clusters, np.int64)
    best_ll_r = np.full((R,), -np.inf)
    sweep_logs = [[] for _ in range(R)]
    merges = [[] for _ in range(R)]
    best_states = clone_state(states)
    while alive.any():
        t0 = time.perf_counter()
        live = alive.copy()
        lo_r = np.where(live, min(config.min_iters, config.max_iters), 0)
        hi_r = np.where(live, config.max_iters, 0)
        states, ll_np, iters_np = model.run_em_batched(
            states, chunks, wts, epsilon, min_iters=lo_r, max_iters=hi_r,
            n_events=n_events)
        dt = time.perf_counter() - t0  # EM only, as in fit_gmm's sweep_log
        timings["em"] += dt

        # --- scoring + best-model save per live lane
        improved = np.zeros((R,), bool)
        for r in np.flatnonzero(live):
            ll_f = float(ll_np[r])
            k = int(k_r[r])
            riss = model_score(ll_f, k, n_events, n_dims,
                               criterion=config.criterion,
                               covariance_type=config.covariance_type)
            sweep_logs[r].append((k, ll_f, riss, int(iters_np[r]), dt))
            if verbose:
                print(f"init {batch_indices[r]} K={k}: loglik={ll_f:.6e} "
                      f"{config.criterion}={riss:.6e} "
                      f"iters={int(iters_np[r])} ({dt:.2f}s)")
            # gaussian.cu:839 per lane; a NaN score never takes the slot.
            if math.isfinite(riss) and (
                    k == num_clusters
                    or (riss < min_riss_r[r] and target_num_clusters == 0)
                    or k == target_num_clusters):
                improved[r] = True
                min_riss_r[r], ideal_k_r[r], best_ll_r[r] = riss, k, ll_f
        if improved.any():
            best_states = where_lanes(torch.as_tensor(improved, device=dev),
                                      states, best_states)

        # --- sweep advance per lane
        finished = live & (k_r <= stop_number)
        alive &= ~finished
        live &= ~finished
        if not alive.any():
            break
        t0 = time.perf_counter()
        next_states, k_active, min_d, pairs = eliminate_and_reduce_batched(
            states, live, diag_only=config.diag_only)
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
            merge_mask[r] = True
            merges[r].append((k_new, pairs[r], float(min_d[r])))
            k_r[r] = k_new - 1
            if k_r[r] < stop_number:
                alive[r] = False
        if merge_mask.any():
            states = where_lanes(torch.as_tensor(merge_mask, device=dev),
                                 next_states, states)
        timings["merge"] += time.perf_counter() - t0

    # --- batch winner: the sequential first-best rule, in lane order
    widx = 0
    for r in range(1, R):
        if math.isnan(min_riss_r[widx]) or min_riss_r[r] < min_riss_r[widx]:
            widx = r
    compact_state, n_active_w = compact(lane(best_states, widx))
    n_active = ideal_k_r.copy()
    n_active[widx] = n_active_w
    return {
        "timings": timings,
        "min_riss": min_riss_r,
        "n_active": n_active,
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
