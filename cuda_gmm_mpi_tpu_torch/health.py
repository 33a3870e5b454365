"""Numerical fault containment: the health counters and the recovery ladder.

The port's own copy of the JAX package's ``health.py``, on tensors. The
reference is fail-fast-or-silent: a NaN loglik makes the EM loop's
``|change| > epsilon`` false, so the sweep "converges" on a poisoned model.
Three layers close that hole:

**Device side** -- a vector of counters (one lane per flag, below) is
computed every EM iteration by a few fused torch ops on the device
(``em_iter_counts`` + ``state_counts`` + the E-step's sanitized-row count)
and read to the host in the same transfer as the loglik
(models/gmm.py). A fatal lane stops the loop at the iteration the poison
became visible. On a mesh the statistics' lanes come summed over the data
axis and ``state_counts`` sums over the cluster group: every rank counts a
disjoint slice, so the sums equal the single-device run's (the JAX
package's psum-OR parity contract).

**Host side** -- the sweep packs the counters into a flag word
(:func:`pack_word`), emits ``health`` telemetry for a nonzero word, and on
a fatal word either raises :class:`NumericalFaultError` with a diagnostic
bundle (``recovery="off"``) or rolls back to the K's input state and climbs
the escalation ladder (``recovery="retry"``): sanitize + raise the variance
floor -> ``quad_mode="centered"`` -> ``matmul_precision="highest"``. A
rung's model is adopted for the rest of the sweep (sticky escalation); on
the card 'centered' moves full covariance from the kernels K1/K2 to torch
ops (``resolve_estep_backend`` says why).

**Rehearsal** -- ``testing.faults`` injects the faults on demand.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# Flag lanes. The packed word is OR(1 << lane for lanes with count > 0).
# ---------------------------------------------------------------------------

NONFINITE_LOGLIK = 0   # fatal: NaN/Inf log-likelihood observed
NONFINITE_PARAMS = 1   # fatal: NaN/Inf in an active cluster's parameters
LOGLIK_REGRESSION = 2  # loglik dropped more than regression_scale * epsilon
EMPTY_CLUSTER = 3      # active cluster with membership below the 0.5 floor
COV_DYNAMIC_RANGE = 4  # covariance diagonal outside the configured range
SANITIZED_LANES = 5    # non-finite log-sum-exp rows sanitized in the E-step
NONFINITE_SCORE = 6    # NaN/Inf model-order score (selection guard)
NUM_FLAGS = 7

FLAG_NAMES = (
    "nonfinite_loglik", "nonfinite_params", "loglik_regression",
    "empty_cluster", "cov_dynamic_range", "sanitized_lanes",
    "nonfinite_score",
)

FATAL_MASK = (1 << NONFINITE_LOGLIK) | (1 << NONFINITE_PARAMS)

# Membership floor below which an active cluster counts as empty/collapsed
# (the reference's Nk > 0.5 emptiness threshold, gaussian.cu:865-874).
MEMBERSHIP_FLOOR = 0.5


# ---------------------------------------------------------------------------
# Device-side counters. Every function returns a [NUM_FLAGS] tensor (in the
# loglik's dtype, exact for counts below 2**24) that adds across iterations.
# A leading restart axis on the inputs gives [R, NUM_FLAGS].
# ---------------------------------------------------------------------------

def em_iter_counts(loglik, loglik_prev=None, regression_tol=None):
    """Loglik lanes of one EM iteration: ``nonfinite_loglik``, and with
    ``loglik_prev``/``regression_tol`` the ``loglik_regression`` check (EM's
    loglik is non-decreasing in exact arithmetic; a drop beyond the
    tolerance is flagged, though not fatal)."""
    counts = torch.zeros(loglik.shape + (NUM_FLAGS,), dtype=loglik.dtype,
                         device=loglik.device)
    counts[..., NONFINITE_LOGLIK] = (~torch.isfinite(loglik)).to(loglik.dtype)
    if loglik_prev is not None and regression_tol is not None:
        regressed = (torch.isfinite(loglik) & torch.isfinite(loglik_prev)
                     & (loglik < loglik_prev - regression_tol))
        counts[..., LOGLIK_REGRESSION] = regressed.to(loglik.dtype)
    return counts


def state_counts(state, Nk=None, *, dynamic_range: float = 1e3,
                 cluster_group=None):
    """Parameter lanes of one state:

    - ``nonfinite_params``: active clusters with any non-finite entry
      across N/pi/constant/avgvar/means/R/Rinv;
    - ``empty_cluster``: active clusters whose soft count (``Nk``, the
      fresh statistics, else ``state.N``) is below the 0.5 floor;
    - ``cov_dynamic_range``: active, non-empty clusters whose covariance
      diagonal is non-positive or spans more than ``dynamic_range**2``
      max/min (finite diagonals only: non-finite ones count as
      ``nonfinite_params``).

    With ``cluster_group`` (a sharded cluster axis) each rank counts its
    own clusters and an all_reduce SUM over the group gives every rank the
    global counts.
    """
    act = state.active
    nk = state.N if Nk is None else Nk
    dt = state.R.dtype

    def fin_rows(t, dims):
        return torch.isfinite(t).flatten(-dims).all(dim=-1)

    row_ok = (torch.isfinite(state.N) & torch.isfinite(state.pi)
              & torch.isfinite(state.constant) & torch.isfinite(state.avgvar)
              & fin_rows(state.means, 1) & fin_rows(state.R, 2)
              & fin_rows(state.Rinv, 2))
    n_nonfinite = (act & ~row_ok).sum(dim=-1)
    n_empty = (act & (nk < MEMBERSHIP_FLOOR)).sum(dim=-1)
    diag = torch.diagonal(state.R, dim1=-2, dim2=-1)
    dmax = diag.max(dim=-1).values
    dmin = diag.min(dim=-1).values
    nonempty = act & (nk >= MEMBERSHIP_FLOOR)
    ratio_bad = (dmin <= 0.0) | (dmax > (dynamic_range ** 2)
                                 * torch.clamp(dmin, min=1e-300))
    ratio_bad = ratio_bad & torch.isfinite(diag).all(dim=-1)
    n_range = (nonempty & ratio_bad).sum(dim=-1)
    counts = torch.zeros(act.shape[:-1] + (NUM_FLAGS,), dtype=dt,
                         device=act.device)
    counts[..., NONFINITE_PARAMS] = n_nonfinite.to(dt)
    counts[..., EMPTY_CLUSTER] = n_empty.to(dt)
    counts[..., COV_DYNAMIC_RANGE] = n_range.to(dt)
    if cluster_group is not None:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=cluster_group)
    return counts


def iteration_counts(state, stats, loglik, loglik_prev=None,
                     regression_tol=None, *, dynamic_range: float = 1e3,
                     cluster_group=None):
    """One EM iteration's counters: the loglik lanes, the state lanes on
    the fresh statistics' soft counts, and the E-step's sanitized rows
    (the JAX package's ``health_counts`` inside ``em_while_loop``)."""
    counts = em_iter_counts(loglik, loglik_prev, regression_tol) \
        + state_counts(state, Nk=stats.Nk, dynamic_range=dynamic_range,
                       cluster_group=cluster_group)
    counts[..., SANITIZED_LANES] += stats.sanitized.to(counts.dtype)
    return counts


def fatal_rows(counts: np.ndarray) -> np.ndarray:
    """Host-side: True where a counter row has a fatal lane."""
    c = np.asarray(counts)
    return (c[..., NONFINITE_LOGLIK] > 0) | (c[..., NONFINITE_PARAMS] > 0)


def fatal(counts: torch.Tensor) -> torch.Tensor:
    """Device-side :func:`fatal_rows`: a bool tensor, no host read (the
    JAX package's trace-safe ``fatal``)."""
    return ((counts[..., NONFINITE_LOGLIK] > 0)
            | (counts[..., NONFINITE_PARAMS] > 0))


def pack_word_traced(counts: torch.Tensor) -> torch.Tensor:
    """Device-side :func:`pack_word`: the int64 flag word of a counter
    vector, no host read (the fused sweep stores one per K in its log)."""
    bits = torch.bitwise_left_shift(
        torch.ones(NUM_FLAGS, dtype=torch.int64, device=counts.device),
        torch.arange(NUM_FLAGS, device=counts.device))
    return ((counts[..., :NUM_FLAGS] > 0).to(torch.int64) * bits).sum(dim=-1)


# ---------------------------------------------------------------------------
# Host-side word packing / description.
# ---------------------------------------------------------------------------

def pack_word(counts) -> int:
    """Pack a counter vector into the int flag word (host-side)."""
    c = np.asarray(counts).reshape(-1)
    word = 0
    for lane in range(min(c.shape[0], NUM_FLAGS)):
        if c[lane] > 0:
            word |= 1 << lane
    return word


def word_is_fatal(word: int) -> bool:
    return bool(int(word) & FATAL_MASK)


def flag_names(word: int) -> List[str]:
    return [name for lane, name in enumerate(FLAG_NAMES)
            if int(word) & (1 << lane)]


def counts_dict(counts) -> Dict[str, int]:
    c = np.asarray(counts).reshape(-1)
    return {name: int(c[lane]) for lane, name in enumerate(FLAG_NAMES)
            if lane < c.shape[0] and c[lane]}


def health_summary(total_counts, recoveries: int = 0,
                   io_retries: int = 0,
                   restart_drops: int = 0) -> Dict[str, Any]:
    """The ``run_summary.health`` section / ``GMMResult.health`` payload.
    ``restart_drops`` counts restarts dropped from a batched n_init run by
    the drop-one-keep-survivors containment (models/restarts.py)."""
    word = pack_word(total_counts)
    out = {
        "flags": int(word),
        "flag_names": flag_names(word),
        "fatal": word_is_fatal(word),
        "counters": counts_dict(total_counts),
        "recoveries": int(recoveries),
        "io_retries": int(io_retries),
    }
    if restart_drops:
        out["restart_drops"] = int(restart_drops)
    return out


class NumericalFaultError(RuntimeError):
    """A numerical fault was detected and could not (or must not) be
    recovered. Carries the diagnostic ``bundle``: the flag word and
    per-lane counters, the sweep position, and -- after an exhausted
    escalation ladder -- the full per-attempt history."""

    def __init__(self, message: str, bundle: Dict[str, Any]):
        self.bundle = bundle
        lines = [message]
        for key in sorted(bundle):
            lines.append(f"  {key}: {bundle[key]}")
        super().__init__("\n".join(lines))


def fault_bundle(counts, *, k=None, where: str = "em",
                 attempts: Optional[list] = None,
                 config=None) -> Dict[str, Any]:
    word = pack_word(counts)
    bundle: Dict[str, Any] = {
        "flags": int(word),
        "flag_names": flag_names(word),
        "counters": counts_dict(counts),
        "where": where,
    }
    if k is not None:
        bundle["k"] = int(k)
    if attempts is not None:
        bundle["attempts"] = attempts
    if config is not None:
        bundle["config"] = {
            "quad_mode": config.quad_mode,
            "matmul_precision": config.matmul_precision,
            "dtype": config.dtype,
            "covariance_type": config.covariance_type,
            "recovery": config.recovery,
        }
    return bundle


# ---------------------------------------------------------------------------
# Rollback-and-retry recovery (host side).
# ---------------------------------------------------------------------------

def escalation_ladder(config) -> List[Dict[str, Any]]:
    """The deterministic recovery ladder, bounded by
    ``max_recovery_attempts``. Every rung first rolls back to the K's
    input state and sanitizes it (non-finite entries cleared, non-PD
    covariances identity-reset, variance floor raised by
    ``recovery_boost`` per attempt); rungs 2/3 additionally rebuild the
    model with progressively stabler numerics."""
    rungs = [
        {"action": "regularize"},
        {"action": "centered", "quad_mode": "centered"},
        {"action": "highest", "quad_mode": "centered",
         "matmul_precision": "highest"},
    ]
    return rungs[:max(0, int(config.max_recovery_attempts))]


def repair_state(state, *, diag_only: bool = False, boost: float = 1.0,
                 cluster_group=None):
    """Sanitize a rollback state for a retry: non-finite entries cleared,
    the variance floor (``avgvar``) raised by ``boost``, and
    ``compute_constants`` re-deriving Rinv/constant/pi -- which also
    identity-resets any covariance whose factorization fails (the
    reference's reset, gaussian.cu:669-678). ``cluster_group``: the state
    is one rank's clusters of a sharded cluster axis (pi's denominator is
    summed over the group)."""
    from .ops.constants import compute_constants

    def fin(a, fill=0.0):
        return torch.where(torch.isfinite(a), a, torch.full_like(a, fill))

    st = state.replace(
        N=fin(state.N),
        pi=fin(state.pi, 1e-10),
        avgvar=fin(state.avgvar) * boost,
        means=fin(state.means),
        R=fin(state.R),
        constant=fin(state.constant),
        Rinv=fin(state.Rinv),
    )
    return compute_constants(st, diag_only=diag_only,
                             cluster_group=cluster_group)


def rung_model(model, config, rung: Dict[str, Any]):
    """The model to run a recovery rung on: the primary model for the
    pure-regularization rung, else a same-class rebuild with the rung's
    numerics overrides (cached per rung on the primary model). The rebuilt
    model resolves its own statistics route: 'centered' on full
    covariance leaves the kernels for torch ops, with
    ``resolve_estep_backend``'s reason on ``estep_backend_reason``."""
    overrides: Dict[str, Any] = {}
    if "quad_mode" in rung and config.quad_mode != rung["quad_mode"]:
        overrides["quad_mode"] = rung["quad_mode"]
    if ("matmul_precision" in rung
            and config.matmul_precision != rung["matmul_precision"]):
        overrides["matmul_precision"] = rung["matmul_precision"]
    if not overrides:
        return model, config
    if config.precompute_features and overrides.get("quad_mode") == "centered":
        # 'centered' has no loop-invariant feature matrix to hoist.
        overrides["precompute_features"] = False
    if (config.estep_backend == "cuda"
            and overrides.get("quad_mode") == "centered"
            and not config.diag_only):
        # An explicit kernel request must not pin the escalated run to a
        # route that cannot take it (the JAX package drops its Pallas
        # override here the same way).
        overrides["estep_backend"] = "torch"
    cfg2 = dataclasses.replace(config, **overrides)

    cache = model.__dict__.setdefault("_recovery_models", {})
    key = tuple(sorted(overrides.items()))
    m2 = cache.get(key)
    if m2 is None:
        if getattr(model, "mesh", None) is not None:
            # Keep the SAME mesh: the placed data stays valid.
            m2 = type(model)(cfg2, mesh=model.mesh)
            m2._k_cols = model._k_cols
        else:
            m2 = type(model)(cfg2)
        cache[key] = m2
    return m2, cfg2


def recover_em(model, config, rollback, chunks, wts, epsilon, k, *,
               n_events=None, rec=None, log=None, faulty_counts):
    """Roll back and retry one K's EM up the escalation ladder.

    Returns ``(model, state, loglik, iters, counts, lls)`` from the first
    clean rung; the returned model is the rung's (callers adopt it for the
    rest of the sweep -- sticky escalation). Raises
    :class:`NumericalFaultError` when recovery is off, the ladder is
    empty, or every rung stays fatal. Each attempt is logged with the
    rung's statistics route.
    """
    word = pack_word(faulty_counts)
    if config.recovery != "retry":
        raise NumericalFaultError(
            f"numerical fault at K={int(k)} "
            f"(flags={flag_names(word)}) and recovery is "
            f"{config.recovery!r}",
            fault_bundle(faulty_counts, k=k, config=config))

    ladder = escalation_ladder(config)
    attempts: List[Dict[str, Any]] = []
    group = (model.mesh.cluster_group
             if getattr(model, "mesh", None) is not None else None)
    for attempt, rung in enumerate(ladder, start=1):
        m2, cfg2 = rung_model(model, config, rung)
        boost = float(config.recovery_boost) ** attempt
        repaired = repair_state(rollback, diag_only=cfg2.diag_only,
                                boost=boost, cluster_group=group)
        state, ll, iters = m2.run_em(repaired, chunks, wts, epsilon,
                                     n_events=n_events)
        counts = m2.last_health
        ok = not word_is_fatal(pack_word(counts))
        record = {
            "attempt": attempt, "action": rung["action"], "boost": boost,
            "flags": int(pack_word(counts)),
            "flag_names": flag_names(pack_word(counts)),
            "outcome": "recovered" if ok else "fatal",
            "loglik": float(ll),
        }
        attempts.append(record)
        if log is not None:
            log.warning(
                "recovery attempt %d (%s) at K=%d: %s [estep backend %s: %s]",
                attempt, rung["action"], int(k), record["outcome"],
                m2.estep_backend, m2.estep_backend_reason)
        if rec is not None and rec.active:
            rec.emit("recovery", k=int(k), attempt=attempt,
                     action=rung["action"], outcome=record["outcome"],
                     flags=record["flags"],
                     flag_names=record["flag_names"])
            rec.metrics.count("recovery_attempts")
            if ok:
                rec.metrics.count("recoveries")
        if ok:
            return m2, state, float(ll), int(iters), counts, m2.last_lls
    raise NumericalFaultError(
        f"numerical fault at K={int(k)} not recovered after "
        f"{len(ladder)} escalation attempt(s) "
        f"(flags={flag_names(word)})",
        fault_bundle(faulty_counts, k=k, attempts=attempts, config=config))


def reseed_empty_clusters(model, state, chunks, seed: int = 0):
    """Reseed empty active clusters from the worst-fit events.

    The reference ELIMINATES empties (gaussian.cu:865-874) -- that stays
    the default. With ``recovery_reseed_empty`` a target-K fit instead
    moves each empty cluster's mean onto the events the current model
    explains worst (lowest log-evidence in the first data block; ties by
    row order), with the mean live covariance. Returns
    ``(new_state, n_reseeded)``.
    """
    from .ops.constants import compute_constants

    act = state.active.cpu().numpy()
    nk = state.N.cpu().numpy()
    empty = np.flatnonzero(act & (nk < MEMBERSHIP_FLOOR))
    if empty.size == 0:
        return state, 0
    block = chunks.reshape(-1, chunks.shape[-1])[:model.inference_block]
    _, logz = model.infer_posteriors(state, block)
    worst = np.argsort(logz.cpu().numpy()[:block.shape[0]],
                       kind="stable")[:empty.size]
    means = state.means.clone()
    R = state.R.clone()
    N = state.N.clone()
    live = np.flatnonzero(act & (nk >= MEMBERSHIP_FLOOR))
    R_seed = (R[torch.as_tensor(live, device=R.device)].mean(dim=0)
              if live.size else torch.eye(R.shape[-1], dtype=R.dtype,
                                          device=R.device))
    for slot, row in zip(empty, worst):
        means[int(slot)] = block[int(row)]
        R[int(slot)] = R_seed
        N[int(slot)] = 1.0
    repaired = compute_constants(state.replace(means=means, R=R, N=N),
                                 diag_only=model.config.diag_only)
    return repaired, int(empty.size)
