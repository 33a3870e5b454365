"""Bounded microprobe: time 2-3 REAL EM iterations per candidate.

The probe is the measured rung of the fallback ladder a fresh machine
can always reach: no prior runs, no shipped database — fit the actual
data (or a synthetic stand-in of the same shape) for ``iters``
iterations per candidate and record what the clock said. Per candidate
the probe runs TWO pinned-iteration fits of the in-memory path: the
first call pays the executable compile (its wall minus the warm wall is
the recorded ``compile_s``), the second measures the steady-state
wall/iter. Candidates are visited in deterministic ascending order and
ties break toward the smaller candidate, so two probe runs over the
same data rank identically (the probe-determinism contract in
tests/test_tuning.py).

A candidate's wall is the fit's own EM wall (``GMMResult.sweep_log``,
measured from the EM's start to its read of the log-likelihood), not the
whole call's: data preparation, seeding and the result's read-back would
otherwise outweigh a few EM iterations. The candidates' rows are recorded
together once every candidate has run: a candidate that fails raises and
leaves no row for the others to choose from.

Cost: ``2 * iters * len(candidates)`` EM iterations at the probed
shape. ``autotune='probe'`` inside a fit bounds the ladder to a +/- 2
octave window around the incumbent chunk; ``gmm tune`` sweeps the full
ladder offline where the wall belongs to nobody's fit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .cost import chunk_ladder, em_iteration_cost
from .db import TuningDB, TuningKey

#: knobs the microprobe can measure (the rest resolve db/static only).
PROBEABLE = ("chunk_size", "estep_backend")


def _probe_config(config, iters: int):
    """The candidate fit's config: same numeric family as the caller's,
    every observability/persistence surface stripped (the probe must
    never write the caller's stream or checkpoints), iterations pinned,
    single init, no sweep below the target K."""
    return dataclasses.replace(
        config,
        autotune="off",
        min_iters=iters, max_iters=iters,
        n_init=1, fused_sweep=False,
        metrics_file=None, metrics_port=None,
        checkpoint_dir=None, profile=False,
        envelope=False, enable_output=False, enable_print=False,
        max_runtime_s=None,
    )


def _em_seconds(result) -> float:
    """The EM wall of a fit: its ``sweep_log`` rows' seconds."""
    return float(sum(row[4] for row in result.sweep_log))


def _time_fit(config, data, num_clusters: int) -> Tuple[float, float]:
    """(first_em_s, warm_em_s): the EM walls of two pinned-iteration fits
    at the target K. Split out so tests can inject a deterministic clock."""
    from ..models.order_search import fit_gmm

    first = fit_gmm(data, num_clusters, num_clusters, config)
    warm = fit_gmm(data, num_clusters, num_clusters, config)
    return _em_seconds(first), _em_seconds(warm)


def _kernel_candidate(config) -> bool:
    """Whether ``estep_backend='cuda'`` runs the kernels for ``config`` on
    a CUDA device, as the routing resolves it (float32, and not the
    full-covariance 'centered' form)."""
    from ..ops.kernels import resolve_estep_backend

    try:
        backend, _ = resolve_estep_backend(dataclasses.replace(
            config, estep_backend="cuda", device="cuda"))
    except ValueError:
        return False
    return backend == "cuda"


def candidates_for(knob: str, config, n_events: int, platform: str,
                   full_ladder: bool = False) -> List[Any]:
    """Deterministic candidate list for one probeable knob. ``estep_backend``
    offers torch ops alone off the card, where the kernels do not run; on
    the card no fit resolves ``chunk_size`` (``autotune.fit_knobs``)."""
    if knob == "chunk_size":
        around = None if full_ladder else int(config.chunk_size)
        return chunk_ladder(n_events, platform, around=around)
    if knob == "estep_backend":
        return (["torch", "cuda"]
                if platform == "gpu" and _kernel_candidate(config)
                else ["torch"])
    raise ValueError(f"knob {knob!r} is not probeable")


def probe_knob(config, data, num_clusters: int, key: TuningKey,
               db: TuningDB, knob: str, iters: int = 3,
               full_ladder: bool = False,
               log=None) -> Optional[Dict[str, Any]]:
    """Measure every candidate for one knob, record into ``db``, and
    return the db row (``{chosen, candidates, source, ...}``).

    Returns None when the knob admits fewer than two candidates on this
    platform (nothing to compare — the static model answers for free).
    """
    n_events = int(data.shape[0])
    cands = candidates_for(knob, config, n_events, key.platform,
                           full_ladder=full_ladder)
    if len(cands) < 2:
        # Nothing to compare: let the static model answer for free
        # instead of burning 2*iters EM iterations on a foregone
        # conclusion.
        return None
    static = em_iteration_cost(
        n_events, key.d, num_clusters, key.covariance, key.dtype)
    profiles = []
    for cand in cands:
        cfg = _probe_config(dataclasses.replace(config, **{knob: cand}),
                            iters)
        first_s, warm_s = _time_fit(cfg, data, num_clusters)
        profile = {
            "wall_per_iter_s": round(warm_s / max(iters, 1), 6),
            "compile_s": round(max(first_s - warm_s, 0.0), 6),
            "probe_iters": int(iters),
            "flops": static["flops"],
            "bytes": static["bytes"],
        }
        profiles.append((cand, profile))
        if log is not None:
            log.info("tune probe %s=%s: %.4fs/iter (compile %.3fs)",
                     knob, cand, profile["wall_per_iter_s"],
                     profile["compile_s"])
    for cand, profile in profiles:
        db.record(key, knob, cand, profile, source="probe")
    return db.lookup(key, knob)
