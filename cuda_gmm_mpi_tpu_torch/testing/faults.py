"""Deterministic fault injection for the numerical-containment subsystem.

The port's own copy of the JAX package's ``testing/faults.py``: the same
kinds, spec format (``GMM_FAULTS``) and firing budgets. The port fires
``nan_loglik``, ``singular_cov``, ``checkpoint_eio``, ``preempt``, the
streaming kinds ``poison_block`` and ``read_slow`` (models/streaming.py,
io/pipeline.py) and the liveness kinds ``rank_hang``, ``rank_lost`` and
``collective_timeout`` (supervisor.py, parallel/); the other kinds belong
to paths it does not have yet (serving, lifecycle) and are accepted in a
plan but never fire.

The reference has no way to rehearse its failure modes: a singular
covariance or NaN event appears only when real data produces one, so the
recovery paths (docs/ROBUSTNESS.md) would otherwise ship untested. This
module provides env/config-gated injection points that production code
consults; each fires a bounded number of times (``times``, default 1), so a
recovery retry observes the fault gone -- exactly the transient-fault shape
the escalation ladder exists for.

Supported fault kinds (the spec is ``{kind: {params...}}``):

- ``nan_loglik``   ``{"iter": i, "restart": r, "times": n}`` -- the EM
  loop's loglik becomes NaN at iteration ``i`` (1-based; the initial
  E-step is iteration 0). The JAX package consumes the plan when it
  TRACES an EM executable (one per model, call variant and padded width)
  and compiles the injection into it, so a same-executable retry
  re-observes the fault while a rebuilt (escalated) model traces clean --
  ``times`` therefore counts *traced executables*. The port has no traces:
  each model keeps the same table of executables explicitly
  (``models/gmm.py::GMMModel.armed_fault``) and arms an entry from the
  plan the first time it runs it, so the fault fires on the same runs. ``restart`` (optional)
  targets ONE lane of the batched restart loop (the drop-one-keep-
  survivors rehearsal, models/restarts.py); a plan with ``restart`` set
  never fires in an EM loop that has no restart axis.
- ``singular_cov`` ``{"cluster": c, "times": n}`` -- the seeded state's
  cluster ``c`` gets a singular covariance (R zeroed) with the poisoned
  inverse (Rinv +inf) a real inversion of it would produce; consumed per
  seeded fit.
- ``poison_block`` ``{"block": j, "times": n}`` -- the streaming path's
  host->device block ``j`` arrives as all-NaN (a torn read / bad DMA);
  consumed per delivery, so the recovery retry streams clean data.
- ``read_slow`` ``{"ms": m, "block": j, "times": n}`` -- the pipelined
  ingestion worker (io/pipeline.py) sleeps ``m`` milliseconds before
  reading block ``j`` (any block when omitted): deterministic slow-disk
  injection for the bounded-queue backpressure path; consumed per read,
  host side, so results stay bit-identical -- only the prefetch wait
  moves.
- ``checkpoint_eio`` ``{"step": s, "times": n}`` -- the checkpoint write
  for sweep step ``s`` (any step when omitted) raises ``OSError(EIO)``;
  consumed per raise, so the bounded retry's n+1-th attempt succeeds.
- ``preempt`` ``{"iter": i, "block": j, "times": n}`` -- the run
  supervisor's poll treats EM iteration ``i`` (optionally: streaming
  block ``j`` of pass ``i``; segment-boundary polls match ``block: -1``)
  as if SIGTERM had just arrived: deterministic stand-in for a real
  preemption signal, driving the emergency-checkpoint + exit-75 path
  (supervisor.py; consumed at the poll, host side).
- ``rank_hang`` ``{"rank": r, "iter": i, "times": n}`` -- process ``r``
  of a multi-controller run stops heartbeating and wedges at its next
  supervisor poll (optionally at EM iteration ``i``), simulating a dead
  or stuck host so the PEER's liveness watchdog (``PeerLostError`` +
  emergency checkpoint) can be rehearsed. The wedged process never
  returns; the test harness kills it.
- ``rank_lost`` ``{"rank": r, "iter": i, "block": j, "where": w,
  "times": n}`` -- the run supervisor's poll behaves as if the liveness
  watchdog had just declared peer ``r`` dead (stale heartbeat), emitting
  ``peer_lost`` and tripping the stop flag, WITHOUT any process actually
  dying: the deterministic single-process driver for the elastic
  shrink-and-continue path (``--elastic``) and its exit-75 fallback.
  ``iter``/``block`` target one EM iteration / streaming block exactly
  like ``preempt`` (segment-boundary polls match ``block: -1``);
  ``where`` targets one poll site (e.g. ``sweep`` for between-K).
  Consumed at the poll, host side.
- ``collective_timeout`` ``{"name": b, "rank": r, "times": k}`` -- the
  named filesystem-rendezvous barrier (``parallel.distributed.barrier``;
  any barrier when ``name`` is omitted) raises the same
  :class:`PeerLostError` a real timeout would, with ``rank`` as the
  blamed peer, before any waiting happens -- so the collective-loss leg
  of elastic recovery is rehearsable on one process.
- ``serve_nan`` ``{"model": name, "times": n}`` -- the serving loop's
  coalesced dispatch for ``model`` (any model when omitted) returns
  all-NaN scores, standing in for a poisoned registry artifact so the
  post-dispatch non-finite check and the per-route circuit breaker
  (serving/server.py, serving/breaker.py) can be rehearsed; consumed
  per dispatch, so a breaker's half-open probe after ``times``
  dispatches observes the model healthy again.
- ``serve_slow`` ``{"ms": m, "model": name, "times": n}`` -- the serving
  dispatch sleeps ``m`` milliseconds before the executor call
  (optionally only for ``model``): deterministic latency injection for
  the deadline/coalescing paths; consumed per dispatch.
- ``worker_crash`` ``{"worker": w, "gen": g, "model": name,
  "exitcode": c, "times": n}`` -- the serving dispatch hard-kills its
  own process (``os._exit``, default code 9 -- indistinguishable from a
  SIGKILL'd worker) just before the executor call, optionally only in
  pool worker ``w`` and/or respawn generation ``g`` (matched against the
  ``GMM_SERVE_WORKER`` / ``GMM_SERVE_WORKER_GEN`` env the pool stamps on
  each child; generation 0 is the first launch) or for ``model``. The
  deterministic driver for the worker pool's containment arc
  (serving/pool.py): sibling retry of the dead worker's in-flight
  requests, jittered-doubling respawn, crash-loop quarantine. A
  respawned worker is a FRESH process that re-reads GMM_FAULTS, so pin
  ``gen: 0`` to crash once and observe the respawn serve clean, or omit
  ``gen`` to crash every generation and drive the quarantine path.
- ``registry_torn`` ``{"name": n, "version": v, "times": k}`` -- the
  registry's version load raises :class:`RegistryError` as if the
  artifact were torn on disk (optionally only for one name/version);
  consumed per load attempt, so walk-back and breaker-recovery
  rehearsals observe the next attempt succeed.
- ``retrain_fail`` ``{"model": name, "times": n}`` -- the lifecycle
  controller's shadow minibatch-EM refit (lifecycle/controller.py)
  raises before fitting (optionally only for ``model``), driving the
  jittered-doubling retry ladder and, at exhaustion, the
  quarantine-the-attempt path; consumed per attempt, so the n+1-th
  retry fits clean. The serving path never observes the failure.
- ``canary_regression`` ``{"model": name, "shift": s, "times": n}`` --
  the canary gate evaluation scores the CANDIDATE as if its mean
  holdout score had regressed by ``s`` (default: far past the gate's
  tolerance), so the mean-regression gate rejects it; consumed per gate
  evaluation. Client-visible responses stay byte-identical -- only the
  shadow scores are poisoned.
- ``promote_torn`` ``{"name": n, "version": v, "times": k}`` -- the
  registry's promote raises between the manifest stage-flip and the
  candidate-marker removal, simulating a crash mid-promotion: the
  candidate stays invisible to enumeration/poll and the flip stays
  retryable; consumed per promote attempt.

Activation: ``faults.use({...})`` (context manager, in-process tests) or
the ``GMM_FAULTS`` env var holding the JSON spec (subprocess workers; read
once, at the first hook that fires). No plan installed = every hook returns
None immediately.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

ENV_VAR = "GMM_FAULTS"

KNOWN_KINDS = ("nan_loglik", "singular_cov", "poison_block", "read_slow",
               "checkpoint_eio", "preempt", "rank_hang", "rank_lost",
               "collective_timeout", "serve_nan", "serve_slow",
               "worker_crash", "registry_torn", "retrain_fail",
               "canary_regression", "promote_torn")


def _values_match(spec_val: Any, val: Any) -> bool:
    """Spec-vs-call match: integer kinds compare as ints (the original
    contract); non-numeric params (serve_nan's model NAME) as strings."""
    try:
        return int(spec_val) == int(val)
    except (TypeError, ValueError):
        return str(spec_val) == str(val)


class FaultPlan:
    """A mutable injection plan: per-kind params plus a firing budget."""

    def __init__(self, spec: Dict[str, Dict[str, Any]]):
        for kind in spec:
            if kind not in KNOWN_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (expected one of "
                    f"{KNOWN_KINDS})")
        self._lock = threading.Lock()
        self._spec = {
            kind: dict(cfg, _remaining=int(cfg.get("times", 1)))
            for kind, cfg in spec.items()
        }
        self.fired: Dict[str, int] = {k: 0 for k in self._spec}

    def peek(self, kind: str) -> Optional[Dict[str, Any]]:
        """The kind's params if it still has budget (no consumption)."""
        cfg = self._spec.get(kind)
        if cfg is None or cfg["_remaining"] <= 0:
            return None
        return cfg

    def take(self, kind: str, **match) -> Optional[Dict[str, Any]]:
        """Consume one firing of ``kind`` if armed and every ``match``
        key equals the plan's value (plan keys absent from the spec match
        anything -- e.g. ``checkpoint_eio`` with no ``step`` fires on any
        step). Returns the params dict or None."""
        with self._lock:
            cfg = self._spec.get(kind)
            if cfg is None or cfg["_remaining"] <= 0:
                return None
            for key, val in match.items():
                if key in cfg and not _values_match(cfg[key], val):
                    return None
            cfg["_remaining"] -= 1
            self.fired[kind] = self.fired.get(kind, 0) + 1
            return cfg


_installed: Optional[FaultPlan] = None
_env_checked = False
_env_lock = threading.Lock()


def install(spec: Optional[Dict[str, Dict[str, Any]]]) -> Optional[FaultPlan]:
    """Install (or, with None, clear) the process-wide fault plan."""
    global _installed, _env_checked
    _installed = FaultPlan(spec) if spec is not None else None
    _env_checked = True  # explicit install/clear overrides the env plan
    return _installed


def clear() -> None:
    install(None)


class use:
    """Context manager: install a plan for the enclosed block, then clear.

    The plan object is the as-target value, so tests can assert on
    ``plan.fired`` after the block.
    """

    def __init__(self, spec: Dict[str, Dict[str, Any]]):
        self._spec = spec

    def __enter__(self) -> FaultPlan:
        return install(self._spec)

    def __exit__(self, *exc) -> None:
        clear()


def active() -> Optional[FaultPlan]:
    """The current plan: an installed one, else GMM_FAULTS (parsed once)."""
    global _installed, _env_checked
    if _installed is not None:
        return _installed
    if not _env_checked:
        with _env_lock:
            if not _env_checked:
                raw = os.environ.get(ENV_VAR)
                if raw:
                    _installed = FaultPlan(json.loads(raw))
                _env_checked = True
    return _installed


def take(kind: str, **match) -> Optional[Dict[str, Any]]:
    """Module-level shortcut: consume from the active plan (None = no-op)."""
    plan = active()
    return plan.take(kind, **match) if plan is not None else None


def peek(kind: str) -> Optional[Dict[str, Any]]:
    plan = active()
    return plan.peek(kind) if plan is not None else None


def raise_io_error(kind: str, **match) -> None:
    """Raise an injected OSError(EIO) when ``kind`` is armed and matches."""
    cfg = take(kind, **match)
    if cfg is not None:
        import errno

        raise OSError(errno.EIO, f"injected {kind} fault", str(cfg))


def maybe_poison_state(state):
    """Apply an armed ``singular_cov`` fault to a freshly seeded state.

    Zeroes cluster ``c``'s covariance and sets its inverse to +inf -- the
    poisoned pair a real inversion of a singular R produces -- so the first
    E-step's densities go non-finite and the health bitmask must catch it
    (``nonfinite_params`` + ``nonfinite_loglik``).
    """
    cfg = take("singular_cov")
    if cfg is None:
        return state
    c = int(cfg.get("cluster", 0))
    R, Rinv = state.R.clone(), state.Rinv.clone()
    R[..., c, :, :] = 0.0
    Rinv[..., c, :, :] = float("inf")
    return state.replace(R=R, Rinv=Rinv)


def maybe_poison_block(chunk, wts, block: int):
    """Apply an armed ``poison_block`` fault to one streamed host block."""
    cfg = take("poison_block", block=block)
    if cfg is None:
        return chunk, wts
    import numpy as np

    bad = np.full_like(np.asarray(chunk), np.nan)
    return bad, wts
