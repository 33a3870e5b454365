"""Drift-triggered shadow retrain with canary gates and auto-rollback.

The port of the JAX package's ``lifecycle/controller.py``: the same policy,
states, events and contracts. The refit is the port's stepwise EM
(``GaussianMixture`` with ``stream_events=True, em_mode='minibatch'``; on
the card K1 per streamed block and K2 per M-step) on the serving device,
and canary, shadow and watch scoring go through the serving executor (S1
on the card).

The controller is a per-route state machine driven from the serve tick
loop (``gmm serve --lifecycle policy.json``) or offline against a
recorded stream (``gmm lifecycle``)::

    idle --debounced drift_alarm--> retrain --published--> canary
      ^                               | exhausted            | gates
      |                               v                      v
    cooldown <---- quarantine <-------+            promote --+--> watch
      ^                                                        | trip /
      |                     rollback (re-publish prior) <------+ alarm /
      +------------------------------------+                     regress

Contracts (docs/ROBUSTNESS.md "Model lifecycle"):

- The serving path is NEVER touched by a failed retrain or a rejected
  canary: candidates are published with the registry's ``candidate``
  stage (invisible to enumeration/poll/default-load), shadow scoring
  duplicates live dispatches without altering a single reply byte, and
  the only client-visible transition is the existing hot-reload swap
  after :meth:`ModelRegistry.promote`.
- Retrain failures retry with the checkpoint-retries recipe: jittered
  doubling backoff, scheduled (never slept) on the tick loop;
  exhaustion quarantines the attempt and opens a cooldown.
- Post-promotion probation: a breaker trip, a drift alarm on the new
  version, or a mean-score regression beyond ``health_regression_scale
  x convergence_epsilon`` rolls back to the pinned prior version
  (re-published as newest; bit-identical scoring by the npz
  round-trip), quarantines the bad candidate with a reason file, and
  opens a cooldown.
- Every transition is a ``lifecycle`` telemetry event (rev v2.6) with
  the gate values that drove it.
"""

from __future__ import annotations

import json
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import telemetry
from ..serving.registry import ModelRegistry, RegistryError, ServedModel
from ..telemetry.sketch import SCORE_BOUNDS, StreamSketch, ks, psi
from ..testing import faults


class LifecycleError(RuntimeError):
    """A lifecycle policy or transition is invalid."""


# Policy knob -> default. One flat table so from_dict can reject typos
# loudly (an ignored knob in a promotion policy is a silent outage).
_DEFAULTS: Dict[str, Any] = {
    # Routes to manage; [] = every model the registry serves.
    "models": [],
    # Consecutive drift alarms on a route before a retrain starts.
    "debounce_alarms": 2,
    # Seconds after a quarantine / rollback / watch-pass before the
    # next alarm may start a retrain.
    "cooldown_s": 300.0,
    # Per-model cap on spooled request rows (the fallback data source).
    "spool_rows": 4096,
    # Holdout slice (taken from the tail of the retrain data) for the
    # immediate canary gates.
    "holdout_rows": 256,
    "retrain": {
        # BIN dataset path; null -> refit from spooled request rows.
        "data": None,
        # Stepwise minibatch-EM steps (min_iters == max_iters).
        "steps": 30,
        "minibatch_size": 0,
        "chunk_size": 1024,
        # Rows required before a refit is attempted at all.
        "min_rows": 64,
        # Cap on rows read from the data file.
        "max_rows": 65536,
        # Jittered doubling backoff (checkpoint_retries recipe).
        "retries": 3,
        "backoff_base_s": 0.5,
        "backoff_max_s": 30.0,
    },
    "canary": {
        # Score-distribution gates, candidate vs incumbent on the
        # holdout slice (telemetry/sketch.py ladder).
        "max_psi": 0.5,
        "max_ks": 0.5,
        # Duplicate-dispatch shadow window: live ticks scored by BOTH
        # versions before promotion. 0 = skip (offline mode).
        "shadow_ticks": 3,
        # Mean-score regression tolerance factor: tolerance =
        # health_regression_scale x the refit's convergence epsilon
        # (config.py health_regression_scale semantics).
        "health_regression_scale": 10.0,
    },
    "promote": {
        # Retries for a torn promotion (promote_torn semantics).
        "retries": 3,
    },
    "watch": {
        # Probation: whichever of ticks/seconds elapses LAST closes the
        # window (a quiet route must not pass probation by silence).
        "probation_ticks": 20,
        "probation_s": 600.0,
        # Rows required before the watch score gate is consulted.
        "min_rows": 32,
    },
}


def _merged(defaults: Dict[str, Any], overrides: Dict[str, Any],
            where: str) -> Dict[str, Any]:
    out = dict(defaults)
    for key, val in overrides.items():
        if key not in defaults:
            raise LifecycleError(
                f"unknown lifecycle policy knob {where}{key!r} "
                f"(expected one of {sorted(defaults)})")
        if isinstance(defaults[key], dict):
            if not isinstance(val, dict):
                raise LifecycleError(
                    f"policy knob {where}{key!r} must be an object")
            out[key] = _merged(defaults[key], val, f"{where}{key}.")
        else:
            out[key] = val
    return out


class LifecyclePolicy:
    """Validated lifecycle policy (the ``--lifecycle policy.json``)."""

    def __init__(self, spec: Optional[Dict[str, Any]] = None):
        merged = _merged(_DEFAULTS, spec or {}, "")
        self.models: List[str] = [str(m) for m in merged["models"]]
        self.debounce_alarms = max(1, int(merged["debounce_alarms"]))
        self.cooldown_s = float(merged["cooldown_s"])
        self.spool_rows = max(0, int(merged["spool_rows"]))
        self.holdout_rows = max(1, int(merged["holdout_rows"]))
        self.retrain = merged["retrain"]
        self.canary = merged["canary"]
        self.promote = merged["promote"]
        self.watch = merged["watch"]
        if self.retrain["min_rows"] < 1:
            raise LifecycleError("retrain.min_rows must be >= 1")
        if self.retrain["steps"] < 1:
            raise LifecycleError("retrain.steps must be >= 1")

    @classmethod
    def from_file(cls, path: str) -> "LifecyclePolicy":
        try:
            with open(path, encoding="utf-8") as f:
                spec = json.load(f)
        except (OSError, ValueError) as e:
            raise LifecycleError(
                f"cannot read lifecycle policy {path!r}: {e}") from e
        if not isinstance(spec, dict):
            raise LifecycleError(
                f"lifecycle policy {path!r} must hold a JSON object")
        return cls(spec)


def _jitter(name: str, attempt: int) -> float:
    """+-25% deterministic jitter, the breaker/checkpoint recipe, seeded
    per (route, attempt) so concurrent controllers spread."""
    seed = hash((name, int(attempt))) & 0xFFFFFFFF
    return 0.75 + 0.5 * random.Random(seed).random()


class _Route:
    """Mutable per-model lifecycle state (tick-loop thread only)."""

    __slots__ = ("state", "alarms", "attempt", "next_attempt_t",
                 "cooldown_until", "spool", "spool_count",
                 "candidate_version", "candidate", "tolerance", "gates",
                 "shadow_left", "shadow", "prior_version",
                 "promote_attempts", "watch_deadline", "watch_ticks_left",
                 "baseline_mean", "watch_sum", "watch_count", "violation",
                 "breaker_trips0")

    def __init__(self):
        self.state = "idle"
        self.alarms = 0
        self.attempt = 0
        self.next_attempt_t = 0.0
        self.cooldown_until = 0.0
        self.spool: List[np.ndarray] = []
        self.spool_count = 0
        self._clear_candidate()

    def _clear_candidate(self):
        self.candidate_version = None
        self.candidate = None
        self.tolerance = 0.0
        self.gates = {}
        self.shadow_left = 0
        self.shadow = None
        self.prior_version = None
        self.promote_attempts = 0
        self.watch_deadline = 0.0
        self.watch_ticks_left = 0
        self.baseline_mean = None
        self.watch_sum = 0.0
        self.watch_count = 0
        self.violation = None
        self.breaker_trips0 = None


class LifecycleController:
    """The closed-loop state machine over one registry.

    Serve mode: constructed by ``serve_main --lifecycle`` and bound to
    the :class:`GMMServer`; ``observe_alarm`` is fed by the drift
    flush, ``observe_dispatch`` by every answered coalesced dispatch,
    and ``on_tick`` runs between ticks on the tick-loop thread (so all
    state is single-threaded by construction). Offline mode: no server
    -- alarms come from a recorded stream, shadow windows are skipped
    (``shadow_ticks`` forced to 0), and promotion still flips the
    registry so the NEXT serve run adopts the candidate.
    """

    def __init__(self, registry: ModelRegistry, policy: LifecyclePolicy,
                 *, server=None, device: str = "cuda"):
        self._registry = registry
        self._policy = policy
        self._server = server
        # The torch device of an offline controller's refits and scoring;
        # a bound server's own device replaces it.
        self._device = str(device)
        self._routes: Dict[str, _Route] = {}
        self._executors: Dict[tuple, Any] = {}
        # Rollup counters (serve_summary / offline verdicts).
        self.counts = {"retrains": 0, "canaries": 0, "promotes": 0,
                       "rollbacks": 0, "quarantines": 0}

    def bind(self, server) -> None:
        self._server = server

    @property
    def device(self) -> str:
        """The device refits and scoring run on: the bound server's."""
        if self._server is not None:
            return self._server.device
        return self._device

    @property
    def policy(self) -> LifecyclePolicy:
        return self._policy

    def manages(self, name: str) -> bool:
        models = self._policy.models
        return not models or name in models

    def stats(self) -> Dict[str, Any]:
        return dict(self.counts,
                    routes={n: r.state for n, r in self._routes.items()})

    # -- inputs (tick-loop thread) ---------------------------------------

    def observe_alarm(self, name: str, version: Optional[int],
                      stats: Optional[Dict[str, Any]] = None,
                      now: Optional[float] = None) -> None:
        """One ``drift_alarm`` for a served route (the drift flush's
        feed). Debounces in idle, is a rollback trigger in watch, and
        is ignored during cooldown/retrain/canary (the loop is already
        reacting)."""
        if not self.manages(name):
            return
        now = time.monotonic() if now is None else now
        r = self._routes.setdefault(name, _Route())
        if r.state == "watch":
            r.violation = r.violation or "drift_alarm"
            return
        if r.state != "idle" or now < r.cooldown_until:
            return
        r.alarms += 1
        if r.alarms >= self._policy.debounce_alarms:
            r.state = "retrain"
            r.attempt = 0
            r.next_attempt_t = now  # first attempt on the next tick
            self._emit("retrain", name, outcome="scheduled",
                       alarms=r.alarms, version=version)

    def observe_dispatch(self, name: str, m: ServedModel, rows, logz
                         ) -> None:
        """One answered coalesced dispatch for route ``(name, None)``.

        ``rows`` are CENTERED by the incumbent's data_shift (the
        executor's input), ``logz`` the per-row scores it returned.
        Feeds the request-row spool, the canary duplicate-dispatch
        shadow window, and the watch score gate. Never mutates its
        inputs -- replies are computed before this hook runs.
        """
        if not self.manages(name):
            return
        r = self._routes.setdefault(name, _Route())
        rows = np.asarray(rows, np.float64)
        logz = np.asarray(logz, np.float64).reshape(-1)
        if rows.size == 0:
            return
        original = rows + np.asarray(m.data_shift, np.float64)
        self._spool(r, original)
        if r.state == "canary" and r.shadow_left > 0 \
                and r.candidate is not None:
            cand_logz = self._score(r.candidate, original)
            sh = r.shadow
            sh["inc_sum"] += float(logz.sum())
            sh["cand_sum"] += float(np.nan_to_num(cand_logz,
                                                  nan=0.0).sum())
            sh["rows"] += int(logz.size)
            sh["nonfinite"] += int(np.count_nonzero(
                ~np.isfinite(cand_logz)))
            r.shadow_left -= 1
        elif r.state == "watch":
            r.watch_sum += float(logz.sum())
            r.watch_count += int(logz.size)
            r.watch_ticks_left = max(0, r.watch_ticks_left - 1)

    # -- the state machine -----------------------------------------------

    def on_tick(self, now: Optional[float] = None) -> None:
        """Advance every route; cheap when nothing is scheduled."""
        now = time.monotonic() if now is None else now
        for name, r in self._routes.items():
            try:
                self._tick_route(name, r, now)
            except RegistryError as e:
                # Registry trouble mid-transition must never take down
                # the tick loop; the route retries or quarantines on a
                # later tick.
                self._emit("retrain" if r.state == "retrain"
                           else r.state, name, outcome="error",
                           reason=str(e)[:200])

    def _tick_route(self, name: str, r: _Route, now: float) -> None:
        if r.state == "cooldown":
            if now >= r.cooldown_until:
                r.state = "idle"
                r.alarms = 0
            return
        if r.state == "retrain" and now >= r.next_attempt_t:
            self._attempt_retrain(name, r, now)
        elif r.state == "canary" and r.shadow_left <= 0:
            self._finish_canary(name, r, now)
        elif r.state == "watch":
            self._tick_watch(name, r, now)

    # -- retrain ---------------------------------------------------------

    def _attempt_retrain(self, name: str, r: _Route, now: float) -> None:
        r.attempt += 1
        try:
            incumbent = self._incumbent(name)
            data = self._training_rows(name, r, incumbent)
            if faults.take("retrain_fail", model=name) is not None:
                raise LifecycleError("injected retrain_fail fault")
            result, epsilon = self._refit(incumbent, data)
            vc = self._registry.save(
                name, result, config=None,
                covariance_type=incumbent.covariance_type,
                source="lifecycle", stage="candidate",
                extra={"retrain_of": int(incumbent.version)})
        except Exception as e:  # noqa: BLE001 -- any refit failure retries
            rt = self._policy.retrain
            if r.attempt > int(rt["retries"]):
                self._quarantine_attempt(name, r, now,
                                         reason="retrain_exhausted",
                                         error=str(e)[:200])
                return
            backoff = min(float(rt["backoff_base_s"])
                          * (2.0 ** (r.attempt - 1)),
                          float(rt["backoff_max_s"]))
            backoff *= _jitter(name, r.attempt)
            r.next_attempt_t = now + backoff
            self._emit("retrain", name, outcome="retry",
                       attempt=r.attempt, reason=str(e)[:200],
                       retry_in_s=round(backoff, 4))
            return
        r.candidate_version = int(vc)
        r.candidate = self._registry.load(name, int(vc))
        r.prior_version = int(incumbent.version)
        cn = self._policy.canary
        r.tolerance = (float(cn["health_regression_scale"])
                       * float(epsilon))
        self.counts["retrains"] += 1
        self._emit("retrain", name, outcome="published",
                   attempt=r.attempt, candidate_version=int(vc),
                   version=int(incumbent.version))
        # Immediate gates on the holdout slice; the shadow window (live
        # traffic) follows only if these pass.
        gates = self._holdout_gates(name, incumbent, r.candidate,
                                    data, r.tolerance)
        r.gates = gates
        self.counts["canaries"] += 1
        if not gates["pass"]:
            self._emit("canary", name, outcome="rejected",
                       candidate_version=int(vc), **gates["fields"])
            self._quarantine_candidate(name, r, now,
                                       reason="canary_gates",
                                       gates=gates["fields"])
            return
        shadow_ticks = (int(cn["shadow_ticks"])
                        if self._server is not None else 0)
        r.shadow_left = shadow_ticks
        r.shadow = {"inc_sum": 0.0, "cand_sum": 0.0, "rows": 0,
                    "nonfinite": 0, "ticks": shadow_ticks}
        r.state = "canary"

    def _training_rows(self, name: str, r: _Route,
                       incumbent: ServedModel) -> np.ndarray:
        rt = self._policy.retrain
        if rt["data"]:
            from ..io.readers import FileSource

            src = FileSource(str(rt["data"]))
            n = min(int(src.shape[0]), int(rt["max_rows"]))
            rows = np.asarray(src.read_range(0, n), np.float64)
        elif r.spool_count:
            rows = np.concatenate(r.spool, axis=0)
        else:
            rows = np.zeros((0, incumbent.d))
        if rows.shape[0] < int(rt["min_rows"]):
            raise LifecycleError(
                f"retrain needs >= {rt['min_rows']} rows, have "
                f"{rows.shape[0]} (configure retrain.data or let the "
                "spool fill)")
        return rows

    def _refit(self, incumbent: ServedModel, rows: np.ndarray):
        """Shadow minibatch-EM refit warm-started from the served state.

        Returns ``(GMMResult, convergence_epsilon)``. The warm start
        hands the incumbent's means back in ORIGINAL data coordinates
        (the served state is centered by its own data_shift).
        """
        from ..config import GMMConfig
        from ..estimator import GaussianMixture

        rt = self._policy.retrain
        n = int(rows.shape[0])
        cfg = GMMConfig(
            stream_events=True,
            em_mode="minibatch",
            minibatch_size=int(rt["minibatch_size"]),
            chunk_size=max(32, min(int(rt["chunk_size"]), n)),
            min_iters=int(rt["steps"]),
            max_iters=int(rt["steps"]),
            dtype=incumbent.dtype,
            covariance_type=incumbent.covariance_type,
            device=self.device,
        )
        means0 = (np.asarray(incumbent.state.means, np.float64)
                  + np.asarray(incumbent.data_shift, np.float64))
        gm = GaussianMixture(incumbent.k, target_components=incumbent.k,
                             config=cfg, means_init=means0)
        gm.fit(rows)
        return gm.result_, float(gm.result_.epsilon)

    # -- canary ----------------------------------------------------------

    def _holdout_gates(self, name: str, incumbent: ServedModel,
                       candidate: ServedModel, data: np.ndarray,
                       tolerance: float) -> Dict[str, Any]:
        cn = self._policy.canary
        holdout = data[-min(len(data), self._policy.holdout_rows):]
        inc_scores = self._score(incumbent, holdout)
        cand_scores = self._score(candidate, holdout)
        mean_inc = float(np.mean(inc_scores))
        mean_cand = float(np.mean(cand_scores))
        cfg = faults.take("canary_regression", model=name)
        if cfg is not None:
            # Poison the SHADOW score only: the gate must reject with
            # zero client-visible change.
            mean_cand -= float(cfg.get("shift", 100.0 * (tolerance + 1)))
        inc_sk = StreamSketch(SCORE_BOUNDS).update(inc_scores)
        cand_sk = StreamSketch(SCORE_BOUNDS).update(cand_scores)
        g_psi = psi(inc_sk.buckets, cand_sk.buckets)
        g_ks = ks(inc_sk.buckets, cand_sk.buckets)
        regression = mean_inc - mean_cand
        ok = (np.isfinite(mean_cand)
              and g_psi <= float(cn["max_psi"])
              and g_ks <= float(cn["max_ks"])
              and regression <= tolerance)
        fields = {"psi": round(g_psi, 6), "ks": round(g_ks, 6),
                  "mean_incumbent": round(mean_inc, 6),
                  "mean_candidate": round(mean_cand, 6),
                  "regression": round(regression, 6),
                  "tolerance": round(tolerance, 6),
                  "shadow_rows": int(len(holdout))}
        return {"pass": bool(ok), "fields": fields,
                "mean_incumbent": mean_inc}

    def _finish_canary(self, name: str, r: _Route, now: float) -> None:
        sh = r.shadow or {"rows": 0, "ticks": 0, "nonfinite": 0,
                          "inc_sum": 0.0, "cand_sum": 0.0}
        fields = dict(r.gates.get("fields", {}))
        if sh["rows"]:
            mean_inc = sh["inc_sum"] / sh["rows"]
            mean_cand = sh["cand_sum"] / sh["rows"]
            regression = mean_inc - mean_cand
            fields.update(mean_incumbent=round(mean_inc, 6),
                          mean_candidate=round(mean_cand, 6),
                          regression=round(regression, 6),
                          shadow_rows=int(sh["rows"]),
                          shadow_ticks=int(sh["ticks"]))
            if sh["nonfinite"] or regression > r.tolerance:
                self._emit("canary", name, outcome="rejected",
                           candidate_version=r.candidate_version,
                           reason=("shadow_nonfinite" if sh["nonfinite"]
                                   else "shadow_regression"), **fields)
                self._quarantine_candidate(name, r, now,
                                           reason="shadow_window",
                                           gates=fields)
                return
            r.baseline_mean = mean_inc
        else:
            r.baseline_mean = r.gates.get("mean_incumbent")
        self._emit("canary", name, outcome="pass",
                   candidate_version=r.candidate_version, **fields)
        self._promote(name, r, now)

    # -- promote ---------------------------------------------------------

    def _promote(self, name: str, r: _Route, now: float) -> None:
        r.promote_attempts += 1
        try:
            self._registry.promote(name, int(r.candidate_version))
        except RegistryError as e:
            # Torn or failed flip: the candidate is still invisible and
            # the flip retryable; exhaustion quarantines it.
            self._emit("promote", name, outcome="torn",
                       candidate_version=r.candidate_version,
                       attempt=r.promote_attempts,
                       reason=str(e)[:200])
            if r.promote_attempts > int(self._policy.promote["retries"]):
                self._quarantine_candidate(name, r, now,
                                           reason="promote_exhausted")
            return
        self.counts["promotes"] += 1
        self._emit("promote", name, outcome="promoted",
                   from_version=r.prior_version,
                   to_version=r.candidate_version,
                   attempt=r.promote_attempts)
        self._reload()
        if self._server is None:
            # Offline: no live traffic to watch -- the NEXT serve run
            # adopts the promoted version and its own drift plane /
            # breaker provide the probation signals.
            self._cooldown(name, r, now)
            return
        w = self._policy.watch
        r.state = "watch"
        r.violation = None
        r.watch_sum = 0.0
        r.watch_count = 0
        r.watch_ticks_left = int(w["probation_ticks"])
        r.watch_deadline = now + float(w["probation_s"])
        r.alarms = 0
        if self._server is not None:
            r.breaker_trips0 = self._server.breaker.stats()["trips"]

    # -- watch / rollback ------------------------------------------------

    def _tick_watch(self, name: str, r: _Route, now: float) -> None:
        w = self._policy.watch
        if self._server is not None and r.breaker_trips0 is not None:
            if self._server.breaker.stats()["trips"] > r.breaker_trips0:
                r.violation = r.violation or "breaker_trip"
        if (r.violation is None and r.watch_count >= int(w["min_rows"])
                and r.baseline_mean is not None):
            mean_watch = r.watch_sum / r.watch_count
            if (r.baseline_mean - mean_watch) > r.tolerance:
                r.violation = "score_regression"
        if r.violation is not None:
            self._emit("watch", name, outcome="violated",
                       version=r.candidate_version, reason=r.violation)
            self._rollback(name, r, now)
            return
        if r.watch_ticks_left <= 0 and now >= r.watch_deadline:
            self._emit("watch", name, outcome="passed",
                       version=r.candidate_version,
                       shadow_rows=r.watch_count)
            self._cooldown(name, r, now)

    def _rollback(self, name: str, r: _Route, now: float) -> None:
        bad, prior = int(r.candidate_version), int(r.prior_version)
        new_v = self._registry.rollback(
            name, to_version=prior, bad_version=bad,
            reason={"reason": r.violation,
                    "baseline_mean": r.baseline_mean,
                    "watch_mean": (r.watch_sum / r.watch_count
                                   if r.watch_count else None)})
        self.counts["rollbacks"] += 1
        self.counts["quarantines"] += 1
        self._emit("rollback", name, from_version=bad, to_version=new_v,
                   version=prior, reason=r.violation,
                   tolerance=round(r.tolerance, 6))
        self._emit("quarantine", name, version=bad, reason=r.violation)
        self._reload()
        self._cooldown(name, r, now)

    # -- shared helpers --------------------------------------------------

    def _quarantine_attempt(self, name: str, r: _Route, now: float, *,
                            reason: str, error: str) -> None:
        """Retrain exhausted: no artifact exists to quarantine, but the
        ATTEMPT is -- the route stops retrying and cools down, and the
        health-shaped event makes the exhaustion visible."""
        self.counts["quarantines"] += 1
        self._emit("quarantine", name, reason=f"{reason}: {error}",
                   attempt=r.attempt, flag_names=[reason],
                   cooldown_s=self._policy.cooldown_s)
        self._cooldown(name, r, now)

    def _quarantine_candidate(self, name: str, r: _Route, now: float, *,
                              reason: str, gates=None) -> None:
        self._registry.quarantine(
            name, int(r.candidate_version),
            dict({"reason": reason}, **({"gates": gates} if gates
                                        else {})))
        self.counts["quarantines"] += 1
        self._emit("quarantine", name, version=r.candidate_version,
                   reason=reason, cooldown_s=self._policy.cooldown_s)
        self._cooldown(name, r, now)

    def _cooldown(self, name: str, r: _Route, now: float) -> None:
        self._release_candidate(r)
        r._clear_candidate()
        r.state = "cooldown"
        r.alarms = 0
        r.attempt = 0
        r.cooldown_until = now + self._policy.cooldown_s

    def _release_candidate(self, r: _Route) -> None:
        if r.candidate is not None and self._server is not None:
            try:
                self._server._executor_for(r.candidate).release_state(
                    r.candidate.state)
            except Exception:
                pass

    def _incumbent(self, name: str) -> ServedModel:
        if self._server is not None:
            return self._server.resolve(name)
        return self._registry.load(name)

    def _reload(self) -> None:
        """Run the EXISTING hot-reload path (the only client-visible
        swap the lifecycle ever performs)."""
        if self._server is not None:
            self._server.maybe_reload()

    def _score(self, m: ServedModel, rows_original: np.ndarray
               ) -> np.ndarray:
        """Per-row log-likelihood of ``rows_original`` (original data
        coordinates) under ``m`` -- the shadow/gate scoring dispatch.
        Uses the server's executor cache when bound (sharing compiled
        kernels with live traffic), else a private one."""
        rows = (np.asarray(rows_original, np.float64)
                - np.asarray(m.data_shift, np.float64))
        if self._server is not None:
            ex = self._server._executor_for(m)
        else:
            key = (m.dtype, m.diag_only)
            ex = self._executors.get(key)
            if ex is None:
                from ..serving.executor import ScoringExecutor

                ex = ScoringExecutor(dtype=m.dtype,
                                     diag_only=m.diag_only,
                                     device=self.device)
                self._executors[key] = ex
        _, logz = ex.infer(m.state, rows, want="proba")
        return np.asarray(logz, np.float64).reshape(-1)

    def _spool(self, r: _Route, original_rows: np.ndarray) -> None:
        cap = self._policy.spool_rows
        if cap <= 0:
            return
        r.spool.append(np.array(original_rows, np.float64, copy=True))
        r.spool_count += int(original_rows.shape[0])
        while r.spool_count > cap and len(r.spool) > 1:
            dropped = r.spool.pop(0)
            r.spool_count -= int(dropped.shape[0])

    def _emit(self, phase: str, name: str, **fields) -> None:
        rec = telemetry.current()
        if not rec.active:
            return
        clean = {k: v for k, v in fields.items() if v is not None}
        rec.emit("lifecycle", model=name, phase=phase, **clean)
        rec.metrics.count(f"lifecycle_{phase}")
