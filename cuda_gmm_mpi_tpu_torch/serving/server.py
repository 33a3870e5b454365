"""Micro-batched scoring server: the ``gmm serve`` request loop.

The third serving layer (docs/SERVING.md): a JSONL request protocol over
stdin/stdout (default), a request file, or a UNIX socket, feeding a
micro-batching dispatcher that coalesces concurrent score requests into
ONE padded executor dispatch per tick and routes per-model.

Protocol -- one JSON object per line, one response line per request::

    {"id": 7, "model": "cells", "op": "score_samples", "x": [[...], ...]}
    -> {"id": 7, "ok": true, "model": "cells", "version": 2,
        "op": "score_samples", "n": 2, "result": [...],
        "latency_ms": 0.8}

``op`` is one of ``predict`` / ``predict_proba`` / ``score_samples`` /
``score`` (the estimator surface); ``version`` pins a registry version
(default: newest); ``{"op": "shutdown"}`` stops the server after
draining. Errors come back on the same id with ``ok: false`` and an
``error`` message -- a malformed request never kills the loop.

Micro-batching: requests arriving within one tick (``tick_s``) are
grouped by (model, version) and each group's rows are concatenated into
a single bucketed executor dispatch; per-request results are sliced back
out. All four ops ride the SAME 'proba' executable, so a mixed batch
(score + predict for one model) still coalesces into one dispatch --
the batched dispatch is bit-identical to per-request dispatches because
rows are independent through the per-event log-sum-exp (the coalescing
parity test, tests/test_serving.py).

Telemetry (stream rev v1.6, docs/OBSERVABILITY.md): ``serve_request``
per request, ``serve_batch`` per coalesced dispatch, and a closing
``serve_summary`` with QPS + latency percentiles + the MetricsRegistry
snapshot -- rendered by ``gmm report``.

Resilience layer (docs/ROBUSTNESS.md "Serving"; stream rev v1.7):

- **graceful drain** -- ``serve_main`` runs under ``supervisor.use()``,
  so SIGTERM/SIGINT and ``--max-runtime`` flip a drain instead of
  killing the loop: accepted requests are flushed, post-drain arrivals
  answer ``{"ok": false, "error": "shutting_down"}``, the
  ``serve_summary`` is emitted, and the process exits 75 (the fit CLI's
  ``EX_TEMPFAIL`` contract -- a batch scheduler restarts it blindly).
- **admission control** -- ``--max-queue-rows`` bounds the batching
  queue; arrivals past the bound shed with ``overloaded`` (queued
  survivors are unaffected). ``--default-deadline-ms`` / a per-request
  ``deadline_ms`` give each request a budget: a request whose budget
  expires while queued is rejected with ``deadline_expired`` BEFORE its
  dispatch, and the coalescing window never outwaits the first
  request's remaining budget.
- **registry hot-reload** -- an opt-in ``--reload-interval-s`` loop
  polls the registry (manifest mtime/size fingerprints) BETWEEN ticks
  on the loop thread, so an export while serving atomically swaps the
  ``version=None`` route with in-flight ticks finished on the old
  version; explicitly pinned versions keep serving bit-identically.
- **per-model circuit breakers** (serving/breaker.py) -- repeated
  route failures (non-finite scores via a cheap post-dispatch check,
  ``RegistryError``, executor errors) open the route: requests
  fast-fail with ``circuit_open`` while every other model keeps
  serving; a jittered backoff half-opens it and a healthy probe closes
  it.

Resilience rejections reply with a machine-readable token in ``error``
(``overloaded`` / ``shutting_down`` / ``deadline_expired`` /
``circuit_open``) and the human detail in ``detail``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import supervisor as supervisor_mod
from .. import telemetry
from ..telemetry import exporter as tl_exporter
from ..telemetry import profiling as tl_profiling
from ..telemetry import sketch as tl_sketch
from ..telemetry import spans as tl_spans
from ..testing import faults
from . import wire
from .breaker import CircuitBreakers
from .executor import (ScoringExecutor, device_or_raise,
                       executor_for_model)
from .registry import ModelRegistry, RegistryError, ServedModel

OPS = ("predict", "predict_proba", "score_samples", "score")


class _BadRequest(ValueError):
    """A request body that is not even a numeric row matrix (ragged
    rows, strings, a dict): answered with the machine token
    ``bad_request`` at ADMISSION -- HTTP 400 via ``status_for_error`` --
    instead of raising from the tick loop's decode."""


def _decode_x(raw) -> np.ndarray:
    """Decode one request's ``x`` into the ``[n, d]`` float64/float32
    block the dispatch concatenates. Accepts an ndarray (the binary
    wire path hands the ``np.frombuffer`` view straight through -- no
    JSON parsing, no Python lists) or anything ``np.asarray`` can make
    numeric. Raises :class:`_BadRequest` for non-numeric/ragged input
    and ``ValueError`` for shape/NaN violations (those keep their
    established error spellings)."""
    if isinstance(raw, np.ndarray):
        x = raw
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
    else:
        try:
            x = np.asarray(raw, np.float64)
        except (ValueError, TypeError) as e:
            raise _BadRequest(
                f"'x' is not a numeric [n, d] row matrix: {e}") from e
    if x.ndim == 1 and x.size:
        x = x[None, :]
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(
            f"'x' must be a non-empty [n, d] row list, got "
            f"shape {x.shape}")
    if not np.isfinite(x).all():
        raise ValueError("'x' contains NaN/Inf rows")
    return x

# Latency samples kept for the summary percentiles (bounded).
_LATENCY_CAP = 100_000

# Auto-stacking hysteresis (adaptive micro-batching): consecutive
# windows with a stackable same-family pair before stacked dispatch
# flips on, and consecutive windows without one before it flips off.
_AUTO_STACK_ON_STREAK = 3
_AUTO_STACK_OFF_STREAK = 16


class _Pending:
    """One in-flight request: the decoded body, where to reply, when it
    arrived, when its budget runs out (None = no deadline), and -- under
    the live plane (rev v2.1) -- its minted trace identity. ``x`` holds
    the admission-decoded row block when the front end decoded it on the
    reader thread (the data-plane fast path); None falls back to the
    tick loop's decode."""

    __slots__ = ("req", "reply", "t0", "deadline", "trace_id", "x")

    def __init__(self, req: dict, reply: Callable[[dict], None],
                 default_deadline_ms: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 x: Optional[np.ndarray] = None):
        self.req = req
        self.reply = reply
        self.t0 = time.perf_counter()
        self.trace_id = trace_id
        self.x = x
        ms = default_deadline_ms
        if isinstance(req, dict):
            raw = req.get("deadline_ms")
            if isinstance(raw, (int, float)) and not isinstance(raw, bool):
                ms = float(raw)
        self.deadline = (self.t0 + ms / 1e3) if ms and ms > 0 else None


class GMMServer:
    """Per-model routed, micro-batched scoring over a model registry."""

    def __init__(self, registry: ModelRegistry, *,
                 max_batch_rows: int = 8192, tick_s: float = 0.002,
                 tick_s_min: Optional[float] = None,
                 tick_s_max: Optional[float] = None,
                 executor: Optional[ScoringExecutor] = None,
                 warm: bool = True,
                 max_queue_rows: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_backoff_s: float = 1.0,
                 stack_models: bool = False,
                 trace_requests: bool = False,
                 drift_interval_s: Optional[float] = None,
                 drift_psi_threshold: Optional[float] = 0.2,
                 autotune: str = "off",
                 tuning_db: Optional[str] = None,
                 lifecycle=None,
                 device: str = "cuda"):
        if autotune not in ("off", "db"):
            raise ValueError(
                f"serving autotune must be 'off' or 'db', got {autotune!r}"
                " (the probe rung belongs to `gmm tune`, not a live "
                "scoring loop)")
        # The executors' torch device: 'cuda' by default, 'cpu' when
        # asked; without a GPU 'cuda' raises here, not at the first
        # request.
        self._device = str(device_or_raise(device))
        # Profile-guided executor geometry (tuning/): 'db' resolves each
        # served family's min/max event-block bounds from the tuning
        # database (the nearest recorded serve row of this device; static
        # defaults otherwise) and emits one `tune` event per decision on
        # the serve stream. S1 keeps a row's bits whatever its block, so
        # replies are byte-identical to 'off'. 'off' keeps the hand-set
        # defaults and a byte-identical stream.
        self._autotune = autotune
        self._tuning_db = tuning_db
        self._registry = registry
        self._max_batch_rows = max(1, int(max_batch_rows))
        self._tick_s = max(0.0, float(tick_s))
        # Adaptive micro-batching (docs/SERVING.md "Adaptive window"):
        # passing either bound replaces the FIXED gather window with a
        # bounded controller -- deep backlog snaps the window to
        # tick_s_min (dispatch immediately), an idle queue widens it
        # toward tick_s_max to coalesce more rows per executor call.
        # Off (both None, the default) keeps the fixed tick_s path and
        # a byte-identical stream.
        self._adaptive = (tick_s_min is not None
                          or tick_s_max is not None)
        if self._adaptive:
            lo = max(0.0, float(tick_s_min if tick_s_min is not None
                                else 0.0))
            hi = float(tick_s_max if tick_s_max is not None
                       else max(self._tick_s, lo))
            if hi < lo:
                raise ValueError(
                    f"adaptive window needs tick_s_min <= tick_s_max, "
                    f"got {lo}/{hi}")
            self._tick_min = lo
            self._tick_max = hi
            self._tick_cur = min(max(self._tick_s, lo), hi)
        self._arrivals = 0
        self._arrival_rate = 0.0
        self._last_window_t = time.perf_counter()
        self.window_adaptations = 0
        # Auto-stacking (adaptive mode): windows that repeatedly carry
        # >= 2 routes of one numeric family flip stacked dispatch on
        # without --stack-models; sustained single-family windows flip
        # it back off.
        self._auto_stack = False
        self._stack_streak = 0
        self._unstack_streak = 0
        # Device-resident routes: dispatch-time state preparations that
        # missed the pinned plane (executor host_stagings delta), the
        # serve.host_staging observability counter.
        self.host_stagings = 0
        self._host_staging_seen = 0
        # Family executors are process-shared (executor_for_model) --
        # an embedded server must not inherit staging counts from the
        # estimator surface or a sibling server, so each executor's
        # count is baselined at adoption and reported as a delta.
        self._staging_base: Dict[int, int] = {}
        self._executor_override = executor
        if executor is not None:
            self._adopt_executor(executor)
        self._warm = bool(warm)
        self._models: Dict[Tuple[str, Optional[int]], ServedModel] = {}
        self._executors: Dict[tuple, ScoringExecutor] = {}
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = threading.Event()
        self._latencies: collections.deque = collections.deque(
            maxlen=_LATENCY_CAP)
        self._t_start = time.perf_counter()
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.errors = 0
        # -- resilience layer (docs/ROBUSTNESS.md "Serving") --
        self._max_queue_rows = (int(max_queue_rows)
                                if max_queue_rows else None)
        self._default_deadline_ms = (float(default_deadline_ms)
                                     if default_deadline_ms else None)
        self._adm_lock = threading.Lock()
        self._queued_rows = 0  # rows admitted but not yet popped
        self._draining = threading.Event()
        self.drain_reason: Optional[str] = None
        self.breaker = CircuitBreakers(threshold=breaker_threshold,
                                       backoff_base_s=breaker_backoff_s)
        # name -> (version, fingerprint) of the newest registry version
        # observed; maybe_reload polls against it.
        self._route_snapshot: Dict[str, Tuple[int, str]] = {}
        self.shed = 0
        self.deadline_expired = 0
        self.reloads = 0
        self.breaker_fastfails = 0
        # Cross-model stacked dispatch (docs/TENANCY.md "Serving the
        # fleet"): one tick's groups for DIFFERENT models of one numeric
        # family coalesce into a single stacked executable call
        # (ScoringExecutor.infer_stacked) -- bit-identical to per-model
        # dispatches, parity-tested. Opt-in (--stack-models).
        self._stack_models = bool(stack_models)
        self.stacked_batches = 0
        self.stacked_fallthrough = 0
        # Live plane (rev v2.1; --metrics-port): mint a trace_id per
        # admitted request (echoed in its response + tagged on its
        # serve_request record) and emit spans around the route path.
        # Off by default -- responses and streams stay byte-identical.
        self._trace_requests = bool(trace_requests)
        # Drift observability plane (stream rev v2.4; --drift-interval-s,
        # docs/OBSERVABILITY.md "Drift detection"): per-(model, version)
        # windowed sketches of request scores + argmax-assignment
        # occupancy, compared against each version's TRAINING envelope
        # (registry envelope.json) every interval as a `drift` event
        # (PSI / KS / occupancy L1). Sampling is FREE by construction:
        # every op already rides the one 'proba' dispatch, so the
        # window folds in the (w, logz) block the answers are sliced
        # from -- no extra executor call, no new compiles. PSI past
        # ``drift_psi_threshold`` raises a `drift_alarm` event --
        # observational only: it never trips the circuit breaker. Off
        # by default -- responses, streams, and /metrics stay
        # byte-identical (the plane-off contract).
        self._drift_interval_s = (float(drift_interval_s)
                                  if drift_interval_s else None)
        self._drift_psi_threshold = (
            float(drift_psi_threshold)
            if drift_psi_threshold is not None else None)
        # (name, actual version) -> {"sketch", "occ", "env", "version"}
        self._drift_windows: Dict[Tuple[str, int], dict] = {}
        self._drift_last: Dict[str, dict] = {}  # "name@v" -> last stats
        self.drift_events = 0
        self.drift_alarms = 0
        # Closed-loop lifecycle (--lifecycle policy.json,
        # lifecycle/controller.py): drift alarms feed its debounce,
        # answered dispatches feed its spool / canary shadow window /
        # watch gate, and run_loop ticks its state machine between
        # coalesced dispatches -- all on the tick-loop thread. None (the
        # default) keeps responses, streams, and /metrics byte-identical.
        self._lifecycle = lifecycle
        if lifecycle is not None:
            lifecycle.bind(self)

    @property
    def device(self) -> str:
        """The torch device the executors score on."""
        return self._device

    # -- model / executor resolution ------------------------------------

    def resolve(self, name: str, version: Optional[int] = None
                ) -> ServedModel:
        """The (cached) served model for one (name, version) route.

        ``version=None`` pins the newest version at first use; with the
        opt-in hot-reload loop (``--reload-interval-s``,
        :meth:`maybe_reload`) a later export atomically re-pins that
        default route to the new version between ticks. Explicit
        versions stay pinned forever."""
        key = (name, version)
        m = self._models.get(key)
        if m is None:
            m = self._registry.load(name, version)
            self._models[key] = m
            self._models.setdefault((name, m.version), m)
            if version is None:
                fp = self._registry.latest_fingerprint(name)
                if fp is not None:
                    self._route_snapshot[name] = fp
            # Device-resident route: place the prepared state ONCE at
            # route-prepare time; every later dispatch hits the
            # resident handle (executor.pin_state) instead of
            # re-placing leaves per tick. Released on hot-reload
            # exactly as the dispatch memo is (maybe_reload ->
            # release_state).
            ex = self._executor_for(m)
            ex.pin_state(m.state)
            if self._warm:
                ex.warmup(m.state)
        return m

    def maybe_reload(self) -> List[dict]:
        """Poll the registry and swap every ``version=None`` route whose
        model grew a new readable version; returns the swap audit list.

        Runs on the TICK-LOOP THREAD between coalesced dispatches
        (run_loop's ``reload_interval_s``), which is the bit-parity
        guarantee: an in-flight tick always finishes on the version it
        resolved. The old version's prepared executor state is released
        (recomputable -- a pinned request re-prepares it) and its
        default-route breaker resets so the new version starts closed.
        """
        changed = self._registry.poll(self._route_snapshot)
        swaps: List[dict] = []
        rec = telemetry.current()
        for name, fp in sorted(changed.items()):
            self._route_snapshot[name] = fp
            cur = self._models.get((name, None))
            if cur is None:
                continue  # not an active default route; nothing pinned
            try:
                new_m = self._registry.load(name)
            except (RegistryError, OSError) as e:
                # The newest version is torn/unreadable: keep serving
                # the current one; the next poll retries.
                from ..utils.logging_ import get_logger

                get_logger().warning(
                    "hot-reload of %r skipped: %s", name, e)
                continue
            if new_m.version == cur.version:
                continue  # walk-back landed on the already-served version
            new_ex = self._executor_for(new_m)
            new_ex.pin_state(new_m.state)
            if self._warm:
                new_ex.warmup(new_m.state)
            self._models[(name, None)] = new_m  # the atomic route swap
            self._models.setdefault((name, new_m.version), new_m)
            self.breaker.reset((name, None))
            self._executor_for(cur).release_state(cur.state)
            self.reloads += 1
            swap = {"model": name, "from_version": cur.version,
                    "to_version": new_m.version}
            swaps.append(swap)
            if rec.active:
                rec.emit("serve_reload", fingerprint=fp[1], **swap)
                rec.metrics.count("serve_reloads")
        return swaps

    def _executor_for(self, m: ServedModel) -> ScoringExecutor:
        if self._executor_override is not None:
            return self._executor_override
        key = (m.dtype, m.diag_only)
        ex = self._executors.get(key)
        if ex is None:
            kw = {}
            if self._autotune == "db":
                from ..tuning import resolve_serving_blocks

                blocks, _ = resolve_serving_blocks(
                    m.dtype, m.diag_only, m.d, m.k,
                    tuning_db=self._tuning_db, device=self._device)
                kw.update(blocks)
            ex = self._executors[key] = executor_for_model(
                m, device=self._device, **kw)
            self._adopt_executor(ex)
        return ex

    def _adopt_executor(self, ex: ScoringExecutor) -> None:
        """Record the executor's host_stagings at adoption: stagings
        that predate this server are other surfaces' traffic, not this
        route plane's fallbacks."""
        self._staging_base.setdefault(
            id(ex), ex.stats().get("host_stagings", 0))

    def executor_stats(self) -> Dict[str, int]:
        """Aggregated executor counters across every family served;
        ``host_stagings`` is since-adoption (process-shared executors
        carry other surfaces' counts)."""
        execs = ([self._executor_override] if self._executor_override
                 else list(self._executors.values()))
        tot: Dict[str, int] = {}
        for ex in execs:
            base = self._staging_base.get(id(ex), 0)
            for k, v in ex.stats().items():
                if k == "host_stagings":
                    v -= base
                tot[k] = tot.get(k, 0) + v
        return tot

    # -- request handling ------------------------------------------------

    def handle_requests(self, requests: List[dict], *,
                        coalesce: bool = True) -> List[dict]:
        """Synchronous convenience: score a request list, return the
        responses in request order. ``coalesce=False`` dispatches one
        request at a time (the parity baseline the micro-batch is tested
        against)."""
        responses: List[Optional[dict]] = [None] * len(requests)
        pendings = []
        for i, req in enumerate(requests):
            def reply(resp, _i=i):
                responses[_i] = resp
            pendings.append(_Pending(req, reply,
                                     trace_id=self._mint_trace_id()))
        if coalesce:
            self._process(pendings)
        else:
            for p in pendings:
                self._process([p])
        return [r for r in responses if r is not None]

    def _mint_trace_id(self) -> Optional[str]:
        return tl_spans.mint_trace_id() if self._trace_requests else None

    @contextlib.contextmanager
    def _route_trace(self, name: str, items=None):
        """Span scope for one route's dispatch (rev v2.1): activates a
        trace -- joining the first request's minted trace_id so a client
        holding that id finds the server-side spans -- and opens the
        ``serve_route`` root span. No-op unless trace_requests is on."""
        if not self._trace_requests:
            yield
            return
        tid = None
        if items:
            tid = getattr(items[0][0], "trace_id", None)
        with tl_spans.trace(tid), tl_spans.span("serve_route", model=name):
            yield

    def live_gauges(self) -> Dict[str, float]:
        """Point-in-time server gauges for the /metrics exporter (rev
        v2.1). Reads only python-side counters -- safe to call from the
        exporter's HTTP thread while the tick loop dispatches."""
        ex = self.executor_stats()
        lookups = ex.get("hits", 0) + ex.get("misses", 0)
        br = self.breaker.stats()
        # Drift gauges (rev v2.4) appear ONLY when the drift plane is
        # on: a drift-off server's /metrics text stays byte-identical.
        drift: Dict[str, float] = {}
        if self._drift_interval_s is not None:
            last = list(self._drift_last.values())
            drift = {
                "gmm_drift_psi": float(max(
                    (r["psi"] for r in last), default=0.0)),
                "gmm_drift_ks": float(max(
                    (r["ks"] for r in last), default=0.0)),
                "gmm_drift_events_total": float(self.drift_events),
                "gmm_drift_alarms_total": float(self.drift_alarms),
            }
        # Adaptive-window gauges appear ONLY when the controller is on:
        # a fixed-tick server's /metrics text stays byte-identical.
        window: Dict[str, float] = {}
        if self._adaptive:
            window = {
                "gmm_serve_window_ms": float(
                    round(self._tick_cur * 1e3, 4)),
                "gmm_serve_window_adaptations": float(
                    self.window_adaptations),
                "gmm_serve_arrival_per_s": float(
                    round(self._arrival_rate, 3)),
                "gmm_serve_auto_stack": float(self._auto_stack),
            }
        return {
            **drift,
            **window,
            "gmm_serve_queue_rows": float(self._queued_rows),
            "gmm_serve_requests": float(self.requests),
            "gmm_serve_batches": float(self.batches),
            "gmm_serve_rows": float(self.rows),
            "gmm_serve_errors": float(self.errors),
            "gmm_serve_shed": float(self.shed),
            "gmm_serve_deadline_expired": float(self.deadline_expired),
            "gmm_serve_reloads": float(self.reloads),
            "gmm_serve_breaker_fastfails": float(self.breaker_fastfails),
            "gmm_serve_breaker_open_routes": float(br["open_routes"]),
            "gmm_serve_breaker_trips": float(br["trips"]),
            "gmm_serve_stacked_batches": float(self.stacked_batches),
            "gmm_serve_host_stagings": float(
                ex.get("host_stagings", 0)),
            "gmm_executor_pinned_states": float(
                ex.get("pinned_states", 0)),
            "gmm_serve_draining": float(self._draining.is_set()),
            "gmm_executor_cache_hit_rate": (
                float(ex.get("hits", 0)) / lookups if lookups else 0.0),
            "gmm_executor_live_executables": float(
                ex.get("live_executables", 0)),
            "gmm_executor_compiles": float(ex.get("compiles", 0)),
        }

    def _expire(self, p: _Pending) -> bool:
        """Reject ``p`` with ``deadline_expired`` when its budget ran
        out while queued (checked per coalesced tick, BEFORE dispatch --
        an expired request never costs an executor call)."""
        if p.deadline is None or time.perf_counter() <= p.deadline:
            return False
        waited_ms = (time.perf_counter() - p.t0) * 1e3
        deadline_ms = (p.deadline - p.t0) * 1e3
        self.deadline_expired += 1
        req = p.req if isinstance(p.req, dict) else {}
        rec = telemetry.current()
        if rec.active:
            rec.emit("serve_deadline",
                     deadline_ms=round(deadline_ms, 3),
                     waited_ms=round(waited_ms, 3),
                     model=req.get("model"), op=req.get("op"))
            rec.metrics.count("serve_deadline_expired")
        self._reply_error(
            p, "deadline_expired",
            detail=f"request budget of {deadline_ms:.1f} ms expired "
            f"after {waited_ms:.1f} ms in queue")
        return True

    def _process(self, pendings: List[_Pending]) -> None:
        """Group one tick's requests per (model, version) and dispatch
        each group as a single coalesced executor call."""
        groups: "collections.OrderedDict[tuple, list]" = \
            collections.OrderedDict()
        for p in pendings:
            req = p.req
            if not isinstance(req, dict):
                self._reply_error(p, "request is not a JSON object")
                continue
            if self._expire(p):
                continue
            raw_deadline = req.get("deadline_ms")
            if raw_deadline is not None and (
                    isinstance(raw_deadline, bool)
                    or not isinstance(raw_deadline, (int, float))):
                self._reply_error(p, "'deadline_ms' must be a number")
                continue
            op = req.get("op")
            if op == "shutdown":
                self._stop.set()
                self._reply(p, {"id": req.get("id"), "ok": True,
                                "op": "shutdown"})
                continue
            if op == "ping":
                self._reply(p, {"id": req.get("id"), "ok": True,
                                "op": "ping"})
                continue
            if op not in OPS:
                self._reply_error(
                    p, f"unknown op {op!r} (expected one of "
                    f"{', '.join(OPS)}, ping, shutdown)")
                continue
            name = req.get("model")
            version = req.get("version")
            if not isinstance(name, str):
                self._reply_error(p, "request needs a 'model' name")
                continue
            if version is not None and not isinstance(version, int):
                self._reply_error(p, "'version' must be an integer")
                continue
            x = p.x
            if x is None:
                # Front ends decode at admission (reader thread); this
                # is the fallback for direct handle_requests callers.
                try:
                    x = _decode_x(req.get("x"))
                except _BadRequest as e:
                    self._reply_error(p, "bad_request", detail=str(e))
                    continue
                except (ValueError, TypeError) as e:
                    self._reply_error(p, f"bad 'x': {e}")
                    continue
            groups.setdefault((name, version), []).append((p, x))
        if self._adaptive and not self._stack_models:
            self._observe_stacking(groups)
        stack = self._stack_models or (self._adaptive
                                       and self._auto_stack)
        if stack and len(groups) > 1:
            self._dispatch_stacked(list(groups.items()))
        else:
            for (name, version), items in groups.items():
                self._dispatch(name, version, items)

    # -- adaptive micro-batching (rev v2.8) ------------------------------

    def _emit_window(self, reason: str, *, prev_ms: Optional[float]
                     = None, queue_rows: int = 0, requests: int = 0,
                     stacked_auto: Optional[bool] = None,
                     streak: Optional[int] = None) -> None:
        """One ``serve_window`` record (stream rev v2.8) per controller
        adaptation: window moves and auto-stacking flips, rendered by
        ``gmm report`` and folded by ``gmm diff``."""
        self.window_adaptations += 1
        rec = telemetry.current()
        if not rec.active:
            return
        rec.emit(
            "serve_window",
            window_ms=round(self._tick_cur * 1e3, 4), reason=reason,
            arrival_per_s=round(self._arrival_rate, 3),
            queue_rows=int(queue_rows), requests=int(requests),
            **({"prev_window_ms": round(prev_ms * 1e3, 4)}
               if prev_ms is not None else {}),
            **({"stacked_auto": bool(stacked_auto)}
               if stacked_auto is not None else {}),
            **({"streak": int(streak)} if streak is not None else {}))
        rec.metrics.count("serve_window_adaptations")
        rec.metrics.gauge("serve.window_ms",
                          round(self._tick_cur * 1e3, 4))

    def _observe_window(self, requests: int) -> None:
        """The bounded window controller, run once per gathered batch:
        backlog left in the queue after a full gather snaps the next
        window to ``tick_s_min`` (a deep queue must dispatch
        immediately), a window that coalesced nothing widens toward
        ``tick_s_max`` (idle traffic can afford to wait for more rows
        per executor call). The window NEVER leaves [tick_s_min,
        tick_s_max] -- both moves clamp -- and the gather loop still
        bounds every window by the first request's deadline budget."""
        now = time.perf_counter()
        dt = now - self._last_window_t
        self._last_window_t = now
        arrived, self._arrivals = self._arrivals, 0
        if dt > 0:
            self._arrival_rate = (0.7 * self._arrival_rate
                                  + 0.3 * (arrived / dt))
        # Row accounting only runs under --max-queue-rows; the queue
        # depth (pending requests) is the always-on backlog signal.
        backlog = (self._queued_rows if self._max_queue_rows is not None
                   else self._queue.qsize())
        prev = self._tick_cur
        if backlog > 0:
            if prev > self._tick_min:
                self._tick_cur = self._tick_min
                self._emit_window("backlog", prev_ms=prev,
                                  queue_rows=backlog,
                                  requests=requests)
        elif requests <= 1:
            widened = min(self._tick_max,
                          max(prev * 2.0, self._tick_min,
                              self._tick_max / 64.0))
            if widened > prev:
                self._tick_cur = widened
                self._emit_window("idle", prev_ms=prev,
                                  queue_rows=backlog,
                                  requests=requests)

    def _observe_stacking(self, groups) -> None:
        """Auto-stacking streaks (adaptive mode, --stack-models off):
        a window carrying >= 2 routes of one numeric family (shared
        dtype x covariance structure x D -- the ``infer_stacked``
        admission rule) counts toward flipping stacked dispatch ON;
        sustained windows without such a pair flip it back OFF. Both
        flips emit ``serve_window`` so the controller's behavior is
        visible in ``gmm report`` / ``gmm diff``."""
        if len(groups) > 1 and self._window_stackable(groups):
            self._stack_streak += 1
            self._unstack_streak = 0
            if (not self._auto_stack
                    and self._stack_streak >= _AUTO_STACK_ON_STREAK):
                self._auto_stack = True
                self._emit_window("auto_stack_on", stacked_auto=True,
                                  streak=self._stack_streak,
                                  requests=sum(
                                      len(v) for v in groups.values()))
        elif groups:
            self._unstack_streak += 1
            self._stack_streak = 0
            if (self._auto_stack
                    and self._unstack_streak >= _AUTO_STACK_OFF_STREAK):
                self._auto_stack = False
                self._emit_window("auto_stack_off", stacked_auto=False,
                                  streak=self._unstack_streak,
                                  requests=sum(
                                      len(v) for v in groups.values()))

    def _window_stackable(self, groups) -> bool:
        """Whether this window's groups hold >= 2 already-resolved
        routes of one stacked family. Unresolved routes don't count --
        the check must stay free of registry IO on the tick loop."""
        fams: Dict[tuple, int] = {}
        for (name, version) in groups:
            m = self._models.get((name, version))
            if m is None:
                continue
            key = (m.dtype, m.diag_only, m.d)
            fams[key] = fams.get(key, 0) + 1
            if fams[key] >= 2:
                return True
        return False

    def _prepare_route(self, name: str, version: Optional[int],
                       items: List[Tuple[_Pending, np.ndarray]]):
        """The dispatch front half shared by the per-model and stacked
        paths: breaker admission, registry resolve, per-request D
        validation, and the shifted row block. Returns ``(m, good,
        rows, t0)`` or None when every request was already answered
        (fast-fail / resolve error / all-bad rows)."""
        with tl_spans.span("prepare", model=name):
            return self._prepare_route_inner(name, version, items)

    def _prepare_route_inner(self, name: str, version: Optional[int],
                             items: List[Tuple[_Pending, np.ndarray]]):
        rec = telemetry.current()
        t0 = time.perf_counter()
        route = (name, version)
        denial = self.breaker.admit(route)
        if denial is not None:
            self.breaker_fastfails += 1
            if rec.active:
                rec.metrics.count("serve_breaker_fastfails",
                                  len(items))
            for p, _ in items:
                self._reply_error(
                    p, "circuit_open", model=name,
                    detail=f"model {name!r}"
                    + (f" v{version}" if version is not None else "")
                    + " is failing; retry in "
                    f"{denial['retry_in_s']:.1f}s")
            return None
        try:
            m = self.resolve(name, version)
        except (RegistryError, OSError) as e:
            self.breaker.record_failure(route, "registry")
            for p, _ in items:
                self._reply_error(p, str(e), model=name)
            return None
        d = m.d
        bad, good = [], []
        for p, x in items:
            if x.shape[1] != d:
                bad.append((p, f"model {name!r} has D={d} but 'x' rows "
                            f"have D={x.shape[1]}"))
            else:
                good.append((p, x))
        for p, msg in bad:
            self._reply_error(p, msg, model=name)
        if not good:
            return None
        xs = [x for _, x in good]
        rows = np.concatenate(xs, axis=0).astype(
            np.dtype(m.dtype), copy=False)
        rows = rows - m.data_shift[None, :].astype(rows.dtype)
        slow = faults.take("serve_slow", model=name)
        if slow is not None:
            time.sleep(float(slow.get("ms", 0)) / 1e3)
        crash = faults.take(
            "worker_crash", model=name,
            worker=int(os.environ.get("GMM_SERVE_WORKER", "-1") or -1),
            gen=int(os.environ.get("GMM_SERVE_WORKER_GEN", "-1") or -1))
        if crash is not None:
            # Hard process death mid-dispatch (no flush, no summary, no
            # atexit) -- indistinguishable from a SIGKILL'd or OOM'd pool
            # worker, which is the point: the worker pool's sibling
            # retry + respawn arc (serving/pool.py) must contain exactly
            # this.
            os._exit(int(crash.get("exitcode", 9)))
        return m, good, rows, t0

    def _dispatch(self, name: str, version: Optional[int],
                  items: List[Tuple[_Pending, np.ndarray]]) -> None:
        """One coalesced dispatch: concatenate every request's rows,
        score once, slice per request, answer per op.

        Route failures -- RegistryError at resolve, an executor error,
        or non-finite scores (the cheap post-dispatch poison check) --
        feed the (model, version) circuit breaker; while its breaker is
        open the whole group fast-fails with ``circuit_open`` before any
        of that cost. Client-content errors (wrong D) never touch the
        breaker."""
        with self._route_trace(name, items):
            prep = self._prepare_route(name, version, items)
            if prep is None:
                return
            m, good, rows, t0 = prep
            ex = self._executor_for(m)
            compiles_before = ex.compile_count
            try:
                with tl_spans.span("dispatch", model=name), \
                        tl_profiling.watermark("serve_dispatch"):
                    w, logz = ex.infer(m.state, rows, want="proba")
            except Exception as e:  # executor/compile failure
                self.breaker.record_failure((name, version), "executor")
                for p, _ in good:
                    self._reply_error(p, f"dispatch failed: {e}",
                                      model=name)
                return
            compiled = ex.compile_count - compiles_before
            self._answer_route(name, version, m, good, rows, w, logz,
                               t0, compiled,
                               int(ex.padded_rows(rows.shape[0])))

    def _dispatch_stacked(self, routes) -> None:
        """Cross-model coalescing (docs/TENANCY.md "Serving the fleet"):
        one tick's per-(model, version) groups partition by numeric
        family -- shared executor (dtype x covariance structure) and D
        -- and each family of >= 2 routes scores through ONE stacked
        executable call (``ScoringExecutor.infer_stacked``; the solo
        sequence once per lane, so responses stay bit-identical to per-model
        dispatches). Per-route error isolation is unchanged: breaker
        admission, registry errors, and the non-finite poison check all
        stay per (model, version)."""
        with self._route_trace(
                "stacked", routes[0][1] if routes else None):
            self._dispatch_stacked_inner(routes)

    def _dispatch_stacked_inner(self, routes) -> None:
        preps = []
        for (name, version), items in routes:
            prep = self._prepare_route(name, version, items)
            if prep is not None:
                preps.append((name, version) + prep)
        families: "collections.OrderedDict[tuple, list]" = \
            collections.OrderedDict()
        singles = []
        fallthrough = 0
        for entry in preps:
            name, version, m, good, rows, t0 = entry
            ex = self._executor_for(m)
            if not ex.stackable_rows(rows.shape[0]):
                # Oversized group: it splits into max_block slices,
                # which the stacked layout does not model. COUNTED, not
                # silent -- its solo dispatch emits `serve_batch` with
                # `stacked` absent, and serve_summary.stacked_fallthrough
                # reconciles stacked_batches against dispatch counts.
                fallthrough += 1
                singles.append(entry)
            else:
                families.setdefault((id(ex), m.d), []).append(entry)
        if fallthrough:
            self.stacked_fallthrough += fallthrough
            rec_ft = telemetry.current()
            if rec_ft.active:
                rec_ft.metrics.count("serve_stacked_fallthrough",
                                     fallthrough)
        for fam in families.values():
            if len(fam) < 2:
                singles.extend(fam)
                continue
            ex = self._executor_for(fam[0][2])
            compiles_before = ex.compile_count
            try:
                with tl_spans.span("dispatch", stacked=len(fam)), \
                        tl_profiling.watermark("serve_dispatch"):
                    outs, padded = ex.infer_stacked(
                        [m.state for _, _, m, _, _, _ in fam],
                        [rows for _, _, _, _, rows, _ in fam])
            except Exception as e:
                for name, version, m, good, rows, t0 in fam:
                    self.breaker.record_failure((name, version),
                                                "executor")
                    for p, _ in good:
                        self._reply_error(p, f"dispatch failed: {e}",
                                          model=name)
                continue
            compiled = ex.compile_count - compiles_before
            self.stacked_batches += 1
            rec = telemetry.current()
            if rec.active:
                rec.metrics.count("serve_stacked_batches")
            for (name, version, m, good, rows, t0), (w, logz) in zip(
                    fam, outs):
                self._answer_route(name, version, m, good, rows, w,
                                   logz, t0, compiled, int(padded),
                                   stacked=len(fam))
        for name, version, m, good, rows, t0 in singles:
            ex = self._executor_for(m)
            compiles_before = ex.compile_count
            try:
                with tl_spans.span("dispatch", model=name), \
                        tl_profiling.watermark("serve_dispatch"):
                    w, logz = ex.infer(m.state, rows, want="proba")
            except Exception as e:
                self.breaker.record_failure((name, version), "executor")
                for p, _ in good:
                    self._reply_error(p, f"dispatch failed: {e}",
                                      model=name)
                continue
            compiled = ex.compile_count - compiles_before
            self._answer_route(name, version, m, good, rows, w, logz,
                               t0, compiled,
                               int(ex.padded_rows(rows.shape[0])))

    def _answer_route(self, name: str, version: Optional[int], m,
                      good, rows, w, logz, t0, compiled: int,
                      padded_rows: int,
                      stacked: Optional[int] = None) -> None:
        """The dispatch back half: poison check -> breaker verdict ->
        telemetry -> per-request slicing and replies (identical for
        per-model and stacked dispatches)."""
        with tl_spans.span("answer", model=name):
            self._answer_route_inner(name, version, m, good, rows, w,
                                     logz, t0, compiled, padded_rows,
                                     stacked)

    def _answer_route_inner(self, name: str, version: Optional[int], m,
                            good, rows, w, logz, t0, compiled: int,
                            padded_rows: int,
                            stacked: Optional[int] = None) -> None:
        rec = telemetry.current()
        if faults.take("serve_nan", model=name) is not None:
            w = np.full_like(w, np.nan)
            logz = np.full_like(logz, np.nan)
        if not np.isfinite(logz).all():
            # The poisoned-artifact containment: logz is [rows], so the
            # check is O(rows) against the O(rows x K x D^2) dispatch,
            # and every op's result derives from the same densities. In
            # a stacked call the check is PER LANE: one poisoned model
            # trips only its own route's breaker.
            self.breaker.record_failure((name, version), "non_finite")
            if rec.active:
                rec.metrics.count("serve_nonfinite_batches")
            for p, _ in good:
                self._reply_error(
                    p, "non_finite_scores", model=name,
                    detail=f"model {name!r} v{m.version} scored "
                    "non-finite densities; its route breaker counts "
                    "the failure")
            return
        self.breaker.record_success((name, version))
        if self._drift_interval_s is not None:
            self._drift_observe(name, m, w, logz)
        if self._lifecycle is not None and version is None:
            # Lifecycle feed: spools request rows and -- in a canary/watch
            # window -- shadow-scores THIS block under the candidate.
            # Replies are already computed from (w, logz) slices; the hook
            # reads, never mutates.
            self._lifecycle.observe_dispatch(name, m, rows, logz)
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.batches += 1
        self.rows += int(rows.shape[0])
        # Device-resident audit: any state preparation this dispatch
        # performed OUTSIDE the pinned plane is a fallback to
        # per-request host->device staging -- counted so it can never
        # be silent (the serve.host_staging diff gate).
        staged = self.executor_stats().get("host_stagings", 0)
        if staged > self._host_staging_seen:
            delta = staged - self._host_staging_seen
            self._host_staging_seen = staged
            self.host_stagings += delta
            if rec.active:
                rec.metrics.count("serve_host_staging", delta)
        if rec.active:
            rec.emit("serve_batch", model=name, version=m.version,
                     requests=len(good), rows=int(rows.shape[0]),
                     padded_rows=int(padded_rows),
                     wall_ms=round(wall_ms, 3), compiled=int(compiled),
                     **({"stacked": int(stacked)}
                        if stacked is not None else {}))
            rec.metrics.count("serve_batches")
            rec.metrics.count("serve_rows", int(rows.shape[0]))
            rec.metrics.count("serve_compiles", int(compiled))
            rec.metrics.observe("serve.batch_ms", wall_ms)
            rec.metrics.observe("serve.batch_rows", int(rows.shape[0]))
        start = 0
        for p, x in good:
            n = int(x.shape[0])
            wi = w[start:start + n, :m.k]
            zi = logz[start:start + n]
            start += n
            op = p.req["op"]
            if op == "predict":
                result: Any = np.argmax(wi, axis=1).tolist()
            elif op == "predict_proba":
                result = wi.tolist()
            elif op == "score_samples":
                result = zi.tolist()
            else:  # score
                result = float(np.mean(zi))
            self._reply(p, {
                "id": p.req.get("id"), "ok": True, "model": name,
                "version": m.version, "op": op, "n": n,
                "result": result,
            })

    # -- drift plane (rev v2.4) ------------------------------------------

    def _drift_observe(self, name: str, m, w, logz) -> None:
        """Fold one answered dispatch's (w, logz) block into the route's
        drift window. Zero-dispatch-cost by design: the block is the
        same host array the per-request answers are sliced from.
        Versions without a training envelope are skipped -- there is
        nothing to compare against (backfill with `gmm drift
        --rebuild-envelope`)."""
        env = m.envelope
        if not env or not env.get("score"):
            return
        key = (name, int(m.version))
        win = self._drift_windows.get(key)
        if win is None:
            # Window sketches adopt the ENVELOPE's bucket ladder, so
            # PSI/KS compare bucket-for-bucket by construction.
            win = self._drift_windows[key] = {
                "sketch": tl_sketch.StreamSketch(env["score"]["bounds"]),
                "occ": np.zeros(int(env.get("k", m.k)), np.int64),
                "env": env,
            }
        win["sketch"].update(logz)
        k = min(int(m.k), len(win["occ"]))
        win["occ"] += np.bincount(
            np.argmax(np.asarray(w)[:, :k], axis=1),
            minlength=len(win["occ"])).astype(np.int64)

    def flush_drift(self) -> List[dict]:
        """Close every non-empty drift window: emit one ``drift`` event
        per route (PSI / KS / occupancy L1 vs the training envelope),
        raise ``drift_alarm`` where PSI crossed the threshold, reset the
        windows, and return the stats list. Runs on the tick-loop thread
        (run_loop's drift timer) and once more at serve shutdown so a
        short-lived serve still reports its traffic. Observational only
        -- the breaker is never touched."""
        if self._drift_interval_s is None:
            return []
        rec = telemetry.current()
        out: List[dict] = []
        for (name, version), win in self._drift_windows.items():
            sk = win["sketch"]
            if sk.count == 0:
                continue
            stats = tl_sketch.compare_to_envelope(win["env"], sk,
                                                  win["occ"])
            thr = self._drift_psi_threshold
            alarm = thr is not None and stats["psi"] > thr
            self.drift_events += 1
            row = dict(stats, model=name, version=int(version),
                       alarm=bool(alarm))
            self._drift_last[f"{name}@{version}"] = row
            out.append(row)
            if rec.active:
                rec.emit(
                    "drift", model=name, version=int(version),
                    alarm=bool(alarm),
                    # The window's raw mergeable summary rides along so
                    # `gmm drift` can re-aggregate a recorded stream
                    # offline at any window granularity.
                    score_sketch=sk.to_dict(),
                    occupancy=[int(c) for c in win["occ"]],
                    train_rows=int(win["env"]["score"].get("count", 0)),
                    **({"threshold": thr} if thr is not None else {}),
                    **stats)
                rec.metrics.count("drift_windows")
                rec.metrics.series("drift_psi", stats["psi"])
            if alarm:
                self.drift_alarms += 1
                if rec.active:
                    # Health-event conventions (named flags, counted,
                    # instants in `gmm timeline`) WITHOUT being a
                    # health.py fault lane: drift is a property of the
                    # traffic, not of the numerics.
                    rec.emit("drift_alarm", model=name,
                             version=int(version), psi=stats["psi"],
                             threshold=float(thr), ks=stats["ks"],
                             occupancy_l1=stats["occupancy_l1"],
                             window_rows=stats["window_rows"],
                             flag_names=["drift_psi"])
                    rec.metrics.count("drift_alarms")
                if self._lifecycle is not None:
                    # The closed loop's trigger feed: the controller
                    # debounces and reacts on later ticks; this call never
                    # touches the serving path.
                    self._lifecycle.observe_alarm(name, int(version),
                                                  stats)
            win["sketch"] = tl_sketch.StreamSketch(sk.bounds)
            win["occ"] = np.zeros_like(win["occ"])
        return out

    def drift_stats(self) -> Dict[str, Any]:
        """The rev v2.4 drift rollup (serve_summary.drift): windows
        emitted, alarms raised, and each route's last window stats."""
        return {
            "windows": int(self.drift_events),
            "alarms": int(self.drift_alarms),
            "threshold": self._drift_psi_threshold,
            "last": dict(self._drift_last),
        }

    def _reply(self, p: _Pending, resp: dict) -> None:
        latency_ms = (time.perf_counter() - p.t0) * 1e3
        resp.setdefault("latency_ms", round(latency_ms, 3))
        if p.trace_id is not None:
            # Echo the request's trace identity so a client can join its
            # response to the server-side span/serve_request records.
            resp.setdefault("trace_id", p.trace_id)
        self.requests += 1
        self._latencies.append(latency_ms)
        rec = telemetry.current()
        if rec.active:
            rec.emit("serve_request",
                     model=resp.get("model", p.req.get("model")),
                     op=resp.get("op", p.req.get("op")),
                     n=int(resp.get("n", 0)),
                     latency_ms=round(latency_ms, 3),
                     ok=bool(resp.get("ok")),
                     **({"version": resp["version"]}
                        if "version" in resp else {}),
                     **({"error": resp["error"]}
                        if "error" in resp else {}),
                     **({"trace_id": p.trace_id}
                        if p.trace_id is not None else {}))
            rec.metrics.count("serve_requests")
            rec.metrics.observe("serve.latency_ms", latency_ms)
        try:
            p.reply(resp)
        except Exception:
            # The reply callback crosses into front-end-owned I/O (a
            # socket wfile, an HTTP handler's event). A client that
            # vanished mid-flight must cost us one undeliverable
            # response, never the tick loop or the process.
            if rec.active:
                rec.metrics.count("serve_reply_failed")

    def _reply_error(self, p: _Pending, msg: str, model=None,
                     detail: Optional[str] = None) -> None:
        self.errors += 1
        rec = telemetry.current()
        if rec.active:
            rec.metrics.count("serve_errors")
        self._reply(p, {"id": (p.req.get("id")
                               if isinstance(p.req, dict) else None),
                        "ok": False, "error": msg,
                        **({"detail": detail} if detail else {}),
                        **({"model": model} if model else {})})

    # -- summary ---------------------------------------------------------

    def latency_summary(self) -> Dict[str, float]:
        lat = np.asarray(self._latencies, np.float64)
        if lat.size == 0:
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
        return {
            "p50": round(float(np.percentile(lat, 50)), 3),
            "p99": round(float(np.percentile(lat, 99)), 3),
            "mean": round(float(lat.mean()), 3),
            "max": round(float(lat.max()), 3),
        }

    def resilience_stats(self) -> Dict[str, Any]:
        """The v1.7 resilience counters (serve_summary + bench --serve):
        shed / deadline-expired request counts, breaker trips and
        fast-fails, and hot-reload swaps."""
        return {
            "shed": int(self.shed),
            "deadline_expired": int(self.deadline_expired),
            "reloads": int(self.reloads),
            "breaker": dict(self.breaker.stats(),
                            fastfails=int(self.breaker_fastfails)),
        }

    def emit_summary(self, **extra) -> Optional[dict]:
        """The closing ``serve_summary`` record (run_summary's serving
        sibling): volume, QPS, latency percentiles, executor counters,
        the resilience counters (rev v1.7), and the metrics-registry
        snapshot. ``extra`` carries opt-in plane rollups (the HTTP front
        end's ``http`` block, rev v2.7); an empty extra keeps the record
        byte-identical to pre-v2.7 streams."""
        rec = telemetry.current()
        wall = time.perf_counter() - self._t_start
        # Close out any partial drift windows first (rev v2.4): a serve
        # session shorter than one drift interval still reports what it
        # saw, and the drift events precede the summary in the stream.
        self.flush_drift()
        if not rec.active:
            return None
        watch = tl_profiling.active()
        return rec.emit(
            "serve_summary",
            requests=int(self.requests), batches=int(self.batches),
            rows=int(self.rows), errors=int(self.errors),
            wall_s=round(wall, 6),
            qps=round(self.requests / wall, 3) if wall > 0 else 0.0,
            latency_ms=self.latency_summary(),
            models=sorted({f"{n}@{m.version}"
                           for (n, _), m in self._models.items()}),
            executor=self.executor_stats(),
            stacked_batches=int(self.stacked_batches),
            **({"stacked_fallthrough": int(self.stacked_fallthrough)}
               if self.stacked_fallthrough else {}),
            **({"window": {
                "adaptations": int(self.window_adaptations),
                "window_ms": round(self._tick_cur * 1e3, 4),
                "min_ms": round(self._tick_min * 1e3, 4),
                "max_ms": round(self._tick_max * 1e3, 4),
                "auto_stack": bool(self._auto_stack),
            }} if self._adaptive else {}),
            metrics=rec.metrics.snapshot(),
            # CompileWatch rollup (rev v2.2): run_summary.profile's
            # serving sibling -- executable build counts/seconds and
            # serve-dispatch device-memory watermarks.
            **({"profile": watch.snapshot()} if watch is not None
               else {}),
            # Drift rollup (rev v2.4): only when the plane is on, so
            # drift-off streams stay byte-identical.
            **({"drift": self.drift_stats()}
               if self._drift_interval_s is not None else {}),
            **self.resilience_stats(),
            **extra,
        )

    # -- streaming loops -------------------------------------------------

    def submit_line(self, line: str, reply: Callable[[dict], None]) -> None:
        """Decode one protocol line through admission control (reader
        threads call this; the tick loop drains the queue)."""
        line = line.strip()
        if not line:
            return
        try:
            req = json.loads(line)
        except ValueError as e:
            p = _Pending({}, reply)
            self._reply_error(p, f"not JSON: {e}")
            return
        self.admit_request(req, reply)

    def admit_request(self, req, reply: Callable[[dict], None], *,
                      trace_id: Optional[str] = None) -> bool:
        """Admit one decoded request dict: scoring ops decode ``x`` HERE
        -- on the reader thread, at admission -- so a ragged or
        non-numeric body answers ``bad_request`` immediately (never
        raising from the tick loop) and the JSON-list -> ndarray
        conversion cost stays off the dispatch path. Returns True when
        queued."""
        p = _Pending(req, reply, self._default_deadline_ms,
                     trace_id=(trace_id if trace_id is not None
                               else self._mint_trace_id()))
        if isinstance(req, dict) and req.get("op") in OPS:
            try:
                p.x = _decode_x(req.get("x"))
            except _BadRequest as e:
                self._reply_error(p, "bad_request", detail=str(e))
                return False
            except (ValueError, TypeError) as e:
                self._reply_error(p, f"bad 'x': {e}")
                return False
        return self.submit(p)

    def submit_frame(self, req: dict, frame: bytes,
                     reply: Callable[[dict], None], *,
                     trace_id: Optional[str] = None) -> bool:
        """Admit one binary-payload request: a header dict (the JSONL
        header line minus its ``x_bytes``, or the HTTP URL-derived
        fields) plus one ``application/x-gmm-rows`` frame, decoded
        straight into the dispatch block via ``np.frombuffer``
        (serving/wire.py) -- no JSON float parsing, no intermediate
        Python lists. A malformed frame answers ``bad_frame``."""
        p = _Pending(req, reply, self._default_deadline_ms,
                     trace_id=(trace_id if trace_id is not None
                               else self._mint_trace_id()))
        try:
            rows = wire.decode_rows(frame)
        except wire.WireError as e:
            self._reply_error(p, "bad_frame", detail=str(e))
            return False
        req.pop("x_bytes", None)
        req["x"] = rows
        if req.get("op") in OPS:
            try:
                p.x = _decode_x(rows)
            except _BadRequest as e:
                self._reply_error(p, "bad_request", detail=str(e))
                return False
            except (ValueError, TypeError) as e:
                self._reply_error(p, f"bad 'x': {e}")
                return False
        return self.submit(p)

    def submit(self, p: _Pending) -> bool:
        """Admit ``p`` onto the batching queue, or shed it.

        Two rejection gates, both answered immediately on the reader
        thread (an overloaded or draining server must not buffer the
        very traffic it cannot take): ``shutting_down`` once the drain
        began, and ``overloaded`` when the queued row count would pass
        ``max_queue_rows`` (a request wider than the whole bound is
        still admitted when the queue is empty -- it can never fit
        better later). Returns True when queued.
        """
        self._arrivals += 1
        if self._draining.is_set():
            self._shed(p, "shutting_down")
            return False
        rows = _rows_of(p)
        if self._max_queue_rows is not None:
            with self._adm_lock:
                if (self._queued_rows > 0
                        and self._queued_rows + rows > self._max_queue_rows):
                    self._shed(p, "overloaded", rows=rows)
                    return False
                self._queued_rows += rows
        self._queue.put(p)
        return True

    def _shed(self, p: _Pending, reason: str, rows: int = 0) -> None:
        self.shed += 1
        req = p.req if isinstance(p.req, dict) else {}
        rec = telemetry.current()
        if rec.active:
            fields: Dict[str, Any] = {"reason": reason,
                                      "model": req.get("model")}
            if reason == "overloaded":
                fields.update(rows=int(rows),
                              queued_rows=int(self._queued_rows),
                              max_queue_rows=int(self._max_queue_rows))
            rec.emit("serve_shed", **fields)
            rec.metrics.count("serve_sheds")
        detail = ("server is draining; no new requests accepted"
                  if reason == "shutting_down" else
                  f"admission queue is full ({self._queued_rows} of "
                  f"{self._max_queue_rows} rows queued)")
        self._reply_error(p, reason, model=req.get("model"),
                          detail=detail)

    def _pop(self, timeout: Optional[float]) -> Optional[_Pending]:
        """One queue pop (None timeout = nonblocking), releasing the
        popped request's admission rows. Raises ``queue.Empty``."""
        p = (self._queue.get_nowait() if timeout is None
             else self._queue.get(timeout=timeout))
        if p is not None and self._max_queue_rows is not None:
            with self._adm_lock:
                self._queued_rows = max(0, self._queued_rows - _rows_of(p))
        return p

    def begin_drain(self, reason: str) -> None:
        """Flip the drain: stop admitting, keep flushing what was
        accepted. Idempotent; the first reason wins."""
        if not self._draining.is_set():
            self.drain_reason = reason
            self._draining.set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def run_loop(self, *, max_requests: Optional[int] = None,
                 idle_timeout_s: Optional[float] = None,
                 draining: Optional[Callable[[], bool]] = None,
                 reload_interval_s: Optional[float] = None) -> str:
        """The micro-batching tick loop: block for the first pending
        request, gather everything that arrives within one tick (bounded
        by ``max_batch_rows`` and the first request's deadline budget),
        dispatch the coalesced groups, repeat.

        Returns the stop reason: ``"shutdown"`` (protocol op),
        ``"max_requests"``, ``"idle"`` (``idle_timeout_s`` with an empty
        queue), ``"eof"`` (``draining`` callback true with an empty
        queue -- stdin exhausted), or ``"preempted"`` (the ambient
        supervisor's stop flag: SIGTERM/SIGINT/--max-runtime -- the
        caller exits 75 after the flush). Every exit first flushes the
        already-admitted queue; post-drain arrivals are shed with
        ``shutting_down``. ``reload_interval_s`` opts into the registry
        hot-reload poll between ticks (:meth:`maybe_reload`).
        """
        sup = supervisor_mod.current()
        reason = "shutdown"
        next_reload = (time.perf_counter() + reload_interval_s
                       if reload_interval_s else None)
        # Drift windows close on the tick-loop thread too (rev v2.4),
        # so window state never needs a lock.
        next_drift = (time.perf_counter() + self._drift_interval_s
                      if self._drift_interval_s else None)
        idle_since = time.perf_counter()
        while True:
            if self._stop.is_set():
                reason = "shutdown"
                break
            if sup.active and sup.poll(where="serve"):
                reason = "preempted"
                self.begin_drain(sup.stop_reason or "preempt")
                break
            if max_requests is not None and self.requests >= max_requests:
                reason = "max_requests"
                break
            if (next_reload is not None
                    and time.perf_counter() >= next_reload):
                self.maybe_reload()
                next_reload = time.perf_counter() + reload_interval_s
            if (next_drift is not None
                    and time.perf_counter() >= next_drift):
                self.flush_drift()
                next_drift = time.perf_counter() + self._drift_interval_s
            if self._lifecycle is not None:
                # The lifecycle state machine: same thread as drift windows
                # and hot-reload, so retrain / canary / promote / rollback
                # transitions interleave between coalesced dispatches
                # without locks. Cheap when nothing is scheduled.
                self._lifecycle.on_tick()
            # Bounded wait so signals/deadline/reload stay responsive
            # even on an idle queue.
            wait = 0.1 if idle_timeout_s is None else min(
                0.1, idle_timeout_s)
            try:
                first = self._pop(timeout=wait)
            except queue.Empty:
                now = time.perf_counter()
                if (idle_timeout_s is not None
                        and now - idle_since >= idle_timeout_s):
                    reason = "idle"
                    break
                if draining is not None and draining():
                    reason = "eof"
                    break
                continue
            idle_since = time.perf_counter()
            if first is None:
                reason = "shutdown"
                break
            batch = [first]
            rows = _rows_of(first)
            tick = self._tick_cur if self._adaptive else self._tick_s
            tick_end = time.perf_counter() + tick
            if first.deadline is not None:
                # Never let the gather window outwait the first
                # request's remaining budget. Adaptive windows can be
                # WIDER than a request's whole budget, so the
                # controller only ever spends half the remaining
                # budget gathering -- the other half stays for the
                # dispatch to answer inside the deadline. Fixed mode
                # keeps the original cap (tick_s is normally orders of
                # magnitude under any real deadline).
                if self._adaptive:
                    now = time.perf_counter()
                    budget = first.deadline - now
                    tick_end = min(tick_end,
                                   now + max(0.0, budget / 2.0))
                else:
                    tick_end = min(tick_end, first.deadline)
            while rows < self._max_batch_rows:
                remaining = tick_end - time.perf_counter()
                try:
                    p = self._pop(None if remaining <= 0 else remaining)
                except queue.Empty:
                    break
                if p is None:
                    self._stop.set()
                    break
                batch.append(p)
                rows += _rows_of(p)
            if self._adaptive:
                self._observe_window(len(batch))
            self._process(batch)
        # Flush whatever was admitted before the stop (EOF/shutdown/
        # preemption must not drop accepted requests on the floor). On a
        # TERMINAL exit the drain flag flips first so concurrent
        # arrivals shed with shutting_down instead of racing the flush;
        # idle/max_requests exits stay resumable (benchmarks re-enter
        # the loop).
        if reason in ("preempted", "shutdown", "eof"):
            self.begin_drain(reason)
        leftovers = []
        while True:
            try:
                p = self._pop(None)
            except queue.Empty:
                break
            if p is not None:
                leftovers.append(p)
        if leftovers:
            self._process(leftovers)
        return reason


def _rows_of(p: _Pending) -> int:
    if p.x is not None:
        return max(int(p.x.shape[0]), 1)
    x = p.req.get("x") if isinstance(p.req, dict) else None
    try:
        return max(len(x), 1)
    except TypeError:
        return 1


def _stdout_replier(out, lock: threading.Lock) -> Callable[[dict], None]:
    def reply(resp: dict) -> None:
        line = json.dumps(resp, default=_json_default)
        with lock:
            out.write(line + "\n")
            out.flush()
    return reply


def _json_default(o):
    item = getattr(o, "item", None)
    if callable(item):
        return o.item()
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return o.tolist()
    return str(o)


#: Per-connection read deadline and line bound shared by the UNIX-socket
#: and HTTP front ends (serving/http.py mirrors them as body bounds): a
#: stalled client must time out instead of wedging a reader thread, and
#: an unbounded line must be rejected instead of buffered.
READ_TIMEOUT_S = 30.0
MAX_LINE_BYTES = 8 << 20


def _serve_socket(server: GMMServer, path: str,
                  max_requests: Optional[int],
                  reload_interval_s: Optional[float] = None,
                  read_timeout_s: float = READ_TIMEOUT_S,
                  max_line_bytes: int = MAX_LINE_BYTES) -> str:
    """UNIX-socket front end: every connection speaks the same JSONL
    protocol; requests from ALL connections land on one batching queue,
    so concurrent clients coalesce into shared dispatches (the
    micro-batching win a per-connection loop could never get). Returns
    the tick loop's stop reason.

    Reader containment (rev v2.7): each connection's reads carry a
    deadline (``read_timeout_s``; a slowloris client used to park its
    reader thread on an unbounded ``readline()`` forever) and a line
    bound (``max_line_bytes``; an oversized request is answered
    ``line_too_long`` and the connection closed, instead of the line
    growing without bound in the read buffer)."""
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        # StreamRequestHandler.setup() applies this as the connection's
        # socket timeout; a stalled read raises instead of blocking.
        timeout = read_timeout_s

        def handle(self):
            lock = threading.Lock()

            def reply(resp: dict) -> None:
                line = json.dumps(resp, default=_json_default)
                try:
                    with lock:
                        self.wfile.write(line.encode() + b"\n")
                        self.wfile.flush()
                except (BrokenPipeError, OSError, ValueError):
                    # Client went away; the dispatch already ran. A
                    # closed BufferedWriter raises ValueError, not
                    # OSError -- missing it here once let an abandoned
                    # connection kill the whole worker process.
                    pass

            while True:
                try:
                    raw = self.rfile.readline(max_line_bytes + 1)
                except OSError:
                    # Read deadline hit (socket.timeout is an OSError) or
                    # the client vanished: release this reader thread.
                    break
                if not raw:
                    break  # clean EOF
                if len(raw) > max_line_bytes:
                    reply({"ok": False, "error": "line_too_long",
                           "detail": "request line exceeds the "
                           f"{max_line_bytes}-byte bound"})
                    # Drain the rest of the offending line (bounded:
                    # a few more chunks, never the whole stream) so
                    # closing doesn't RST the un-read reply away.
                    try:
                        for _ in range(64):
                            tail = self.rfile.readline(max_line_bytes + 1)
                            if not tail or tail.endswith(b"\n"):
                                break
                    except OSError:
                        pass
                    break
                # Binary payload (docs/SERVING.md "Binary payloads"): a
                # header line declaring "x_bytes" is followed by exactly
                # that many raw x-gmm-rows frame bytes. The substring
                # probe keeps the JSON-only fast path single-pass.
                if b'"x_bytes"' in raw:
                    if self._handle_frame(raw, reply):
                        continue
                    break  # unrecoverable framing: close the stream
                server.submit_line(raw.decode("utf-8", "replace"), reply)
                if server._stop.is_set():
                    break

        def _handle_frame(self, raw: bytes, reply) -> bool:
            """One length-prefixed binary request. Returns False when
            the connection must close (the raw byte stream can no
            longer be trusted to be line-aligned)."""
            try:
                req = json.loads(raw)
            except ValueError as e:
                reply({"ok": False, "error": f"not JSON: {e}"})
                return True
            n = req.get("x_bytes") if isinstance(req, dict) else None
            if (isinstance(n, bool) or not isinstance(n, int)
                    or n <= 0):
                reply({"ok": False, "error": "bad_frame",
                       "detail": "'x_bytes' must declare a positive "
                       "frame length in bytes"})
                return True
            if n > max_line_bytes:
                # Reject BEFORE buffering; the unread frame bytes make
                # the stream unusable, so the connection closes (the
                # reply flushes first), exactly like line_too_long.
                reply({"ok": False, "error": "frame_too_large",
                       "detail": f"declared frame of {n} bytes exceeds "
                       f"the {max_line_bytes}-byte bound"})
                return False
            try:
                frame = self.rfile.read(n)
            except OSError:
                return False  # read deadline / client vanished
            if len(frame) < n:
                reply({"ok": False, "error": "bad_frame",
                       "detail": f"stream ended after {len(frame)} of "
                       f"{n} declared frame bytes"})
                return False
            server.submit_frame(req, frame, reply)
            return not server._stop.is_set()

    class Srv(socketserver.ThreadingMixIn,
              socketserver.UnixStreamServer):
        daemon_threads = True

    if os.path.exists(path):
        os.remove(path)
    with Srv(path, Handler) as srv:
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"poll_interval": 0.05}, daemon=True)
        t.start()
        try:
            return server.run_loop(max_requests=max_requests,
                                   reload_interval_s=reload_interval_s)
        finally:
            srv.shutdown()
            try:
                os.remove(path)
            except OSError:
                pass


def _write_port_file(path: Optional[str], port: Optional[int]) -> None:
    """Atomically publish the bound HTTP port (resolves ``--http 0``)."""
    if not path or port is None:
        return
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(str(int(port)))
    os.replace(tmp, path)


def _worker_argv(args, worker_sock: str) -> List[str]:
    """One pool worker's command line: the SAME serve CLI, minus the
    pool/http flags, plus its own --socket -- every already-tested
    single-process behavior (coalescing, breakers, drift,
    drain-on-SIGTERM) carries over unchanged."""
    cmd = [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "serve",
           "--registry", args.registry, "--socket", worker_sock,
           "--max-batch-rows", str(args.max_batch_rows),
           "--tick-ms", str(args.tick_ms),
           "--read-timeout-s", str(args.read_timeout_s),
           "--max-body-bytes", str(args.max_body_bytes),
           "--breaker-threshold", str(args.breaker_threshold),
           "--breaker-backoff-s", str(args.breaker_backoff_s)]
    if args.tick_min_ms is not None:
        cmd += ["--tick-min-ms", str(args.tick_min_ms)]
    if args.tick_max_ms is not None:
        cmd += ["--tick-max-ms", str(args.tick_max_ms)]
    if args.models is not None:
        cmd += ["--models", *args.models]
    if args.no_warmup:
        cmd.append("--no-warmup")
    cmd += ["--device", args.device]
    if args.autotune != "off":
        cmd += ["--autotune", args.autotune]
    if args.tuning_db:
        cmd += ["--tuning-db", args.tuning_db]
    if args.max_queue_rows is not None:
        cmd += ["--max-queue-rows", str(args.max_queue_rows)]
    if args.default_deadline_ms is not None:
        cmd += ["--default-deadline-ms", str(args.default_deadline_ms)]
    if args.reload_interval_s is not None:
        cmd += ["--reload-interval-s", str(args.reload_interval_s)]
    if args.drift_interval_s is not None:
        cmd += ["--drift-interval-s", str(args.drift_interval_s),
                "--drift-psi-threshold", str(args.drift_psi_threshold)]
    if args.lifecycle:
        cmd += ["--lifecycle", args.lifecycle]
    if args.stack_models:
        cmd.append("--stack-models")
    return cmd


def _serve_pool_main(args) -> int:
    """``gmm serve --http PORT --workers N``: the supervised pool mode.

    The parent is a router + supervisor only (serving/pool.py owns the
    containment arc); its telemetry stream carries the HTTP edge --
    http_request / worker_spawn / worker_exit events and a closing
    serve_summary whose ``http`` rollup ``gmm diff`` gates on. Worker
    streams land next to the parent's (``<base>.worker<i>.jsonl``)."""
    import tempfile

    from .http import HTTPFrontEnd
    from .pool import WorkerPool

    worker_dir = args.worker_dir or tempfile.mkdtemp(
        prefix="gmm-serve-pool-")

    def command_for(idx: int, sock: str) -> List[str]:
        cmd = _worker_argv(args, sock)
        if args.metrics_file:
            base, ext = os.path.splitext(args.metrics_file)
            cmd += ["--metrics-file",
                    f"{base}.worker{idx}{ext or '.jsonl'}"]
        return cmd

    rec = (telemetry.RunRecorder(args.metrics_file)
           if args.metrics_file else telemetry.RunRecorder())
    rec.set_context(path="serve")
    sup = supervisor_mod.RunSupervisor(max_runtime_s=args.max_runtime)
    pool = WorkerPool(args.workers, worker_dir, command_for,
                      backoff_base_s=args.worker_backoff_s,
                      quarantine_after=args.worker_quarantine_after)
    t_start = time.perf_counter()
    with telemetry.use(rec), rec, supervisor_mod.use(sup), \
            tl_exporter.live_plane(
                args.metrics_port,
                registry_provider=lambda: telemetry.current().metrics,
                gauges_provider=pool.gauges,
                recorder=rec):
        rec.heartbeat("serve")
        try:
            pool.start()
        except (RuntimeError, OSError) as e:
            print(f"worker pool failed to start: {e}", file=sys.stderr)
            pool.close()
            return 1
        front = HTTPFrontEnd(
            pool, host=args.http_host, port=args.http,
            max_body_bytes=args.max_body_bytes,
            read_timeout_s=args.read_timeout_s,
            max_connections=args.http_max_connections,
            stopping=lambda: sup.stop_requested)
        front.start()
        _write_port_file(args.http_port_file, front.port)
        try:
            reason = "max_requests"
            while True:
                if sup.active and sup.poll(where="serve"):
                    reason = "preempted"
                    break
                if (args.max_requests is not None
                        and front.requests >= args.max_requests):
                    reason = "max_requests"
                    break
                time.sleep(0.05)
            # Drain order is the /readyz contract: the probe already
            # flips 503 (sup.stop_requested / pool.draining), THEN the
            # workers flush their queues and exit 75, THEN we summarize.
            pool.begin_drain()
            pool.wait(timeout_s=60.0)
        finally:
            front.stop()
            pool.close()
        if rec.active:
            wall = time.perf_counter() - t_start
            rec.emit(
                "serve_summary",
                requests=int(front.requests), batches=0,
                rows=int(front.rows), errors=int(front.errors_5xx),
                wall_s=round(wall, 6),
                qps=(round(front.requests / wall, 3) if wall > 0
                     else 0.0),
                latency_ms=front.latency_summary(),
                metrics=rec.metrics.snapshot(),
                http=front.http_rollup())
        if reason == "preempted":
            stop_reason = sup.stop_reason or "preempt"
            if rec.active:
                rec.emit("shutdown", reason=stop_reason,
                         checkpointed=False)
            print(f"Preempted -- worker pool drained ({stop_reason}); "
                  "workers flushed their queues", file=sys.stderr)
            return supervisor_mod.EX_TEMPFAIL
    return 0


def serve_main(argv=None) -> int:
    """``gmm serve``: run the micro-batched scoring loop over a registry."""
    import argparse

    p = argparse.ArgumentParser(
        prog="gmm serve",
        description="Serve registry models over the JSONL request "
        "protocol: stdin/stdout by default, a request file with "
        "--input, or a UNIX socket with --socket (docs/SERVING.md).")
    p.add_argument("--registry", required=True,
                   help="model registry root directory (gmm export)")
    p.add_argument("--models", nargs="*", default=None,
                   metavar="NAME[@VERSION]",
                   help="models to load (and warm) at startup; "
                   "default: every registered model's newest version. "
                   "Requests may still address any registry model")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="serve a UNIX stream socket instead of "
                   "stdin/stdout (concurrent clients share the "
                   "micro-batch queue)")
    p.add_argument("--input", default=None, metavar="FILE.jsonl",
                   help="read requests from a file instead of stdin")
    p.add_argument("--output", default=None, metavar="FILE.jsonl",
                   help="write responses to a file instead of stdout")
    p.add_argument("--max-batch-rows", type=int, default=8192,
                   help="coalesced rows per dispatch tick (default 8192)")
    p.add_argument("--tick-ms", type=float, default=2.0,
                   help="micro-batch gather window in milliseconds "
                   "(default 2). Fixed unless an adaptive bound is "
                   "given (--tick-min-ms / --tick-max-ms)")
    p.add_argument("--tick-min-ms", type=float, default=None,
                   metavar="MS",
                   help="adaptive micro-batching lower bound: passing "
                   "this (or --tick-max-ms) replaces the fixed tick "
                   "with a bounded controller -- a backlogged queue "
                   "snaps the gather window down to this floor "
                   "(dispatch immediately). Default: off -- fixed "
                   "--tick-ms, byte-identical stream")
    p.add_argument("--tick-max-ms", type=float, default=None,
                   metavar="MS",
                   help="adaptive micro-batching upper bound: idle "
                   "traffic widens the gather window toward this "
                   "ceiling to coalesce more rows per executor call. "
                   "Windows repeatedly carrying >= 2 same-family "
                   "routes auto-enable stacked dispatch. Each "
                   "adaptation emits a `serve_window` event (rev v2.8)")
    p.add_argument("--max-requests", type=int, default=None,
                   help="exit after this many responses (benchmarks, "
                   "tests)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip building the loaded models' executables "
                   "(on the card: their CUDA-graph captures; the first "
                   "request pays the build)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device the scoring executors run on "
                   "(default cuda: S1 on the card; without a GPU pass "
                   "--device cpu)")
    p.add_argument("--metrics-file", default=None, metavar="FILE.jsonl",
                   help="serve telemetry stream: serve_request / "
                   "serve_batch / serve_summary plus the v1.7 "
                   "resilience events (serve_shed / serve_deadline / "
                   "serve_reload / circuit); render with `gmm report`")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="live observability plane (rev v2.1): serve "
                   "Prometheus/OpenMetrics text on "
                   "127.0.0.1:PORT/metrics (0 = OS-assigned), sample "
                   "host RSS + device memory onto heartbeat records, "
                   "emit route spans, and echo a trace_id in every "
                   "response (default: off; responses and streams stay "
                   "byte-identical)")
    p.add_argument("--autotune", default="off", choices=["off", "db"],
                   help="resolve executor block bounds per served "
                   "family from the tuning database (nearest recorded "
                   "serve row; docs/PERF.md 'Autotuning'). Decisions "
                   "land on the serve stream as `tune` events. Default "
                   "off: hand-set geometry, byte-identical stream")
    p.add_argument("--tuning-db", default=None, metavar="PATH",
                   help="tuning database path (default GMM_TUNING_DB or "
                   "~/.cache/gmm/tuning.json)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the serve "
                   "loop into DIR (a Chrome trace; view with Perfetto)")
    net = p.add_argument_group(
        "network front end (docs/SERVING.md \"HTTP front end\")")
    net.add_argument("--http", type=int, default=None, metavar="PORT",
                     help="serve POST /v1/models/NAME[@VER]:OP over "
                     "HTTP on this port (0 = OS-assigned; see "
                     "--http-port-file), with /healthz /readyz "
                     "/metrics probes. Requests ride the same "
                     "micro-batch queue, deadlines, and breakers as "
                     "the JSONL protocol. Default: off -- responses "
                     "and streams stay byte-identical")
    net.add_argument("--http-host", default="127.0.0.1", metavar="HOST",
                     help="HTTP bind address (default 127.0.0.1; bind "
                     "0.0.0.0 only behind a load balancer you trust)")
    net.add_argument("--workers", type=int, default=0, metavar="N",
                     help="fork N supervised worker processes behind "
                     "the HTTP front end (requires --http): consistent "
                     "(model,version)->worker routing, sibling retry "
                     "of a crashed worker's in-flight requests, "
                     "jittered-doubling respawn, crash-loop "
                     "quarantine (docs/ROBUSTNESS.md). Default 0: "
                     "serve in-process")
    net.add_argument("--http-port-file", default=None, metavar="FILE",
                     help="write the BOUND http port here once "
                     "listening (resolves --http 0 for tests/benches)")
    net.add_argument("--http-max-connections", type=int, default=64,
                     metavar="N",
                     help="live HTTP connection cap; arrivals past it "
                     "shed 503 + Retry-After instead of exhausting "
                     "handler threads (default 64)")
    net.add_argument("--max-body-bytes", type=int, default=MAX_LINE_BYTES,
                     metavar="BYTES",
                     help="bound on one HTTP request body / one JSONL "
                     "socket line; oversized requests are rejected "
                     "(413 / line_too_long) before buffering "
                     "(default 8 MiB)")
    net.add_argument("--read-timeout-s", type=float,
                     default=READ_TIMEOUT_S, metavar="SECONDS",
                     help="per-connection read deadline for the HTTP "
                     "and UNIX-socket front ends: a stalled (slowloris) "
                     "client times out instead of wedging a reader "
                     "thread forever (default 30)")
    net.add_argument("--worker-dir", default=None, metavar="DIR",
                     help="worker pool state directory: per-worker "
                     "sockets, {pid, socket, gen} state files, logs, "
                     "and quarantine reason files (default: a fresh "
                     "temp directory)")
    net.add_argument("--worker-backoff-s", type=float, default=0.5,
                     metavar="SECONDS",
                     help="base respawn backoff after a worker crash; "
                     "doubles per consecutive crash with deterministic "
                     "jitter (default 0.5)")
    net.add_argument("--worker-quarantine-after", type=int, default=5,
                     metavar="N",
                     help="consecutive crashes that quarantine a "
                     "worker slot (reason file written; siblings keep "
                     "serving; default 5)")
    r = p.add_argument_group(
        "resilience (docs/ROBUSTNESS.md \"Serving\")")
    r.add_argument("--max-runtime", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock budget: reaching it drains like "
                   "SIGTERM does -- flush the queue, answer "
                   "shutting_down to late arrivals, exit 75 "
                   "(EX_TEMPFAIL; the fit CLI's preemption contract)")
    r.add_argument("--max-queue-rows", type=int, default=None,
                   metavar="ROWS",
                   help="admission bound on queued request rows; "
                   "arrivals past it shed immediately with "
                   "'overloaded' instead of growing the queue without "
                   "bound (default: unbounded)")
    r.add_argument("--default-deadline-ms", type=float, default=None,
                   metavar="MS",
                   help="per-request budget for requests that carry no "
                   "deadline_ms of their own; a request whose budget "
                   "expires while queued is rejected with "
                   "'deadline_expired' before dispatch")
    r.add_argument("--reload-interval-s", type=float, default=None,
                   metavar="SECONDS",
                   help="opt-in registry hot-reload: poll the registry "
                   "at this cadence and atomically swap version-less "
                   "routes to newly exported versions between ticks "
                   "(pinned versions are untouched; default: off -- "
                   "versions pin at first use)")
    r.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive route failures (non-finite "
                   "scores, registry/executor errors) that open a "
                   "(model, version) circuit breaker (default 3)")
    r.add_argument("--breaker-backoff-s", type=float, default=1.0,
                   help="base seconds an open breaker fast-fails "
                   "before half-opening; doubles per consecutive "
                   "trip with deterministic jitter (default 1)")
    dr = p.add_argument_group(
        "drift observability (docs/OBSERVABILITY.md \"Drift "
        "detection\")")
    dr.add_argument("--drift-interval-s", type=float, default=None,
                    metavar="SECONDS",
                    help="opt-in drift plane (stream rev v2.4): sketch "
                    "every route's request scores + cluster occupancy "
                    "and emit a `drift` event per interval -- PSI/KS "
                    "vs the model's training envelope "
                    "(envelope.json) plus occupancy L1 shift. Free on "
                    "the dispatch path (rides the answered 'proba' "
                    "block); default: off -- responses, streams, and "
                    "/metrics stay byte-identical")
    dr.add_argument("--drift-psi-threshold", type=float, default=0.2,
                    metavar="PSI",
                    help="PSI above this raises a `drift_alarm` event "
                    "(observational only -- never trips the breaker; "
                    "default 0.2, the conventional major-shift line)")
    dr.add_argument("--lifecycle", default=None, metavar="POLICY.json",
                    help="opt-in closed-loop lifecycle (rev v2.6, "
                    "docs/ROBUSTNESS.md \"Model lifecycle\"): "
                    "debounced drift alarms trigger a shadow "
                    "minibatch-EM retrain, canary gates + a "
                    "duplicate-dispatch shadow window guard promotion, "
                    "and a post-promotion probation auto-rolls back on "
                    "a breaker trip / drift alarm / score regression. "
                    "Requires --drift-interval-s (alarms are the "
                    "trigger). Default: off -- responses and streams "
                    "stay byte-identical")
    p.add_argument("--stack-models", action="store_true",
                   help="cross-model coalescing: one tick's requests "
                   "for DIFFERENT models of one numeric family score "
                   "through a single stacked executable call "
                   "(bit-identical to per-model dispatch; "
                   "docs/TENANCY.md \"Serving the fleet\")")
    args = p.parse_args(argv)

    if args.socket and (args.input or args.output):
        # Loud conflict, not a silent ignore: socket mode replies on
        # each client's own connection, so --input/--output could never
        # take effect.
        p.error("--socket conflicts with --input/--output (socket "
                "clients carry their own request/response streams)")
    if args.http is not None and (args.socket or args.input
                                  or args.output):
        p.error("--http conflicts with --socket/--input/--output "
                "(HTTP clients carry their own request/response "
                "streams)")
    if (args.tick_min_ms is not None and args.tick_max_ms is not None
            and args.tick_max_ms < args.tick_min_ms):
        p.error("--tick-max-ms must be >= --tick-min-ms")
    if args.workers and args.http is None:
        p.error("--workers forks processes behind the HTTP front end; "
                "it requires --http")
    if args.workers < 0:
        p.error("--workers must be >= 0")
    if args.lifecycle and args.drift_interval_s is None:
        p.error("--lifecycle consumes drift alarms; it requires "
                "--drift-interval-s")
    try:
        device_or_raise(args.device)
    except RuntimeError as e:
        print(f"serve failed: {e}", file=sys.stderr)
        return 1

    if args.http is not None and args.workers > 0:
        # Pool mode: this process becomes a pure HTTP router +
        # supervisor over N forked `gmm serve --socket` workers. It
        # never loads a model or touches an executor, so a worker's
        # death can never take the front end with it.
        return _serve_pool_main(args)

    registry = ModelRegistry(args.registry)
    lifecycle = None
    if args.lifecycle:
        from ..lifecycle import LifecycleController, LifecycleError
        from ..lifecycle import LifecyclePolicy

        try:
            lifecycle = LifecycleController(
                registry, LifecyclePolicy.from_file(args.lifecycle),
                device=args.device)
        except LifecycleError as e:
            p.error(str(e))
    server = GMMServer(registry,
                       max_batch_rows=args.max_batch_rows,
                       tick_s=args.tick_ms / 1e3,
                       tick_s_min=(args.tick_min_ms / 1e3
                                   if args.tick_min_ms is not None
                                   else None),
                       tick_s_max=(args.tick_max_ms / 1e3
                                   if args.tick_max_ms is not None
                                   else None),
                       warm=not args.no_warmup,
                       max_queue_rows=args.max_queue_rows,
                       default_deadline_ms=args.default_deadline_ms,
                       breaker_threshold=args.breaker_threshold,
                       breaker_backoff_s=args.breaker_backoff_s,
                       stack_models=args.stack_models,
                       trace_requests=args.metrics_port is not None,
                       drift_interval_s=args.drift_interval_s,
                       drift_psi_threshold=args.drift_psi_threshold,
                       autotune=args.autotune,
                       tuning_db=args.tuning_db,
                       lifecycle=lifecycle,
                       device=args.device)

    rec = (telemetry.RunRecorder(args.metrics_file)
           if args.metrics_file else telemetry.RunRecorder())
    rec.set_context(path="serve")

    # The run supervisor gives `gmm serve` the fit CLI's preemption
    # contract (docs/ROBUSTNESS.md "Run lifecycle"): SIGTERM/SIGINT and
    # the --max-runtime deadline flip a graceful drain observed by the
    # tick loop, never a mid-dispatch kill. Signal handlers install on
    # the main thread only (library/thread callers keep deadline
    # support).
    sup = supervisor_mod.RunSupervisor(max_runtime_s=args.max_runtime)

    from ..utils.profiling import trace as profiler_trace

    with telemetry.use(rec), rec, supervisor_mod.use(sup), \
            tl_exporter.live_plane(
                args.metrics_port,
                registry_provider=lambda: telemetry.current().metrics,
                gauges_provider=server.live_gauges,
                recorder=rec), \
            (tl_profiling.watch() if rec.active
             else contextlib.nullcontext()), \
            profiler_trace(args.trace_dir, device=args.device):
        # Head-of-stream heartbeat (rev v2.3): the serve stream's first
        # record, so it carries the clock/clock0 anchor pair that lets
        # `gmm timeline` align this stream against a fit stream. The
        # rate limiter starts open, so this emits immediately.
        rec.heartbeat("serve")
        # Pre-resolve (and warm) the requested model set so the first
        # request never pays registry IO or a build.
        names = args.models
        if names is None:
            names = registry.models()
        try:
            for spec in names:
                name, _, ver = spec.partition("@")
                server.resolve(name, int(ver) if ver else None)
        except (RegistryError, ValueError) as e:
            print(f"cannot load {spec!r}: {e}", file=sys.stderr)
            return 1

        front = None
        if args.http is not None:
            from .http import HTTPFrontEnd, InprocBackend

            front = HTTPFrontEnd(
                InprocBackend(server), host=args.http_host,
                port=args.http, max_body_bytes=args.max_body_bytes,
                read_timeout_s=args.read_timeout_s,
                max_connections=args.http_max_connections,
                # /readyz flips the instant the stop flag trips (signal
                # time), BEFORE the tick loop notices and flushes: a
                # load balancer stops routing while the drain answers
                # what it already admitted.
                stopping=lambda: sup.stop_requested)
            front.start()
            _write_port_file(args.http_port_file, front.port)
            try:
                reason = server.run_loop(
                    max_requests=args.max_requests,
                    reload_interval_s=args.reload_interval_s)
            finally:
                front.stop()
        elif args.socket:
            reason = _serve_socket(server, args.socket, args.max_requests,
                                   args.reload_interval_s,
                                   read_timeout_s=args.read_timeout_s,
                                   max_line_bytes=args.max_body_bytes)
        else:
            out = (open(args.output, "w", encoding="utf-8")
                   if args.output else sys.stdout)
            lock = threading.Lock()
            reply = _stdout_replier(out, lock)
            src = (open(args.input, encoding="utf-8")
                   if args.input else sys.stdin)
            eof = threading.Event()

            def read_all():
                try:
                    for line in src:
                        server.submit_line(line, reply)
                finally:
                    eof.set()

            t = threading.Thread(target=read_all, daemon=True)
            t.start()
            try:
                reason = server.run_loop(
                    max_requests=args.max_requests, draining=eof.is_set,
                    reload_interval_s=args.reload_interval_s)
            finally:
                if args.input:
                    src.close()
                if args.output:
                    out.close()
        server.emit_summary(**({"http": front.http_rollup()}
                               if front is not None else {}))
        if reason == "preempted":
            # The fit CLI's exit contract: drained by signal/deadline ->
            # telemetry shutdown record + exit 75 (EX_TEMPFAIL), so a
            # batch scheduler restarts the server unconditionally.
            stop_reason = server.drain_reason or "preempt"
            if rec.active:
                rec.emit("shutdown", reason=stop_reason,
                         checkpointed=False)
            print(f"Preempted -- serve loop drained ({stop_reason}); "
                  "queued requests flushed", file=sys.stderr)
            return supervisor_mod.EX_TEMPFAIL
    return 0
