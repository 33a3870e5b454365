"""HTTP front end for the serving plane (stream rev v2.7, stdlib-only).

The reference is a single offline binary; our serving loop (PRs 7/8)
spoke JSONL over stdin or a UNIX socket, capping it at one host and one
client locality. This module puts the SAME micro-batch queue core behind
``POST /v1/models/<name>[@<version>]:<op>`` -- every request still rides
the coalescing tick loop, admission control, deadlines, and circuit
breakers of :class:`~.server.GMMServer`; HTTP is a transport, not a
second serving implementation.

Contract (docs/SERVING.md "HTTP front end"):

* ``POST /v1/models/NAME[@VER]:{predict,predict_proba,score_samples,
  score}`` with a JSON body ``{"x": [[...], ...]}``. The per-request
  budget comes from the ``X-GMM-Deadline-Ms`` header (falling back to a
  ``deadline_ms`` body field); the request's trace identity from
  ``X-GMM-Trace-Id`` (minted when absent) and is echoed back in the
  response header, so ``gmm timeline`` flow arrows join client and
  server across the wire.
* ``GET /healthz`` -- liveness: 200 while the process can answer at all.
* ``GET /readyz`` -- routability: flips to 503 the instant a drain
  begins (SIGTERM / --max-runtime), BEFORE the queue flush, so a load
  balancer stops routing while the flush still answers what it admitted.
* ``GET /metrics`` -- the OpenMetrics exposition, rendered by the same
  :func:`~..telemetry.exporter.render_openmetrics` the --metrics-port
  plane uses.

Failure containment, because the network is where the failures live:
per-connection read deadlines (a slowloris client times out instead of
wedging a handler thread), a bounded request body (413 past it), and a
connection cap that sheds 503 + ``Retry-After`` instead of letting a
connection storm exhaust threads. Protocol error tokens map onto status
codes (overloaded -> 429, shutting_down / circuit_open -> 503 +
``Retry-After``, deadline_expired -> 504, unknown model -> 404,
dispatch/poison failures -> 500, worker loss past the sibling retry ->
502) so a fleet's LB and the :class:`~.client.GMMClient` retry policy
can tell retryable congestion from deterministic client error.
"""

from __future__ import annotations

import collections
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from .. import telemetry
from ..telemetry.exporter import render_openmetrics
from . import wire

#: ops accepted in the URL (mirrors server.OPS; ping/shutdown stay
#: JSONL-protocol-only -- an HTTP caller probes /healthz and drains via
#: SIGTERM, not via a scoring endpoint).
HTTP_OPS = ("predict", "predict_proba", "score_samples", "score")

DEFAULT_MAX_BODY_BYTES = 8 << 20
DEFAULT_READ_TIMEOUT_S = 30.0
DEFAULT_MAX_CONNECTIONS = 64

#: Retry-After seconds suggested on 429/503 sheds (coarse by design: the
#: client's jittered backoff is the real pacing; this is the floor).
RETRY_AFTER_S = 1


def parse_model_path(path: str) -> Optional[Tuple[str, Optional[int], str]]:
    """``/v1/models/NAME[@VER]:OP`` -> (name, version, op), or None."""
    prefix = "/v1/models/"
    if not path.startswith(prefix):
        return None
    rest = path[len(prefix):]
    spec, sep, op = rest.rpartition(":")
    if not sep or not spec or op not in HTTP_OPS:
        return None
    name, at, ver = spec.partition("@")
    if not name or (at and not ver):
        return None     # "m@:op" is a malformed pin, not latest
    version: Optional[int] = None
    if ver:
        try:
            version = int(ver)
        except ValueError:
            return None
    return name, version, op


def status_for_error(error: str) -> int:
    """Protocol error token -> HTTP status (the containment taxonomy)."""
    if error == "overloaded":
        return 429
    if error in ("shutting_down", "circuit_open"):
        return 503
    if error in ("deadline_expired", "http_timeout"):
        return 504
    if error == "worker_unavailable":
        return 502
    if error == "non_finite_scores" or error.startswith("dispatch failed"):
        return 500
    if error in ("frame_too_large", "body_too_large", "line_too_long"):
        return 413
    if "unknown model" in error or "registry" in error:
        return 404
    # bad_request / bad_frame / bad_json and every other client-content
    # token: deterministic 400, never retried.
    return 400


class InprocBackend:
    """Single-process backend: HTTP handler threads submit straight onto
    the owning :class:`~.server.GMMServer`'s batching queue (exactly like
    UNIX-socket reader threads do) and block on the reply."""

    def __init__(self, server):
        self._server = server

    def score(self, req: dict,
              trace_id: Optional[str] = None) -> Tuple[dict, Dict[str, Any]]:
        srv = self._server
        done = threading.Event()
        box: Dict[str, dict] = {}

        def reply(resp: dict) -> None:
            box["resp"] = resp
            done.set()

        # admit_request decodes x at admission (bad_request / bad_frame
        # answer synchronously on this thread) and sheds synchronously
        # too, exactly as submit did.
        srv.admit_request(req, reply, trace_id=trace_id)
        # Bound the wait by the request's own budget plus grace for the
        # in-flight dispatch; a budget-less request waits for the loop.
        ms = srv._default_deadline_ms
        raw = req.get("deadline_ms") if isinstance(req, dict) else None
        if isinstance(raw, (int, float)) and not isinstance(raw, bool):
            ms = float(raw)
        timeout = (ms / 1e3 + 10.0) if ms and ms > 0 else None
        if not done.wait(timeout):
            return ({"id": req.get("id"), "ok": False,
                     "error": "http_timeout",
                     "detail": "no reply within the request budget"},
                    {})
        return box["resp"], {}

    def ready(self) -> bool:
        return not self._server.draining

    def gauges(self) -> Dict[str, float]:
        return self._server.live_gauges()

    def http_stats(self) -> Dict[str, int]:
        return {}


class HTTPFrontEnd:
    """The ThreadingHTTPServer wrapper: routing, header contract,
    connection accounting, probes, and the v2.7 http telemetry.

    ``backend`` is duck-typed (:class:`InprocBackend` or the worker
    pool's router): ``score(req, trace_id) -> (response, meta)``,
    ``ready() -> bool``, ``gauges() -> dict``, ``http_stats() -> dict``.
    ``stopping`` (optional callable) joins the ambient supervisor's stop
    flag into /readyz so the probe flips at signal time, before the
    backend notices the drain.
    """

    def __init__(self, backend, *, host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
                 read_timeout_s: float = DEFAULT_READ_TIMEOUT_S,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 stopping: Optional[Callable[[], bool]] = None):
        self._backend = backend
        self._requested = (host, int(port))
        self._max_body = int(max_body_bytes)
        self._read_timeout_s = float(read_timeout_s)
        self._max_connections = int(max_connections)
        self._stopping = stopping
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._connections = 0
        self._latencies: collections.deque = collections.deque(
            maxlen=100_000)
        self.requests = 0
        self.rows = 0
        self.errors_4xx = 0
        self.errors_5xx = 0
        self.shed_connections = 0

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def start(self) -> "HTTPFrontEnd":
        if self._httpd is not None:
            return self
        front = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "gmm-serve"

            def setup(self):
                super().setup()
                # Slowloris defense: a client that trickles (or never
                # sends) its request times out here instead of parking a
                # handler thread forever.
                self.connection.settimeout(front._read_timeout_s)
                with front._lock:
                    front._connections += 1
                    self._over_cap = (front._connections
                                      > front._max_connections)

            def finish(self):
                with front._lock:
                    front._connections -= 1
                try:
                    super().finish()
                except OSError:
                    pass

            def handle_one_request(self):
                try:
                    super().handle_one_request()
                except (socket.timeout, TimeoutError):
                    self.close_connection = True

            def do_GET(self):  # noqa: N802 (http.server API)
                front._handle_get(self)

            def do_POST(self):  # noqa: N802
                front._handle_post(self)

            def log_message(self, *args):  # keep stderr quiet per request
                pass

        self._httpd = ThreadingHTTPServer(self._requested, _Handler)
        self._httpd.daemon_threads = True
        httpd = self._httpd
        self._thread = threading.Thread(
            target=lambda: httpd.serve_forever(poll_interval=0.02),
            name="gmm-http-front", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- rollup ----------------------------------------------------------

    def live_gauges(self) -> Dict[str, float]:
        gauges = {
            "gmm_http_connections": float(self._connections),
            "gmm_http_requests": float(self.requests),
            "gmm_http_errors_4xx": float(self.errors_4xx),
            "gmm_http_errors_5xx": float(self.errors_5xx),
            "gmm_http_shed_connections": float(self.shed_connections),
        }
        try:
            gauges.update(self._backend.gauges() or {})
        except Exception:
            pass
        return gauges

    def http_rollup(self) -> Dict[str, int]:
        """The ``serve_summary.http`` block: front-end counters plus the
        backend's worker-pool counters (zeros in-process)."""
        rollup = {
            "requests": int(self.requests),
            "errors_4xx": int(self.errors_4xx),
            "errors_5xx": int(self.errors_5xx),
            "shed_connections": int(self.shed_connections),
            "retries": 0, "retries_exhausted": 0, "worker_crashes": 0,
            "worker_respawns": 0, "worker_quarantines": 0, "workers": 0,
        }
        try:
            rollup.update(self._backend.http_stats() or {})
        except Exception:
            pass
        return rollup

    # -- request handling ------------------------------------------------

    def _ready(self) -> bool:
        if self._stopping is not None and self._stopping():
            return False
        try:
            return bool(self._backend.ready())
        except Exception:
            return False

    def _send(self, h, status: int, body: bytes,
              content_type: str = "application/json",
              headers: Optional[Dict[str, str]] = None) -> None:
        try:
            h.send_response(status)
            h.send_header("Content-Type", content_type)
            h.send_header("Content-Length", str(len(body)))
            for key, val in (headers or {}).items():
                h.send_header(key, val)
            h.end_headers()
            h.wfile.write(body)
        except (BrokenPipeError, OSError):
            h.close_connection = True  # client went away mid-reply

    def _send_json(self, h, status: int, obj: dict,
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(h, status, (json.dumps(obj) + "\n").encode("utf-8"),
                   headers=headers)

    def latency_summary(self) -> Dict[str, float]:
        """p50/p99/mean/max over the HTTP edge's request latencies (the
        pool parent's serve_summary.latency_ms; in-process mode uses the
        queue core's own summary)."""
        lat = sorted(self._latencies)
        if not lat:
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}

        def pct(q: float) -> float:
            return lat[min(len(lat) - 1, int(q * (len(lat) - 1) + 0.5))]

        return {"p50": round(pct(0.50), 3), "p99": round(pct(0.99), 3),
                "mean": round(sum(lat) / len(lat), 3),
                "max": round(lat[-1], 3)}

    def _count_status(self, status: int, latency_ms: float,
                      n=None) -> None:
        with self._lock:
            self.requests += 1
            self._latencies.append(latency_ms)
            if isinstance(n, int):
                self.rows += n
            if 400 <= status < 500:
                self.errors_4xx += 1
            elif status >= 500:
                self.errors_5xx += 1

    def _emit(self, h, status: int, t0: float, *, model=None, op=None,
              n=None, error=None, worker=None, retried=None,
              trace_id=None) -> None:
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._count_status(status, latency_ms, n)
        rec = telemetry.current()
        if not rec.active:
            return
        rec.emit("http_request", method=h.command,
                 path=h.path.split("?", 1)[0], status=int(status),
                 latency_ms=round(latency_ms, 3),
                 **{k: v for k, v in (
                     ("model", model), ("op", op), ("n", n),
                     ("error", error), ("worker", worker),
                     ("retried", retried), ("trace_id", trace_id),
                 ) if v is not None})
        rec.metrics.count("http_requests")
        rec.metrics.observe("http.latency_ms", latency_ms)
        if status >= 500:
            rec.metrics.count("http_errors_5xx")
        elif status >= 400:
            rec.metrics.count("http_errors_4xx")

    def _shed_connection(self, h, t0: float) -> None:
        with self._lock:
            self.shed_connections += 1
        h.close_connection = True
        self._emit(h, 503, t0, error="connection_cap")
        rec = telemetry.current()
        if rec.active:
            rec.metrics.count("http_shed_connections")
        self._send_json(
            h, 503,
            {"ok": False, "error": "connection_cap",
             "detail": f"connection cap of {self._max_connections} "
             "reached; retry after backoff"},
            headers={"Retry-After": str(RETRY_AFTER_S),
                     "Connection": "close"})

    def _handle_get(self, h) -> None:
        t0 = time.perf_counter()
        path = h.path.split("?", 1)[0]
        if getattr(h, "_over_cap", False):
            self._shed_connection(h, t0)
            return
        if path == "/healthz":
            self._send_json(h, 200, {"ok": True})
            return  # probes stay out of the request counters
        if path == "/readyz":
            if self._ready():
                self._send_json(h, 200, {"ok": True, "ready": True})
            else:
                self._send_json(
                    h, 503, {"ok": False, "ready": False,
                             "error": "draining"},
                    headers={"Retry-After": str(RETRY_AFTER_S)})
            return
        if path in ("/metrics", "/"):
            rec = telemetry.current()
            snapshot, buckets = {}, {}
            pair_fn = getattr(rec.metrics, "snapshot_with_buckets", None)
            if callable(pair_fn):
                snapshot, buckets = pair_fn()
            else:
                snapshot = rec.metrics.snapshot()
            body = render_openmetrics(snapshot, self.live_gauges(),
                                      buckets).encode("utf-8")
            self._send(h, 200, body,
                       content_type="application/openmetrics-text; "
                       "version=1.0.0; charset=utf-8")
            return
        self._emit(h, 404, t0, error="no_such_endpoint")
        self._send_json(h, 404, {"ok": False, "error": "no_such_endpoint",
                                 "detail": f"no endpoint {path!r}"})

    def _handle_post(self, h) -> None:
        t0 = time.perf_counter()
        if getattr(h, "_over_cap", False):
            self._shed_connection(h, t0)
            return
        path = h.path.split("?", 1)[0]
        route = parse_model_path(path)
        if route is None:
            self._emit(h, 404, t0, error="no_such_endpoint")
            self._send_json(
                h, 404,
                {"ok": False, "error": "no_such_endpoint",
                 "detail": "POST /v1/models/NAME[@VER]:OP with OP one "
                 f"of {', '.join(HTTP_OPS)}"})
            return
        name, version, op = route
        length = h.headers.get("Content-Length")
        if length is None:
            self._emit(h, 411, t0, model=name, op=op,
                       error="length_required")
            self._send_json(h, 411, {"ok": False,
                                     "error": "length_required"})
            return
        try:
            n_bytes = int(length)
        except ValueError:
            self._emit(h, 400, t0, model=name, op=op,
                       error="bad_content_length")
            self._send_json(h, 400, {"ok": False,
                                     "error": "bad_content_length"})
            return
        if n_bytes > self._max_body:
            # Reject WITHOUT reading: the bound exists so an oversized
            # body never occupies memory or the read deadline.
            h.close_connection = True
            self._emit(h, 413, t0, model=name, op=op, error="body_too_large")
            self._send_json(
                h, 413,
                {"ok": False, "error": "body_too_large",
                 "detail": f"body of {n_bytes} bytes exceeds the "
                 f"{self._max_body}-byte bound"},
                headers={"Connection": "close"})
            return
        try:
            body = h.rfile.read(n_bytes)
        except (socket.timeout, TimeoutError, OSError):
            h.close_connection = True  # slowloris body: drop the thread
            return
        ctype = (h.headers.get("Content-Type")
                 or "").split(";", 1)[0].strip().lower()
        if ctype == wire.CONTENT_TYPE:
            # Zero-copy binary payload (docs/SERVING.md "Binary
            # payloads"): the entire body is one x-gmm-rows frame;
            # model/op/version ride the URL, the deadline rides the
            # X-GMM-Deadline-Ms header. Decoded via np.frombuffer --
            # no JSON float parsing on the scoring hot path.
            try:
                x: Any = wire.decode_rows(body)
            except wire.WireError as e:
                self._emit(h, 400, t0, model=name, op=op,
                           error="bad_frame")
                self._send_json(h, 400,
                                {"ok": False, "error": "bad_frame",
                                 "detail": str(e)})
                return
            payload: Dict[str, Any] = {}
        else:
            try:
                payload = (json.loads(body.decode("utf-8"))
                           if n_bytes else {})
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                self._emit(h, 400, t0, model=name, op=op,
                           error="bad_json")
                self._send_json(h, 400, {"ok": False, "error": "bad_json",
                                         "detail": str(e)})
                return
            x = payload.get("x")
        req = {"model": name, "op": op, "x": x}
        if version is not None:
            req["version"] = version
        if payload.get("id") is not None:
            req["id"] = payload["id"]
        deadline_hdr = h.headers.get("X-GMM-Deadline-Ms")
        if deadline_hdr is not None:
            try:
                req["deadline_ms"] = float(deadline_hdr)
            except ValueError:
                self._emit(h, 400, t0, model=name, op=op,
                           error="bad_deadline")
                self._send_json(
                    h, 400, {"ok": False, "error": "bad_deadline",
                             "detail": "X-GMM-Deadline-Ms must be a "
                             "number"})
                return
        elif payload.get("deadline_ms") is not None:
            req["deadline_ms"] = payload["deadline_ms"]
        trace_id = h.headers.get("X-GMM-Trace-Id") or None
        try:
            resp, meta = self._backend.score(req, trace_id=trace_id)
        except Exception as e:  # backend must never kill the handler
            self._emit(h, 500, t0, model=name, op=op,
                       error=f"backend error: {e}")
            self._send_json(h, 500, {"ok": False,
                                     "error": f"backend error: {e}"})
            return
        trace_out = resp.get("trace_id") or trace_id
        headers = {}
        if trace_out:
            headers["X-GMM-Trace-Id"] = str(trace_out)
        if resp.get("ok"):
            status = 200
        else:
            status = status_for_error(str(resp.get("error") or ""))
            if status in (429, 503):
                headers["Retry-After"] = str(RETRY_AFTER_S)
        self._emit(h, status, t0, model=name, op=op,
                   n=resp.get("n"),
                   error=None if resp.get("ok") else resp.get("error"),
                   worker=meta.get("worker"), retried=meta.get("retried"),
                   trace_id=trace_out)
        self._send_json(h, status, resp, headers=headers)
