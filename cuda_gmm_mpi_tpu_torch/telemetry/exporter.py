"""OpenMetrics exporter + resource sampler: the pull half of the live plane.

Stream rev v2.1 (docs/OBSERVABILITY.md "Live metrics endpoint"). The JSONL
stream is post-hoc by construction; this module makes the SAME counters
observable while the run is still going, with stdlib only:

* :class:`MetricsExporter` -- a daemon :class:`~http.server.ThreadingHTTPServer`
  serving ``GET /metrics`` in the Prometheus/OpenMetrics text exposition
  format, rendered on demand from a live :class:`~.registry.MetricsRegistry`
  snapshot (counters / gauges / histogram rollups) plus whatever run gauges
  the owning loop provides via a callable (current K, serve queue depth,
  breaker states, elastic generation, ...). An ``em_iters``-rate gauge
  (``gmm_em_iters_per_s``) is derived between scrapes. Enabled via
  ``GMMConfig.metrics_port`` / ``--metrics-port``; port 0 binds an
  OS-assigned ephemeral port (tests; the bound port is on ``.port``).

* :class:`ResourceSampler` -- a daemon thread that periodically stamps
  device ``memory_stats()`` (HBM in-use / peak) and host RSS onto
  ``heartbeat`` records, so memory high-water lands on the stream during
  the run instead of exactly once at ``run_start``.

Both are strictly additive: nothing here starts unless ``metrics_port``
is set, keeping disabled-plane runs byte-identical to pre-v2.1.

The port's own copy of the JAX package's ``telemetry/exporter.py``, with
the same metric names. The sampler reads the fit's device (``device``):
``recorder.memory_stats`` reads only the CUDA caching allocator's
counters, so neither thread makes a CUDA call that a stream capture in
the fit's thread forbids (the EM programs capture in the default
``global`` mode while the plane runs); no ``synchronize`` and no
``mem_get_info`` here.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from . import recorder as _recorder

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")

# The most recently started exporter (None when stopped). Lets a caller
# that enabled the plane deep inside a fit (--metrics-port=0 binds an
# OS-assigned port) discover the bound port: tests and bench scrape
# ``current_exporter().port`` instead of plumbing the exporter out
# through every fit signature.
_current: Optional["MetricsExporter"] = None


def current_exporter() -> Optional["MetricsExporter"]:
    """The live exporter, if one is running in this process."""
    return _current

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(key: str, prefix: str = "gmm_") -> str:
    """Registry key -> exposition metric name (``serve.latency_ms`` ->
    ``gmm_serve_latency_ms``)."""
    name = _NAME_RE.sub("_", key)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return prefix + name


def host_rss_bytes() -> Optional[int]:
    """This process's resident set size, psutil-free.

    ``/proc/self/status`` VmRSS where available (Linux); falls back to
    ``getrusage`` ru_maxrss (a HIGH-WATER mark, not instantaneous -- still
    the right bound for a memory gauge); None where neither works.
    """
    try:
        with open("/proc/self/status", "r", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return None


def _fmt(value: Any) -> str:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(snapshot: Dict[str, Dict[str, Any]],
                       extra_gauges: Optional[Dict[str, Any]] = None,
                       buckets: Optional[Dict[str, Any]] = None) -> str:
    """Registry snapshot (+ run gauges) -> OpenMetrics text exposition.

    Counters become ``gmm_<name>_total``; gauges stay gauges. A
    histogram with fixed-bucket counts available (rev v2.2;
    ``buckets[key]`` = per-bucket counts over
    ``registry.BUCKET_BOUNDS`` + the +Inf slot) renders as a real
    OpenMetrics histogram -- cumulative ``_bucket{le=...}`` lines, so
    serve latency p50/p99 are scrapeable -- with the extremes as
    separate ``_minimum`` / ``_maximum`` gauge families (``_min`` /
    ``_max`` are not valid histogram sample suffixes, and a strict
    parser may reject the whole scrape over them); one without bucket
    counts keeps the old summary rendering, ``_min`` / ``_max`` gauges
    included, byte-identical to pre-v2.2. ``extra_gauges`` keys are
    already full metric names (the owning loop namespaces them). Ends
    with the mandatory ``# EOF``.
    """
    from .registry import BUCKET_BOUNDS

    lines = []
    for key, value in sorted((snapshot.get("counters") or {}).items()):
        name = metric_name(key)
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}_total {_fmt(value)}")
    for key, value in sorted((snapshot.get("gauges") or {}).items()):
        name = metric_name(key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(value)}")
    for key, h in sorted((snapshot.get("histograms") or {}).items()):
        name = metric_name(key)
        counts = (buckets or {}).get(key)
        if counts:
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for le, n in zip(BUCKET_BOUNDS, counts):
                cum += int(n)
                lines.append(
                    f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
            cum += int(counts[len(BUCKET_BOUNDS)]) \
                if len(counts) > len(BUCKET_BOUNDS) else 0
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        else:
            lines.append(f"# TYPE {name} summary")
        lines.append(f"{name}_count {_fmt(h.get('count', 0))}")
        lines.append(f"{name}_sum {_fmt(h.get('sum', 0.0))}")
        for agg in ("min", "max"):
            if agg in h:
                # Histogram form: the extremes get family names a strict
                # parser cannot read as suffixed samples of ``name``.
                suffix = agg if not counts else agg + "imum"
                lines.append(f"# TYPE {name}_{suffix} gauge")
                lines.append(f"{name}_{suffix} {_fmt(h[agg])}")
    for key, value in sorted((extra_gauges or {}).items()):
        name = _NAME_RE.sub("_", str(key))
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """``GET /metrics`` endpoint over a live registry.

    ``registry_provider`` returns the CURRENT registry (a callable, not a
    snapshot -- elastic retries swap recorders); ``gauges_provider`` (may
    be None) returns ``{full_metric_name: value}`` run gauges evaluated
    per scrape. Binds localhost by default: an observability endpoint is
    not a public service.
    """

    def __init__(self, registry_provider: Callable[[], Any],
                 gauges_provider: Optional[Callable[[], Dict[str, Any]]] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self._registry_provider = registry_provider
        self._gauges_provider = gauges_provider
        self._requested = (host, int(port))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last_scrape: Optional[tuple] = None  # (mono_s, em_iters)
        self.scrapes = 0

    @property
    def port(self) -> Optional[int]:
        """The BOUND port (resolves port 0 after start())."""
        return self._httpd.server_address[1] if self._httpd else None

    def render(self) -> str:
        buckets: Dict[str, Any] = {}
        try:
            registry = self._registry_provider()
            if registry is None:
                snapshot = {}
            else:
                # Fixed-bucket counts (rev v2.2): kept out of snapshot()
                # so run_summary.metrics stays byte-stable; the scrape
                # endpoint is where the buckets surface. One atomic
                # locked read -- a histogram's _count and its cumulative
                # +Inf bucket must agree on the same exposition.
                pair_fn = getattr(registry, "snapshot_with_buckets", None)
                if callable(pair_fn):
                    snapshot, buckets = pair_fn()
                else:
                    snapshot = registry.snapshot()
        except Exception:
            snapshot = {}
        gauges: Dict[str, Any] = {}
        if self._gauges_provider is not None:
            try:
                gauges.update(self._gauges_provider() or {})
            except Exception:
                pass
        # Derived rate: em_iters/s between scrapes (0 until the second
        # scrape -- a rate needs two samples).
        now = time.perf_counter()
        iters = (snapshot.get("counters") or {}).get("em_iters")
        with self._lock:
            self.scrapes += 1
            if iters is not None:
                rate = 0.0
                if self._last_scrape is not None:
                    dt = now - self._last_scrape[0]
                    if dt > 0:
                        rate = max(0.0, (iters - self._last_scrape[1]) / dt)
                self._last_scrape = (now, iters)
                gauges.setdefault("gmm_em_iters_per_s", round(rate, 3))
        return render_openmetrics(snapshot, gauges, buckets)

    def start(self) -> "MetricsExporter":
        if self._httpd is not None:
            return self
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer(self._requested, _Handler)
        self._httpd.daemon_threads = True
        httpd = self._httpd
        # Tight poll: serve_forever's default 0.5s poll makes stop()
        # (which joins the shutdown) add up to half a second to every
        # fit's teardown -- visible noise in the --obs overhead A/B.
        self._thread = threading.Thread(
            target=lambda: httpd.serve_forever(poll_interval=0.02),
            name="gmm-metrics-exporter", daemon=True)
        self._thread.start()
        global _current
        _current = self
        return self

    def stop(self) -> None:
        global _current
        if _current is self:
            _current = None
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


class ResourceSampler:
    """Periodic memory stamps on the heartbeat lane.

    Emits a ``heartbeat`` record (``sampler: true``) every ``interval_s``
    with host RSS and device ``memory_stats()``, via the recorder's
    thread-safe ``emit`` -- bypassing the liveness heartbeat's rate
    limiter, which exists to keep PASSIVE phases quiet, not to throttle
    an explicitly requested sampler.
    """

    def __init__(self, recorder: Optional[Any] = None,
                 interval_s: float = 10.0, phase: str = "sampler",
                 device=None):
        self._recorder = recorder
        self._device = device
        self._interval_s = max(0.05, float(interval_s))
        self._phase = phase
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0

    def _rec(self):
        return (self._recorder if self._recorder is not None
                else _recorder.current())

    def sample_once(self) -> Optional[dict]:
        rec = self._rec()
        if not rec.active:
            return None
        fields: Dict[str, Any] = {"sampler": True}
        rss = host_rss_bytes()
        if rss is not None:
            fields["rss_bytes"] = rss
        stats = _recorder.memory_stats(self._device)
        if stats is not None:
            # memory_stats() values are ints already; keep the dict JSON
            # round-trippable even if a plugin hands back numpy scalars.
            fields["memory_stats"] = json.loads(
                json.dumps(stats, default=_recorder._json_default))
        self.samples += 1
        return rec.emit(
            "heartbeat", phase=self._phase,
            elapsed_s=round(time.perf_counter() - rec._t0, 3), **fields)

    def _loop(self):
        # Sample-then-wait: the first stamp lands immediately, so even a
        # run shorter than one interval gets its resource mark.
        while True:
            try:
                self.sample_once()
            except Exception:
                # The sampler must never take the run down: a flaky
                # device-stats plugin degrades to missing samples.
                pass
            if self._stop.wait(self._interval_s):
                return

    def start(self) -> "ResourceSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="gmm-resource-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def live_plane(port: Optional[int],
               registry_provider: Callable[[], Any],
               gauges_provider: Optional[Callable[[], Dict[str, Any]]] = None,
               recorder: Optional[Any] = None,
               sampler_interval_s: float = 10.0, device=None):
    """The one-call composition every long-running path uses: exporter +
    resource sampler, both on iff ``port`` is not None (the
    ``--metrics-port`` gate). Yields the exporter (None when disabled).
    ``device``: the fit's torch device, whose memory the sampler reads."""
    if port is None:
        yield None
        return
    import os

    # Tests and the --obs benchmark shrink the cadence without plumbing
    # an interval through every fit signature.
    sampler_interval_s = float(
        os.environ.get("GMM_SAMPLER_INTERVAL_S") or sampler_interval_s)
    with MetricsExporter(registry_provider, gauges_provider,
                         port=port) as exporter:
        with ResourceSampler(recorder, interval_s=sampler_interval_s,
                             device=device):
            yield exporter
