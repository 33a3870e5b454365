"""Compile & memory introspection on torch: the CompileWatch (stream rev v2.2).

The port's own copy of the JAX package's ``telemetry/profiling.py``. All
instruments are inert unless a :class:`CompileWatch` is active (the
``watch()`` context, entered by ``fit_gmm`` only when a recorder is
already active, so no-recorder runs pay nothing):

* **Site compiles** -- the port runs no XLA: its "executables" are built
  by the port itself, and each build reports through :func:`site_compile`
  as one ``compile`` event (``source: "aot"``, the site, its wall seconds,
  the active span or phase, and the site's own fields):

  - ``kernel_library``: one CUDA kernel library built with nvcc (where it
    is not built yet) and loaded (``ops/kernels/_build.py``);
  - ``em_program``: one EM program's CUDA-graph capture at one padded
    width (warm-up and the two graphs; ``models/em_program.py``);
  - ``fused_sweep``: the fused sweep's per-K step graph at one width
    (``models/fused_sweep.py``).

  A capture adds its graph pool's bytes under ``graph_pool_bytes`` (the
  event's field and the maximum in ``snapshot()['memory']``). No compiler
  runs, so no compile listener exists: ``snapshot()``'s ``xla_compiles``
  and ``xla_compile_seconds`` stay 0, and no flop or byte cost is
  estimated (there is no ``cost`` section).

* **Device memory watermarks** -- :func:`wm_begin`/:func:`wm_end` (and
  the lexical :func:`watermark`) take ``recorder.memory_stats`` of the
  watch's device at span boundaries (``sweep`` / ``em_k``): the caching
  allocator's peak (monotone: never reset here) and the in-use delta;
  inert on a CPU device.

The watch feeds the metrics registry under ``compiles`` /
``compile_seconds`` / ``hbm_peak_bytes``, which the OpenMetrics exporter
renders as ``gmm_compiles_total`` / ``gmm_compile_seconds_total`` /
``gmm_hbm_peak_bytes``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Optional

from . import recorder as _recorder
from . import spans as _spans

_register_lock = threading.Lock()
_current: Optional["CompileWatch"] = None


class _SiteState(threading.local):
    """Per-thread phase label for compile attribution when no trace span
    is open (metrics-file-only runs have no span stack)."""

    def __init__(self):
        self.tag: Optional[str] = None


_tls = _SiteState()


def active() -> Optional["CompileWatch"]:
    """The process-global active watch (None = all instruments inert)."""
    return _current


class CompileWatch:
    """Accumulating compile/memory observations for one run.

    Thread-safe. ``snapshot()`` is the ``run_summary.profile`` payload;
    per-observation detail lands on the stream as ``compile`` events
    through the ambient recorder. ``device`` is the fit's torch device,
    whose memory the watermarks read.
    """

    def __init__(self, recorder: Optional[Any] = None, device=None):
        self._recorder = recorder
        self.device = device
        self._lock = threading.Lock()
        # Shadowed outer watch (set by watch(); _register_lock-guarded).
        self._prev: Optional["CompileWatch"] = None
        # ``compile`` records observed before the owning loop wrote the
        # stream head (a kernel library loaded before run_start): held
        # here and flushed behind the head, so run_start stays first.
        self._pending: list = []
        self.compiles = 0
        self.compile_seconds = 0.0
        self.by_phase: Dict[str, Dict[str, float]] = {}
        self.sites: Dict[str, Dict[str, float]] = {}
        self.memory: Dict[str, int] = {}       # max over compiles
        self.watermarks: Dict[str, Dict[str, int]] = {}
        self.hbm_peak_bytes: Optional[int] = None

    def _rec(self):
        rec = self._recorder
        return rec if rec is not None else _recorder.current()

    def _emit_compile(self, rec, fields: Dict[str, Any]) -> None:
        """Emit one ``compile`` record, holding it back until the recorder
        has written its stream head (then the held ones go first)."""
        with self._lock:
            if not getattr(rec, "emitted", True):
                self._pending.append(fields)
                return
            pending, self._pending = self._pending, []
        for f in pending:
            rec.emit("compile", **f)
        rec.emit("compile", **fields)

    def flush(self, force: bool = False) -> None:
        """Drain held ``compile`` records once the stream is open (``force``
        at watch exit: regardless, so a head-less stream still gets
        them)."""
        rec = self._rec()
        if not rec.active or not (force or getattr(rec, "emitted", True)):
            return
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            rec.emit("compile", **f)

    def _tag(self) -> Optional[str]:
        return _spans.current_span_name() or _tls.tag

    def _fold_phase(self, tag: Optional[str], seconds: float) -> None:
        if not tag:
            return
        slot = self.by_phase.setdefault(tag, {"compiles": 0,
                                              "seconds": 0.0})
        slot["compiles"] += 1
        slot["seconds"] = round(slot["seconds"] + seconds, 6)

    def observe_site(self, site: str, seconds: float,
                     memory: Optional[dict] = None, **fields) -> None:
        """Fold one site build (and emit its event)."""
        tag = self._tag()
        with self._lock:
            self.compiles += 1
            self.compile_seconds += seconds
            slot = self.sites.setdefault(site, {"compiles": 0,
                                                "seconds": 0.0})
            slot["compiles"] += 1
            slot["seconds"] = round(slot["seconds"] + seconds, 6)
            self._fold_phase(tag, seconds)
            for k, v in (memory or {}).items():
                self.memory[k] = max(self.memory.get(k, 0), int(v))
        rec = self._rec()
        if not rec.active:
            return
        rec.metrics.count("compiles")
        rec.metrics.count("compile_seconds", round(seconds, 6))
        self._emit_compile(rec, dict(
            source="aot", site=site, seconds=round(seconds, 6),
            **({"phase": tag} if tag else {}), **(memory or {}), **fields))

    def observe_watermark(self, name: str, before: Optional[dict],
                          after: Optional[dict]) -> None:
        """Fold one span boundary's device memory delta."""
        if not after:
            return
        peak = after.get("peak_bytes_in_use")
        in_use = after.get("bytes_in_use")
        base = (before or {}).get("bytes_in_use")
        with self._lock:
            w = self.watermarks.setdefault(
                name, {"sections": 0, "peak_bytes": 0, "delta_bytes": 0})
            w["sections"] += 1
            if peak is not None:
                w["peak_bytes"] = max(w["peak_bytes"], int(peak))
                self.hbm_peak_bytes = max(self.hbm_peak_bytes or 0,
                                          int(peak))
            if in_use is not None and base is not None:
                w["delta_bytes"] = max(w["delta_bytes"],
                                       int(in_use) - int(base))
            hbm = self.hbm_peak_bytes
        rec = self._rec()
        if rec.active and hbm is not None:
            rec.metrics.gauge("hbm_peak_bytes", hbm)

    def snapshot(self) -> dict:
        """The ``run_summary.profile`` payload (the JAX package's keys;
        empty sections omitted, the XLA counters 0)."""
        # Held compile records go on the stream BEFORE run_summary.
        self.flush()
        with self._lock:
            out: Dict[str, Any] = {
                "compiles": int(self.compiles),
                "compile_seconds": round(self.compile_seconds, 6),
                "xla_compiles": 0,
                "xla_compile_seconds": 0.0,
            }
            if self.sites:
                out["sites"] = {k: dict(v) for k, v in self.sites.items()}
            if self.by_phase:
                out["by_phase"] = {k: dict(v)
                                   for k, v in self.by_phase.items()}
            if self.memory:
                out["memory"] = dict(self.memory)
            if self.watermarks:
                out["watermarks"] = {k: dict(v)
                                     for k, v in self.watermarks.items()}
            if self.hbm_peak_bytes is not None:
                out["hbm_peak_bytes"] = int(self.hbm_peak_bytes)
            return out


@contextlib.contextmanager
def watch(recorder: Optional[Any] = None, device=None):
    """Activate a :class:`CompileWatch` for the enclosed run.

    Process-global (a capture may run in any thread); nested activation
    shadows the outer watch and restores it on exit, and watches exiting
    out of order splice themselves out of the shadow chain (the JAX
    package's rule). Callers gate activation on an active recorder."""
    global _current
    w = CompileWatch(recorder, device)
    with _register_lock:
        w._prev = _current
        _current = w
    # A sweep that raised through its wm_begin/wm_end pair leaves a
    # stale tag on this thread; a fresh watch must not inherit it.
    _tls.tag = None
    try:
        yield w
    finally:
        with _register_lock:
            if _current is w:
                _current = w._prev
            else:
                node = _current
                while node is not None and node._prev is not w:
                    node = node._prev
                if node is not None:
                    node._prev = w._prev
            w._prev = None
        w.flush(force=True)


def site_compile(site: str, build: Callable[[], Any],
                 memory: Optional[Callable[[Any], dict]] = None, **fields):
    """Run ``build`` (a kernel build or a graph capture) under the active
    watch and return its result.

    No watch: calls ``build`` directly. With one: times it and folds one
    ``compile`` observation of ``site`` with ``fields``; ``memory``, when
    given, maps the built object to its byte counts (e.g. the graph
    pool's). A failed build raises as without the watch."""
    watch_ = _current
    if watch_ is None:
        return build()
    t0 = time.perf_counter()
    built = build()
    seconds = time.perf_counter() - t0
    try:
        watch_.observe_site(site, seconds,
                            memory(built) if memory is not None else None,
                            **fields)
    except Exception:  # noqa: BLE001 -- observability never fails a build
        pass
    return built


# -- watermarks ----------------------------------------------------------

def wm_begin(name: str) -> Optional[tuple]:
    """Open a watermark section at a span boundary.

    Returns an opaque handle for :func:`wm_end` (None when no watch is
    active, so call sites need no gate). Also tags the thread's phase
    label for compile attribution."""
    watch_ = _current
    if watch_ is None:
        return None
    prev_tag, _tls.tag = _tls.tag, name
    return (name, _recorder.memory_stats(watch_.device), prev_tag)


def wm_end(handle: Optional[tuple]) -> None:
    """Close a :func:`wm_begin` section: restore the phase tag and fold
    the device memory delta (inert where memory_stats() is None)."""
    if handle is None:
        return
    name, before, prev_tag = handle
    _tls.tag = prev_tag
    watch_ = _current
    if watch_ is None:
        return
    try:
        watch_.observe_watermark(name, before,
                                 _recorder.memory_stats(watch_.device))
    except Exception:  # noqa: BLE001
        pass


@contextlib.contextmanager
def watermark(name: str):
    """Lexical watermark section (the ``with``-friendly wm_begin/wm_end)."""
    handle = wm_begin(name)
    try:
        yield
    finally:
        wm_end(handle)
