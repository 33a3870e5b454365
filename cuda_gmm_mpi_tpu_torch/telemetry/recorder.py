"""RunRecorder: the run-scoped event bus of the port's fit paths.

The port's own copy of the JAX package's ``telemetry/recorder.py``: one
recorder spans one fit, stamps every record with the schema version, a run
id, and this process's rank, and appends JSON lines to the configured sink
(``GMMConfig.metrics_file`` / ``--metrics-file``; default off).

On a mesh every rank runs the instrumentation (its registry accumulates)
but only rank 0 of the torch.distributed world writes the file.

Activation is run-scoped, not global: ``with use(recorder):`` makes it the
ambient recorder that instrumented layers find via ``current()`` (models
never thread a recorder argument through their signatures). The default
ambient recorder is inert, so uninstrumented library use costs one
attribute check per touchpoint.

``write_line`` is the shared one-JSON-object-per-line formatter.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .registry import MetricsRegistry
from .schema import SCHEMA_VERSION


def _json_default(o):
    """Coerce numpy scalars/arrays (the usual payload types) to JSON."""
    item = getattr(o, "item", None)
    if callable(item):
        try:
            return o.item()
        except (TypeError, ValueError):
            pass
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return o.tolist()
    return str(o)


def write_line(record: Dict[str, Any], stream=None) -> str:
    """Write one record as a compact JSON line; returns the line."""
    line = json.dumps(record, default=_json_default)
    print(line, file=stream or sys.stderr)
    return line


def _clock_pair() -> Dict[str, float]:
    """An atomically-sampled (wall, mono) clock pair (stream rev v2.3).

    ``wall`` is CLOCK_REALTIME (``time.time()``), ``mono`` the process
    monotonic clock (``time.perf_counter()``) -- sampled back-to-back,
    with the wall read bracketed by two mono reads so the pair's skew is
    bounded by half the bracket width. One pair per stream head plus one
    per heartbeat lets ``gmm timeline`` estimate every stream's
    mono->wall offset (and its drift) and merge multi-rank / fit+serve
    streams onto one timebase (docs/OBSERVABILITY.md "Timeline export").
    """
    m0 = time.perf_counter()
    wall = time.time()
    m1 = time.perf_counter()
    return {"wall": round(wall, 6), "mono": round((m0 + m1) / 2.0, 6)}


class RunRecorder:
    """Schema-versioned JSONL event bus for one run.

    ``path``: JSONL sink file (truncated at first emit -- one run, one
    stream; rank 0 only). ``stream``: an open text stream sink instead
    (tests). ``stderr_passthrough``: additionally mirror every record to
    stderr in the legacy ``metrics_line`` format. With neither path nor
    stream the recorder is inert (``active`` False) and every method is a
    cheap no-op.
    """

    def __init__(self, path: Optional[str] = None, stream=None,
                 stderr_passthrough: bool = False,
                 heartbeat_interval_s: float = 30.0,
                 run_id: Optional[str] = None):
        self._path = path
        self._stream = stream
        self._stderr = stderr_passthrough
        self._fh = None
        self._lock = threading.Lock()
        self._context: Dict[str, Any] = {}
        self._process: Optional[int] = None
        self._writer: Optional[bool] = None
        self._heartbeat_interval_s = heartbeat_interval_s
        # 0.0 (not t0): the first heartbeat() call emits immediately --
        # one early liveness mark per run -- then rate-limiting kicks in.
        self._last_heartbeat = 0.0
        self._t0 = time.perf_counter()
        self._emitted = False
        # v2.3: the recorder-start clock pair (CLOCK_REALTIME wall +
        # perf_counter mono, sampled back-to-back). The stream head
        # carries it alongside a fresh emit-time pair so readers get two
        # alignment anchors even before the first heartbeat.
        self._clock0 = _clock_pair()
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.metrics = MetricsRegistry()

    @property
    def active(self) -> bool:
        return self._path is not None or self._stream is not None

    @property
    def emitted(self) -> bool:
        """Whether any record has been emitted -- i.e. the stream is open.

        The owning loop's first record (``run_start`` / the first serve
        event) defines the stream head; background observers
        (telemetry.profiling's CompileWatch) consult this to buffer
        their records until the head is written, preserving the
        stream-ordering contract (docs/OBSERVABILITY.md).
        """
        return self._emitted

    def set_context(self, **fields) -> None:
        """Merge static fields into every subsequent record (None drops)."""
        with self._lock:
            for k, v in fields.items():
                if v is None:
                    self._context.pop(k, None)
                else:
                    self._context[k] = v

    def _resolve_process(self) -> None:
        # Deferred to the first emit: a recorder built before the
        # torch.distributed world comes up still learns its rank.
        if self._process is not None:
            return
        import torch.distributed as dist

        self._process = (int(dist.get_rank())
                         if dist.is_available() and dist.is_initialized()
                         else 0)
        self._writer = self._process == 0

    def _sink(self):
        if self._stream is not None:
            return self._stream
        if self._fh is None and self._path is not None:
            # Truncate: one run, one stream. Rank 0 only (host-0
            # aggregation); other ranks keep accumulating metrics.
            # Line-buffered: paired with the per-record flush in emit()
            # this is the durability guarantee --follow tailers and
            # post-crash forensics rely on (a killed process never
            # leaves a completed record stuck in a userspace buffer,
            # and a reader only ever sees whole lines).
            self._fh = open(self._path, "w", buffering=1, encoding="utf-8")
        return self._fh

    def emit(self, event: str, **fields) -> Optional[dict]:
        """Append one stamped record to the sink; returns the record."""
        if not self.active:
            return None
        self._resolve_process()
        rec: Dict[str, Any] = {
            "event": event,
            "schema": SCHEMA_VERSION,
            "ts": round(time.time(), 6),
            # Process-monotonic sibling of ts (rev v2.1): report/--follow
            # compute durations from mono_s deltas, immune to wall-clock
            # slew. Comparable only within one process's records.
            "mono_s": round(time.perf_counter(), 6),
            "run_id": self.run_id,
            "process": self._process,
        }
        rec.update(self._context)
        rec.update(fields)
        # v2.3 alignment anchors: the stream head (run_start / a serve
        # stream's first record) and every heartbeat carry an
        # atomically-sampled wall/mono clock pair; the head additionally
        # carries the recorder-construction pair (clock0) so even a
        # heartbeat-free stream holds two anchors for drift estimation.
        # Explicit-kwarg clock (tests, replayers) wins.
        if "clock" not in fields:
            if not self._emitted:
                rec["clock"] = _clock_pair()
                rec["clock0"] = dict(self._clock0)
            elif event == "heartbeat":
                rec["clock"] = _clock_pair()
        self._emitted = True
        with self._lock:
            if self._writer:
                sink = self._sink()
                if sink is not None:
                    sink.write(json.dumps(rec, default=_json_default) + "\n")
                    sink.flush()  # crash-robust: every record is durable
            if self._stderr:
                write_line(rec)
        return rec

    def heartbeat(self, phase: str, **fields) -> None:
        """Rate-limited liveness record (at most one per interval)."""
        if not self.active:
            return
        now = time.perf_counter()
        if now - self._last_heartbeat < self._heartbeat_interval_s:
            return
        self._last_heartbeat = now
        self.emit("heartbeat", phase=phase,
                  elapsed_s=round(now - self._t0, 3), **fields)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NULL = RunRecorder()  # inert ambient default
_stack: List[RunRecorder] = []


def current() -> RunRecorder:
    """The ambient recorder (inert unless a run activated one)."""
    return _stack[-1] if _stack else _NULL


@contextlib.contextmanager
def use(recorder: RunRecorder):
    """Make ``recorder`` the ambient recorder for the enclosed run."""
    _stack.append(recorder)
    try:
        yield recorder
    finally:
        _stack.pop()


def read_stream(path: str) -> List[dict]:
    """Decode a JSONL metrics file; raises OSError/ValueError on bad input."""
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from None
    return records


def memory_stats(device=None) -> Optional[dict]:
    """The CUDA device's allocator counters under the JAX package's key
    names (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), or
    None for a CPU device. ``device=None`` reads the current CUDA device
    once this process has initialized CUDA (the JAX package's first local
    device), else None.

    Only the caching allocator's counters and the cached device
    properties are read: no CUDA call that a stream capture forbids, so
    the resource sampler's thread may call this while a fit captures.
    The peak is never reset (the compile watch takes deltas of it)."""
    import torch

    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if torch.device(device).type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device).total_memory),
    }
