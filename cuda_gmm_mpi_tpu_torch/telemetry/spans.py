"""Trace spans: fit/request-scoped timing trees on the telemetry stream.

Stream rev v2.1 (docs/OBSERVABILITY.md "Trace spans"). A *trace* is one
logical unit of work -- a whole fit, or one serve route dispatch -- named
by a ``trace_id``; a *span* is one timed phase inside it (sweep, per-K
EM, checkpoint save, recovery, the serve prepare/dispatch/answer hops),
emitted as a ``span``-typed record when the phase completes: name, this
span's id, its parent span's id, start (``t0_mono_s``, process-monotonic)
and measured ``duration_s``. Parentage nests lexically via a thread-local
span stack, so the records of one trace reconstruct into a single-rooted
tree (:func:`build_span_tree`) with zero coordination at emit time.

Spans are part of the live observability plane and are OFF by default:
:func:`span` is a no-op unless a :func:`trace` is active on the calling
thread (fits activate one only when ``GMMConfig.metrics_port`` is set;
``gmm serve`` per route batch under ``--metrics-port``), so with the
plane disabled the stream stays byte-identical to pre-v2.1 runs.

Emission rides the ambient :class:`~.recorder.RunRecorder` -- the JSONL
stream stays the single source of truth; the exporter and ``gmm report``
both read spans from it rather than from a side channel.

The port's own copy of the JAX package's ``telemetry/spans.py``: the
same records, so either package's ``gmm report`` renders the tree.
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from . import recorder as _recorder


def mint_trace_id() -> str:
    """A fresh trace identity (16 hex chars; uuid4-derived)."""
    return uuid.uuid4().hex[:16]


def _mint_span_id() -> str:
    return uuid.uuid4().hex[:16]


class _TraceState(threading.local):
    """Per-thread active trace: id + open-span stack (parentage)."""

    def __init__(self):
        self.trace_id: Optional[str] = None
        self.stack: List[str] = []
        # Parallel to ``stack``: the open spans' NAMES, so observers
        # (telemetry/profiling.py tags compile events with the active
        # phase) can ask "where are we?" without a span-id lookup.
        self.names: List[str] = []


_tls = _TraceState()


def active() -> bool:
    """True when a trace is active on this thread (spans will emit)."""
    return _tls.trace_id is not None


def current_trace_id() -> Optional[str]:
    return _tls.trace_id


def current_span_name() -> Optional[str]:
    """The innermost open span's name on this thread (None outside any
    span -- including always when no trace is active)."""
    return _tls.names[-1] if _tls.names else None


@contextlib.contextmanager
def trace(trace_id: Optional[str] = None):
    """Activate a trace on this thread for the enclosed block.

    Nested activation reuses the outer trace (one tree per unit of work,
    however deep the call stack); pass an explicit ``trace_id`` to join
    records to an identity minted elsewhere (serve requests).
    """
    if _tls.trace_id is not None:
        yield _tls.trace_id
        return
    tid = trace_id or mint_trace_id()
    _tls.trace_id = tid
    try:
        yield tid
    finally:
        _tls.trace_id = None
        _tls.stack = []
        _tls.names = []


class _OpenSpan:
    """A begun-but-unfinished span (the non-lexical API's handle)."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "t0",
                 "fields", "recorder")

    def __init__(self, name, span_id, parent_id, trace_id, t0, fields,
                 recorder):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.t0 = t0
        self.fields = fields
        self.recorder = recorder


def begin(name: str, recorder: Optional[Any] = None,
          **fields) -> Optional[_OpenSpan]:
    """Non-lexical span start, for phases a ``with`` block cannot wrap
    (a sweep loop with mid-loop raises). Returns None -- and :func:`end`
    accepts None -- when no trace is active, so call sites need no gate.
    A begun span that never reaches :func:`end` (exception path) simply
    never emits; its completed children are orphan-promoted by
    :func:`build_span_tree`."""
    rec = recorder if recorder is not None else _recorder.current()
    tid = _tls.trace_id
    if tid is None or not rec.active:
        return None
    handle = _OpenSpan(name, _mint_span_id(),
                       _tls.stack[-1] if _tls.stack else None,
                       tid, time.perf_counter(), dict(fields), rec)
    _tls.stack.append(handle.span_id)
    _tls.names.append(name)
    return handle


def end(handle: Optional[_OpenSpan], status: str = "ok",
        **fields) -> Optional[dict]:
    """Finish a :func:`begin` span: emit its record and pop the stack
    (including any abandoned descendants a raise left behind)."""
    if handle is None:
        return None
    if handle.span_id in _tls.stack:
        i = _tls.stack.index(handle.span_id)
        del _tls.stack[i:]
        del _tls.names[i:]
    extra: Dict[str, Any] = dict(handle.fields)
    extra.update(fields)
    if handle.parent_id is not None:
        extra["parent_id"] = handle.parent_id
    return handle.recorder.emit(
        "span", name=handle.name, span_id=handle.span_id,
        trace_id=handle.trace_id, t0_mono_s=round(handle.t0, 6),
        duration_s=round(time.perf_counter() - handle.t0, 6),
        # rev v2.3: the emitting OS thread, so timeline readers can lane
        # concurrent serve routes separately (spans nest per thread by
        # construction, but only per thread).
        thread=threading.get_native_id(),
        status=status, **extra)


@contextlib.contextmanager
def span(name: str, recorder: Optional[Any] = None, **fields):
    """Emit a ``span`` record around the enclosed block.

    No-op (yields None) unless a trace is active on this thread AND the
    recorder has a sink -- both gates keep the disabled-plane stream
    byte-identical. A raising block still closes its span, with
    ``status="error"`` so a truncated tree is distinguishable from a
    crash mid-phase.
    """
    handle = begin(name, recorder=recorder, **fields)
    if handle is None:
        yield None
        return
    status = "ok"
    try:
        yield handle.span_id
    except BaseException:
        status = "error"
        raise
    finally:
        end(handle, status=status)


def build_span_tree(records) -> List[dict]:
    """Reconstruct span trees from decoded stream records.

    Returns the list of root nodes (one per trace in a healthy stream),
    each ``{"span": <record>, "children": [...]}`` with children ordered
    by start time. Orphans (a parent id that never completed -- crash
    mid-phase) are promoted to roots rather than dropped.
    """
    spans = [r for r in records if r.get("event") == "span"]
    by_id = {s["span_id"]: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        node = by_id[s["span_id"]]
        parent = by_id.get(s.get("parent_id"))
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)

    def _t0(node):
        return node["span"].get("t0_mono_s", 0.0)

    for node in by_id.values():
        node["children"].sort(key=_t0)
    roots.sort(key=_t0)
    return roots
