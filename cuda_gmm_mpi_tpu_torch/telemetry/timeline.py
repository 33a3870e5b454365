"""Unified timeline: Perfetto/Chrome trace export with clock alignment.

Stream rev v2.3 (docs/OBSERVABILITY.md "Timeline export"). The recorded
streams are rich but flat: spans, per-iteration EM records, chunk
flushes, serve batches, compile events, resource heartbeats -- each
stamped with ``mono_s``, a clock comparable only *within* one process.
This module is the glue that turns one or more streams (a single file, a
per-rank directory, or a fit stream and a serve stream together) into
ONE Chrome trace-event JSON document that Perfetto / ``chrome://tracing``
loads directly -- the standard operator answer to "where did the time go
across ranks".

Event mapping (the full table lives in docs/OBSERVABILITY.md):

* ``span`` records -> nested ``X`` (complete) duration events, one
  Perfetto track per (stream = pid, emitting thread = tid);
* ``em_iter`` / ``chunk_flush`` / ``serve_batch`` / ``serve_request`` /
  ``http_request`` / ``compile`` -> ``X`` slices with args (loglik,
  prefetch wait, batch rows, HTTP status, flops), each ending at its
  record's emission time;
* sampler ``heartbeat`` resource stamps and stream-derived rates ->
  ``C`` counter tracks (host RSS, device bytes, EM iters/s, queued
  rows), and rev v2.4 ``drift`` windows -> per-model PSI/KS counter
  tracks;
* ``health`` / ``preempt`` / ``elastic_shrink`` / ``circuit`` /
  ``drift_alarm`` / ... -> instant events;
* serve ``trace_id`` s -> flow arrows (``s``/``f``) joining a client's
  request slice to the server-side ``serve_route`` span that answered
  it.

Cross-stream alignment: each stream's records are placed on one shared
wall-clock timebase by estimating the stream's mono->wall mapping
``wall ~= a * mono_s + b`` from its v2.3 ``clock``/``clock0`` anchor
pairs (atomically-sampled wall+mono, emitted at the stream head and on
every heartbeat -- telemetry/recorder.py). With two or more anchors
spread over enough run time the slope ``a`` absorbs clock drift (skew
correction); with one anchor the offset ``b`` alone aligns the stream.
Pre-v2.3 streams fall back to per-record ``(ts, mono_s)`` pairs -- the
same arithmetic but anchored on non-atomic samples -- and the export is
loudly marked ``alignment: estimated`` (metadata + stderr banner).
Records with no ``mono_s`` at all use raw ``ts``.

``gmm timeline`` is the CLI (cli.py); exit codes 0 = exported (and, with
``--validate``, structurally clean), 1 = the emitted document failed its
own ``--validate`` oracle (an exporter bug, not a user error), 2 = usage
error / unreadable stream. ``validate_trace`` is the structural oracle
the tests and ``bench.py --timeline`` reuse.

The port's own copy of the JAX package's ``telemetry/timeline.py``: the
same trace document from the same streams.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from .recorder import read_stream

# Mono-anchor spread below which slope fitting is numerically
# meaningless: with anchors closer than this, drift cannot be told from
# sampling noise, so alignment falls back to a pure offset (a = 1).
MIN_SKEW_SPAN_S = 0.5

# Sanity clamp on the fitted mono->wall slope. Real oscillator drift is
# parts-per-million; anything outside this band means corrupted anchors
# (or a fixture deliberately abusing them), and a wild slope would smear
# every event, so the fit degrades to offset-only instead.
MAX_SKEW = 0.05

# Fixed per-pid tid layout for non-span tracks (span tracks take
# 1..99, one per emitting OS thread, in first-seen order).
_TID_EM = 100        # em_iter / chunk_flush slices
_TID_SERVE = 110     # serve_request / serve_batch slices
_TID_COMPILE = 120   # compile slices
_TID_EVENTS = 130    # instant events

# Record kinds rendered as instant events on the "events" track. The
# remaining kinds (run_start, summaries, em_done, ...) are process-scope
# instants: one-per-run marks rather than moments inside a phase.
_THREAD_INSTANTS = frozenset((
    "health", "recovery", "io_retry", "preempt", "shutdown", "peer_lost",
    "elastic_shrink", "elastic_resume", "circuit", "serve_shed",
    "serve_deadline", "serve_reload", "merge", "rebucket",
    "drift_alarm", "lifecycle", "registry_torn",
    "worker_spawn", "worker_exit",
))
_PROCESS_INSTANTS = frozenset((
    "run_start", "run_summary", "serve_summary", "fleet_start",
    "fleet_summary", "em_done", "tenant_done", "ingest_start",
    "ingest_summary", "restart_select",
))

# Slice args copied verbatim (when present) from the source record.
_SLICE_ARGS = {
    "span": ("k", "status", "trace_id", "span_id", "parent_id"),
    "em_iter": ("k", "iter", "loglik", "delta", "epsilon", "timing"),
    "chunk_flush": ("k", "iter", "block", "chunks", "bytes",
                    "prefetch_wait_s", "compute_s"),
    "serve_batch": ("model", "requests", "rows", "padded_rows",
                    "compiled", "stacked", "version"),
    "serve_request": ("model", "op", "n", "ok", "error", "trace_id",
                      "version"),
    "http_request": ("method", "path", "status", "model", "op", "n",
                     "error", "worker", "retried", "trace_id"),
    "compile": ("source", "site", "phase", "key", "flops",
                "bytes_accessed", "argument_bytes", "output_bytes"),
}


def _num(value) -> Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    f = float(value)
    return f if math.isfinite(f) else None


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    return vs[n // 2] if n % 2 else (vs[n // 2 - 1] + vs[n // 2]) / 2.0


# ---------------------------------------------------------------- alignment


def _anchor_pairs(records: List[dict]) -> List[Tuple[float, float]]:
    """The stream's (mono, wall) alignment anchors from v2.3
    ``clock``/``clock0`` envelope pairs, deduped and mono-sorted."""
    pairs = set()
    for r in records:
        for field in ("clock0", "clock"):
            c = r.get(field)
            if not isinstance(c, dict):
                continue
            mono, wall = _num(c.get("mono")), _num(c.get("wall"))
            if mono is not None and wall is not None:
                pairs.add((mono, wall))
    return sorted(pairs)


def fit_alignment(records: List[dict]) -> dict:
    """Estimate one stream's mono->wall mapping ``wall ~= a*mono + b``.

    Returns ``{"a", "b", "mode", "anchors", "residual_s"}`` where mode is
    ``clock`` (v2.3 atomic anchors), ``estimated`` (pre-v2.3 fallback on
    per-record ``(ts, mono_s)`` pairs), or ``wall`` (no ``mono_s`` at
    all: records map through raw ``ts``, a/b unused). ``residual_s`` is
    the worst anchor's distance from the fit -- the alignment tolerance a
    reader can hold the merge to (heartbeat-pair tolerance).
    """
    pairs = _anchor_pairs(records)
    mode = "clock"
    if not pairs:
        mode = "estimated"
        seen = set()
        for r in records:
            mono, wall = _num(r.get("mono_s")), _num(r.get("ts"))
            if mono is not None and wall is not None:
                seen.add((mono, wall))
        pairs = sorted(seen)
    if not pairs:
        return {"a": 1.0, "b": 0.0, "mode": "wall", "anchors": 0,
                "residual_s": 0.0}
    a = 1.0
    span = pairs[-1][0] - pairs[0][0]
    if len(pairs) >= 2 and span >= MIN_SKEW_SPAN_S:
        # Least-squares slope over the anchors: absorbs mono-vs-wall
        # drift (skew) across a long run. Clamped -- a slope far from 1
        # means garbage anchors, where offset-only alignment is the
        # honest answer.
        mono_mean = sum(m for m, _ in pairs) / len(pairs)
        wall_mean = sum(w for _, w in pairs) / len(pairs)
        var = sum((m - mono_mean) ** 2 for m, _ in pairs)
        if var > 0.0:
            slope = sum((m - mono_mean) * (w - wall_mean)
                        for m, w in pairs) / var
            if abs(slope - 1.0) <= MAX_SKEW:
                a = slope
    b = _median([w - a * m for m, w in pairs])
    residual = max(abs(a * m + b - w) for m, w in pairs)
    return {"a": a, "b": b, "mode": mode, "anchors": len(pairs),
            "residual_s": round(residual, 6)}


def _wall_of(rec: dict, align: dict) -> Optional[float]:
    """One record's emission time on the shared wall timebase."""
    mono = _num(rec.get("mono_s"))
    if mono is not None and align["mode"] != "wall":
        return align["a"] * mono + align["b"]
    return _num(rec.get("ts"))


# ------------------------------------------------------------- trace build


class _Stream:
    """One loaded stream file: its records, alignment, and pid."""

    __slots__ = ("label", "path", "records", "align", "pid", "rank",
                 "tag")

    def __init__(self, label: str, path: str, records: List[dict]):
        self.label = label
        self.path = path
        self.records = records
        self.align = fit_alignment(records)
        self.pid = 0  # assigned by build_timeline
        rank = None
        tag = None
        for r in records:
            if rank is None:
                rank = r.get("rank", r.get("process"))
            if tag is None and isinstance(r.get("path"), str):
                tag = r["path"]
            if rank is not None and tag is not None:
                break
        self.rank = rank if isinstance(rank, int) else 0
        self.tag = tag or "run"


def load_streams(targets: List[str]) -> List[_Stream]:
    """Load every stream behind the targets (files and/or per-rank
    directories). Raises OSError/ValueError on unreadable or empty
    input -- the CLI's exit-2 class."""
    from .diff import stream_files

    streams: List[_Stream] = []
    for target in targets:
        files = stream_files(target)
        if not files:
            raise ValueError(f"{target}: no *.jsonl streams in directory")
        for f in files:
            records = [r for r in read_stream(f) if isinstance(r, dict)]
            if not records:
                raise ValueError(f"{f}: empty stream")
            if not any("event" in r for r in records):
                raise ValueError(f"{f}: not a telemetry stream "
                                 f"(no 'event' records)")
            label = os.path.basename(f)
            if label.endswith(".jsonl"):
                label = label[:-len(".jsonl")]
            if os.path.isdir(target):
                label = f"{os.path.basename(os.path.normpath(target))}/" \
                        f"{label}"
            streams.append(_Stream(label, f, records))
    if not streams:
        raise ValueError("no input streams")
    return streams


def _us(wall: float, t0: float) -> float:
    """Wall seconds -> trace microseconds relative to the export origin."""
    return round((wall - t0) * 1e6, 3)


def _args_for(rec: dict, kind: str) -> Dict[str, Any]:
    out = {}
    for field in _SLICE_ARGS.get(kind, ()):
        if rec.get(field) is not None:
            out[field] = rec[field]
    return out


def _slice_of(rec: dict, align: dict) -> Optional[Tuple[float, float]]:
    """(start_wall, duration_s) of one sliceable record, or None.

    Every slice-shaped record is emitted at its END, carrying its own
    measured duration -- except spans, whose ``t0_mono_s`` start is
    exact on the stream's mono clock.
    """
    kind = rec.get("event")
    if kind == "span":
        dur = _num(rec.get("duration_s")) or 0.0
        t0_mono = _num(rec.get("t0_mono_s"))
        if t0_mono is not None and align["mode"] != "wall":
            return align["a"] * t0_mono + align["b"], dur
        end = _wall_of(rec, align)
        return (end - dur, dur) if end is not None else None
    if kind == "em_iter":
        dur = _num(rec.get("wall_s")) or 0.0
    elif kind == "chunk_flush":
        dur = ((_num(rec.get("prefetch_wait_s")) or 0.0)
               + (_num(rec.get("compute_s")) or 0.0))
    elif kind == "serve_batch":
        dur = (_num(rec.get("wall_ms")) or 0.0) / 1e3
    elif kind in ("serve_request", "http_request"):
        dur = (_num(rec.get("latency_ms")) or 0.0) / 1e3
    elif kind == "compile":
        dur = _num(rec.get("seconds")) or 0.0
    else:
        return None
    end = _wall_of(rec, align)
    return (end - dur, dur) if end is not None else None


def build_timeline(targets: List[str]) -> dict:
    """Merge the targets' streams into one Chrome trace-event document.

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms",
    "metadata": {...}}``. ``metadata.alignment`` is ``clock`` only when
    EVERY stream carried v2.3 anchors; any fallback stream demotes the
    whole export to ``estimated`` (the banner the CLI prints).
    """
    streams = load_streams(targets)

    # pids: stable rank-major order; collisions (a fit stream and a
    # serve stream both rank 0) get distinct pids by stream order.
    streams.sort(key=lambda s: (s.rank, s.label))
    for i, s in enumerate(streams):
        s.pid = i + 1

    # The export origin: the earliest aligned moment across all streams.
    # Slice STARTS can precede every emission time (the root fit span
    # opens before run_start is written), so the scan covers both.
    t0 = None
    for s in streams:
        for r in s.records:
            w = _wall_of(r, s.align)
            sliced = _slice_of(r, s.align)
            if sliced is not None:
                w = sliced[0] if w is None else min(w, sliced[0])
            if w is not None and (t0 is None or w < t0):
                t0 = w
    if t0 is None:
        raise ValueError("no timestamped records in any stream")

    events: List[dict] = []
    flows_s: List[dict] = []   # serve_request flow starts by trace_id
    span_index: Dict[str, List[dict]] = {}  # trace_id -> span events

    for s in streams:
        a = s.align
        rank_name = f"rank {s.rank}" if s.tag != "serve" else "serve"
        events.append({"ph": "M", "name": "process_name", "pid": s.pid,
                       "args": {"name": f"{rank_name} · {s.label} "
                                        f"[{s.tag}]"}})
        span_tids: Dict[Any, int] = {}
        used_tracks = set()
        prev_em: Optional[Tuple[float, float]] = None  # (wall, iter rate)

        def track(tid: int, name: str) -> int:
            if tid not in used_tracks:
                used_tracks.add(tid)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": s.pid, "tid": tid,
                               "args": {"name": name}})
            return tid

        for rec in s.records:
            kind = rec.get("event")
            if not isinstance(kind, str):
                continue
            wall = _wall_of(rec, a)
            if wall is None:
                continue

            if kind == "span":
                thread = rec.get("thread", 0)
                if thread not in span_tids:
                    span_tids[thread] = 1 + len(span_tids)
                tid = track(span_tids[thread],
                            "spans" if len(span_tids) == 1 and thread == 0
                            else f"spans (thread {thread})")
                start, dur = _slice_of(rec, a)
                ev = {"ph": "X", "name": str(rec.get("name", "span")),
                      "cat": "span", "pid": s.pid, "tid": tid,
                      "ts": _us(start, t0), "dur": round(dur * 1e6, 3),
                      "args": _args_for(rec, kind)}
                events.append(ev)
                tid_key = rec.get("trace_id")
                if isinstance(tid_key, str):
                    span_index.setdefault(tid_key, []).append(ev)
                continue

            sliced = _slice_of(rec, a)
            if sliced is not None:
                start, dur = sliced
                if kind in ("em_iter", "chunk_flush"):
                    tid = track(_TID_EM, "em")
                elif kind in ("serve_request", "serve_batch",
                              "http_request"):
                    tid = track(_TID_SERVE, "serve")
                else:
                    tid = track(_TID_COMPILE, "compile")
                name = kind
                if kind == "em_iter":
                    name = f"em_iter k={rec.get('k')}"
                elif kind == "compile":
                    name = f"compile:{rec.get('site') or rec.get('source')}"
                elif kind == "serve_request":
                    name = f"serve:{rec.get('op', 'request')}"
                elif kind == "http_request":
                    name = (f"http:{rec.get('op')}" if rec.get("op")
                            else f"http:{rec.get('path', 'request')}")
                ev = {"ph": "X", "name": name, "cat": kind, "pid": s.pid,
                      "tid": tid, "ts": _us(start, t0),
                      "dur": round(dur * 1e6, 3),
                      "args": _args_for(rec, kind)}
                events.append(ev)
                if kind in ("serve_request", "http_request") \
                        and isinstance(rec.get("trace_id"), str):
                    flows_s.append({"ph": "s", "cat": "serve",
                                    "name": "request",
                                    "id": rec["trace_id"], "pid": s.pid,
                                    "tid": tid, "ts": ev["ts"]})
                if kind == "em_iter":
                    # Stream-derived rate counter: iters/s from
                    # consecutive emission deltas (the registry's
                    # em_iters counter, differentiated).
                    if prev_em is not None and wall > prev_em[0]:
                        events.append({
                            "ph": "C", "name": "em iters/s",
                            "pid": s.pid, "ts": _us(wall, t0),
                            "args": {"iters_per_s": round(
                                1.0 / (wall - prev_em[0]), 3)}})
                    prev_em = (wall, dur)
                continue

            ts = _us(wall, t0)
            if kind == "heartbeat":
                rss = _num(rec.get("rss_bytes"))
                if rss is not None:
                    events.append({"ph": "C", "name": "host RSS bytes",
                                   "pid": s.pid, "ts": ts,
                                   "args": {"rss_bytes": rss}})
                mem = rec.get("memory_stats") or {}
                dev = _num(mem.get("bytes_in_use")) \
                    if isinstance(mem, dict) else None
                if dev is not None:
                    events.append({"ph": "C", "name": "device bytes",
                                   "pid": s.pid, "ts": ts,
                                   "args": {"bytes_in_use": dev}})
                continue
            if kind == "drift":
                # Drift windows (rev v2.4) -> per-model PSI/KS counter
                # tracks: distribution shift against time, next to the
                # serve slices that produced it.
                model = rec.get("model", "?")
                for field in ("psi", "ks"):
                    v = _num(rec.get(field))
                    if v is not None:
                        events.append({
                            "ph": "C", "name": f"drift {field} ({model})",
                            "pid": s.pid, "ts": ts, "args": {field: v}})
                continue
            if kind == "serve_shed":
                queued = _num(rec.get("queued_rows"))
                if queued is not None:
                    events.append({"ph": "C", "name": "queued rows",
                                   "pid": s.pid, "ts": ts,
                                   "args": {"queued_rows": queued}})
            if kind in _THREAD_INSTANTS or kind in _PROCESS_INSTANTS:
                scope = "p" if kind in _PROCESS_INSTANTS else "t"
                args = {k: v for k, v in rec.items()
                        if k not in ("event", "schema", "ts", "mono_s",
                                     "run_id", "process", "clock",
                                     "clock0")
                        and isinstance(v, (str, int, float, bool))}
                events.append({"ph": "i", "name": kind, "cat": kind,
                               "pid": s.pid,
                               "tid": track(_TID_EVENTS, "events"),
                               "ts": ts, "s": scope, "args": args})

    # Flow arrows: a client's serve_request slice -> the server-side
    # serve_route span tree that answered it (same trace_id, possibly a
    # different stream). Only emitted as a PAIR -- an unpaired flow
    # start is a validation error by design.
    n_flows = 0
    for flow in flows_s:
        spans = span_index.get(flow["id"])
        if not spans:
            continue
        root = min(spans, key=lambda e: e["ts"])
        events.append(flow)
        events.append({"ph": "f", "bp": "e", "cat": "serve",
                       "name": "request", "id": flow["id"],
                       "pid": root["pid"], "tid": root["tid"],
                       "ts": max(root["ts"], flow["ts"])})
        n_flows += 1

    # Per-track monotone order: metadata first, then time order with
    # enclosing slices before their children (longer dur wins ties).
    events.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                               e.get("ts", 0.0), -e.get("dur", 0.0)))

    modes = {s.align["mode"] for s in streams}
    alignment = "clock" if modes == {"clock"} else "estimated"
    meta = {
        "alignment": alignment,
        "origin_wall_s": round(t0, 6),
        "streams": [{
            "label": s.label, "pid": s.pid, "rank": s.rank,
            "path": s.tag, "records": len(s.records),
            "alignment": s.align["mode"],
            "anchors": s.align["anchors"],
            "skew": round(s.align["a"] - 1.0, 9),
            "residual_s": s.align["residual_s"],
        } for s in streams],
        "flow_count": n_flows,
    }
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def summarize_trace(doc: dict) -> dict:
    """Event/track/flow counts of one trace document (bench + CLI)."""
    evs = doc.get("traceEvents") or []
    tracks = {(e.get("pid"), e.get("tid")) for e in evs
              if e.get("ph") in ("X", "B", "E", "i")}
    return {
        "events": sum(1 for e in evs if e.get("ph") != "M"),
        "slices": sum(1 for e in evs if e.get("ph") == "X"),
        "instants": sum(1 for e in evs if e.get("ph") == "i"),
        "counters": sum(1 for e in evs if e.get("ph") == "C"),
        "flows": sum(1 for e in evs if e.get("ph") == "s"),
        "tracks": len(tracks),
        "pids": len({e.get("pid") for e in evs}),
        "alignment": (doc.get("metadata") or {}).get("alignment"),
    }


# -------------------------------------------------------------- validation


_KNOWN_PH = frozenset("MXBEiICsft")


def validate_trace(doc: Any) -> List[str]:
    """Structural errors of one trace-event document ([] = clean).

    The oracle ``--validate`` and the tests hold every export to:
    nonzero event count; known phase letters; ``X`` slices with
    nonnegative durations; matched ``B``/``E`` per track (this exporter
    is X-only, but hand-edited traces stay checkable); per-track
    non-decreasing timestamps in file order (Perfetto tolerates disorder,
    but an out-of-order export means broken alignment arithmetic); and
    every flow id carrying both its start and its finish, in order.
    """
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    real = [e for e in evs if isinstance(e, dict) and e.get("ph") != "M"]
    if not real:
        errors.append("no events (only metadata or empty)")
    last_ts: Dict[Tuple[Any, Any], float] = {}
    be_stack: Dict[Tuple[Any, Any], int] = {}
    flow_s: Dict[Any, float] = {}
    flow_f: Dict[Any, float] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        if "pid" not in e:
            errors.append(f"event {i}: missing pid")
        ts = _num(e.get("ts"))
        if ts is None or ts < 0:
            errors.append(f"event {i} ({ph}): bad ts {e.get('ts')!r}")
            continue
        key = (e.get("pid"), e.get("tid"))
        if ph in ("X", "B", "E", "i", "C"):
            if ts < last_ts.get(key, float("-inf")):
                errors.append(
                    f"event {i} ({ph} {e.get('name')!r}): ts {ts} goes "
                    f"backwards on track pid={key[0]} tid={key[1]}")
            last_ts[key] = ts
        if ph == "X":
            dur = _num(e.get("dur"))
            if dur is None or dur < 0:
                errors.append(f"event {i} (X {e.get('name')!r}): bad "
                              f"dur {e.get('dur')!r}")
        elif ph == "B":
            be_stack[key] = be_stack.get(key, 0) + 1
        elif ph == "E":
            depth = be_stack.get(key, 0)
            if depth <= 0:
                errors.append(f"event {i}: E without open B on track "
                              f"pid={key[0]} tid={key[1]}")
            else:
                be_stack[key] = depth - 1
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args or any(
                    _num(v) is None for v in args.values()):
                errors.append(f"event {i} (C {e.get('name')!r}): counter "
                              f"args must be numeric")
        elif ph == "s":
            fid = e.get("id")
            flow_s[fid] = min(ts, flow_s.get(fid, ts))
        elif ph in ("f", "t"):
            flow_f[e.get("id")] = ts
    for key, depth in be_stack.items():
        if depth:
            errors.append(f"{depth} unmatched B event(s) on track "
                          f"pid={key[0]} tid={key[1]}")
    for fid, ts in flow_s.items():
        if fid not in flow_f:
            errors.append(f"flow {fid!r}: start without finish")
        elif flow_f[fid] < ts:
            errors.append(f"flow {fid!r}: finish at {flow_f[fid]} "
                          f"precedes start at {ts}")
    for fid in flow_f:
        if fid not in flow_s:
            errors.append(f"flow {fid!r}: finish without start")
    return errors


# --------------------------------------------------------------------- CLI


def _default_out(target: str) -> str:
    base = os.path.normpath(target)
    if base.endswith(".jsonl"):
        base = base[:-len(".jsonl")]
    return base + ".trace.json"


def timeline_main(argv=None) -> int:
    """``gmm timeline RUN [RUN ...]``: export a Chrome/Perfetto trace.

    Exit 0 = exported (and validate-clean when ``--validate``),
    1 = ``--validate`` found structural errors in the emitted document,
    2 = usage error / unreadable or empty stream.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="gmm timeline",
        description="Convert recorded telemetry streams (a JSONL file, a "
        "per-rank stream directory, or several targets together -- e.g. "
        "a fit stream plus a serve stream) into ONE Chrome trace-event "
        "JSON file for Perfetto / chrome://tracing: nested span slices "
        "per rank, EM/serve/compile slices with args, resource counter "
        "tracks, instant events, and flow arrows joining serve requests "
        "to their server-side spans. Streams are merged onto one wall "
        "timebase via the v2.3 clock anchors (run head + heartbeats); "
        "pre-v2.3 streams align via a ts-based estimate and the export "
        "is marked 'alignment: estimated'.")
    parser.add_argument("targets", nargs="+", metavar="RUN",
                        help="stream file or per-rank stream directory "
                        "(repeat to merge runs, e.g. fit + serve)")
    parser.add_argument("-o", "--out", default=None, metavar="FILE",
                        help="output trace path (default: first target "
                        "with .trace.json suffix)")
    parser.add_argument("--validate", action="store_true",
                        help="re-load the emitted JSON and check the "
                        "trace-event structure (phase letters, X "
                        "durations, per-track timestamp order, flow "
                        "pairing, nonzero event count)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable summary on stdout "
                        "instead of the human one")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    try:
        doc = build_timeline(args.targets)
    except (OSError, ValueError) as e:
        print(f"gmm timeline: {e}", file=sys.stderr)
        return 2

    out_path = args.out or _default_out(args.targets[0])
    try:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.write("\n")
    except OSError as e:
        print(f"gmm timeline: cannot write {out_path!r}: {e}",
              file=sys.stderr)
        return 2

    meta = doc["metadata"]
    summary = summarize_trace(doc)
    validate_ok = None
    if args.validate:
        with open(out_path, "r", encoding="utf-8") as fh:
            reloaded = json.load(fh)
        verrors = validate_trace(reloaded)
        validate_ok = not verrors
        for err in verrors:
            print(f"gmm timeline: validate: {err}", file=sys.stderr)

    if meta["alignment"] == "estimated":
        print("gmm timeline: alignment: estimated -- at least one "
              "stream predates the v2.3 clock anchors; cross-stream "
              "offsets are inferred from per-record (ts, mono_s) pairs "
              "and may be off by wall-clock slew", file=sys.stderr)

    if args.json:
        record = dict(summary)
        record.update({"out": out_path,
                       "streams": len(meta["streams"])})
        if validate_ok is not None:
            record["validate_ok"] = validate_ok
        print(json.dumps(record, sort_keys=True))
    else:
        print(f"{out_path}: {summary['events']} events "
              f"({summary['slices']} slices, {summary['counters']} "
              f"counter samples, {summary['flows']} flow(s)) across "
              f"{summary['tracks']} track(s), {len(meta['streams'])} "
              f"stream(s); alignment: {meta['alignment']}"
              + ("" if validate_ok is None else
                 f"; validate: {'clean' if validate_ok else 'FAILED'}"))
        print(f"open in https://ui.perfetto.dev or chrome://tracing")
    return 0 if validate_ok in (None, True) else 1
