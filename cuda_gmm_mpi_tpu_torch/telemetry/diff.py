"""Cross-run regression analytics: ``gmm diff`` and ``gmm runs``.

Stream rev v2.2. BENCH_r01..r05 regressions were caught by a human
reading JSON files side by side; this module makes the comparison a CI
primitive instead. :func:`summarize_run` flattens one run -- a JSONL
stream, a directory of per-rank streams, or a ``bench.py`` JSON record
-- into a flat metric dict (per-phase walls from the span tree, iters/s,
compile count/seconds from the CompileWatch profile, health counters,
ingest prefetch waits, serve latency percentiles); :func:`diff_runs`
compares two of them under ``--fail-on 'metric>threshold%'`` specs.

Exit-code contract (CI-friendly, documented in docs/API.md):

* ``gmm diff``: 0 = clean (no spec tripped), 1 = at least one named
  regression, 2 = usage error / unreadable target.
* ``gmm runs``: 0 = listed (even when empty), 2 = unreadable directory.

The default specs are count-shaped ("must not increase at all"):
compile counts, health counters, serve errors/sheds. Wall-clock metrics
are never failed on by default -- two byte-identical runs still jitter
in wall time, and a flaky gate is worse than none -- so time-shaped
thresholds are opt-in via ``--fail-on``.

``gmm report --json`` emits the same rollup, so scripts consume one
shape everywhere.

The port's own copy of the JAX package's ``telemetry/diff.py``: the same
rollup, table and exit codes on the same streams.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .recorder import read_stream
from .spans import build_span_tree

# Run-identity fields folded into the config fingerprint: same
# fingerprint = comparable runs (a diff across fingerprints still
# renders, with a loud note).
_FINGERPRINT_FIELDS = (
    "platform", "num_events", "num_dimensions", "start_k", "target_k",
    "epsilon", "dtype", "criterion", "covariance_type", "chunk_size",
    "fused_sweep", "n_init", "em_backend",
)

# Count-shaped metrics that must not increase between comparable runs.
# ``tune.regressions`` counts autotune decisions whose measured wall/iter
# came in >20% over the recorded profile that chose them (stale tuning-DB
# rows page instead of silently pessimizing; docs/PERF.md "Autotuning").
DEFAULT_FAIL_ON = (
    "compiles>0",
    "xla_compiles>0",
    "health_fatal>0",
    "health_recoveries>0",
    "health_io_retries>0",
    "serve.errors>0",
    "serve.shed>0",
    "serve.deadline_expired>0",
    "tune.regressions>0",
    # Closed-loop lifecycle (rev v2.6): a promotion that had to be
    # rolled back, or a candidate/attempt that had to be quarantined,
    # is a regression even though serving survived it by design.
    "lifecycle.rollbacks>0",
    "lifecycle.quarantines>0",
    # Network front end (rev v2.7): a 5xx answered to a client, a worker
    # process crash, or a request that exhausted the pool's sibling
    # retry is a regression even when the tier absorbed it.
    "http.errors_5xx>0",
    "http.worker_crashes>0",
    "http.retries_exhausted>0",
    # Device-resident routes (rev v2.8): warm serve traffic must score
    # against pinned device state -- any request that had to stage its
    # model host-side fell off the resident fast path (a reload released
    # the pin, or an unpinned version was addressed explicitly).
    "serve.host_staging>0",
)

#: a tuned run this much slower than its own recorded profile regresses.
TUNE_REGRESSION_TOLERANCE = 1.20


def _num(value) -> Optional[float]:
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        f = float(value)
        return f if f == f else None  # NaN drops out
    return None


def _flatten(obj, prefix: str, out: Dict[str, float]) -> None:
    """Dotted-path flatten of one JSON object's numeric leaves."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
        return
    v = _num(obj)
    if v is not None and prefix:
        out[prefix] = v


def _fingerprint(run_start: dict) -> str:
    ident = {k: run_start.get(k) for k in _FINGERPRINT_FIELDS
             if run_start.get(k) is not None}
    blob = json.dumps(ident, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:10]


def summarize_run(records: List[dict]) -> dict:
    """One decoded stream -> the flat cross-run rollup.

    ``{"kind": "stream", "run_id", "fingerprint", "backend", "platform",
    "metrics": {name: float}}`` -- the shape both ``gmm diff`` and
    ``gmm report --json`` emit.
    """
    metrics: Dict[str, float] = {}
    info: Dict[str, Any] = {"kind": "stream", "run_id": None,
                            "fingerprint": None, "backend": None,
                            "platform": None}

    starts = [r for r in records if r.get("event") == "run_start"]
    if starts:
        s = starts[0]
        info["run_id"] = s.get("run_id")
        info["platform"] = s.get("platform")
        info["backend"] = s.get("em_backend") or s.get("platform")
        info["fingerprint"] = _fingerprint(s)

    # Per-phase walls from the span tree (total time per span name; a
    # bucketed sweep sums its em_k spans).
    for root in build_span_tree(records):
        stack = [root]
        while stack:
            node = stack.pop()
            sp = node["span"]
            name = str(sp.get("name"))
            dur = _num(sp.get("duration_s"))
            if dur is not None:
                key = f"span.{name}_s"
                metrics[key] = round(metrics.get(key, 0.0) + dur, 6)
            stack.extend(node["children"])

    n_compile_events = 0
    tune_events: List[dict] = []
    lifecycle_seen = False
    serve_seen = False
    for r in records:
        ev = r.get("event")
        if ev == "compile":
            n_compile_events += 1
        elif ev == "lifecycle":
            # One count per state-machine phase (rev v2.6). ``retrain``
            # counts PUBLISHED candidates only -- scheduled/retry edges
            # are progress, not outcomes.
            lifecycle_seen = True
            phase = str(r.get("phase"))
            dst = {"retrain": "lifecycle.retrains",
                   "canary": "lifecycle.canaries",
                   "promote": "lifecycle.promotes",
                   "watch": "lifecycle.watches",
                   "rollback": "lifecycle.rollbacks",
                   "quarantine": "lifecycle.quarantines"}.get(phase)
            if dst is None:
                continue
            outcome = r.get("outcome")
            if phase == "retrain" and outcome != "published":
                continue
            if phase == "promote" and outcome != "promoted":
                continue
            metrics[dst] = metrics.get(dst, 0.0) + 1
        elif ev == "registry_torn":
            metrics["registry.torn"] = (
                metrics.get("registry.torn", 0.0) + 1)
        elif ev == "tune":
            tune_events.append(r)
        elif ev == "ingest_summary":
            for src, dst in (("prefetch_wait_s", "ingest.prefetch_wait_s"),
                             ("blocks_read", "ingest.blocks_read"),
                             ("bytes", "ingest.bytes")):
                v = _num(r.get(src))
                if v is not None:
                    metrics[dst] = round(metrics.get(dst, 0.0) + v, 6)
        elif ev == "serve_summary":
            serve_seen = True
            for src, dst in (("requests", "serve.requests"),
                             ("batches", "serve.batches"),
                             ("rows", "serve.rows"),
                             ("errors", "serve.errors"),
                             ("qps", "serve.qps"),
                             ("wall_s", "serve.wall_s"),
                             ("shed", "serve.shed"),
                             ("deadline_expired", "serve.deadline_expired"),
                             ("reloads", "serve.reloads"),
                             ("stacked_batches", "serve.stacked_batches")):
                v = _num(r.get(src))
                if v is not None:
                    metrics[dst] = v
            lat = r.get("latency_ms") or {}
            for q in ("p50", "p99", "mean", "max"):
                v = _num(lat.get(q))
                if v is not None:
                    metrics[f"serve.{q}_ms"] = v
            ex = r.get("executor") or {}
            v = _num(ex.get("compiles"))
            if v is not None:
                metrics["serve.compiles"] = v
            v = _num(ex.get("host_stagings"))
            if v is not None:
                metrics["serve.host_staging"] = v
            if info["run_id"] is None:
                info["run_id"] = r.get("run_id")
            self_prof = r.get("profile")
            if isinstance(self_prof, dict):
                _fold_profile(self_prof, metrics)
            # HTTP front-end rollup (rev v2.7): flatten the ``http``
            # dict so its counters gate like any other serve metric.
            http = r.get("http")
            if isinstance(http, dict):
                for k, raw in http.items():
                    v = _num(raw)
                    if v is not None:
                        metrics[f"http.{k}"] = v
        elif ev == "fleet_summary":
            for src in ("tenants", "dropped", "groups", "wall_s"):
                v = _num(r.get(src))
                if v is not None:
                    metrics[f"fleet.{src}"] = v
    if n_compile_events:
        metrics["compile_events"] = float(n_compile_events)
    if lifecycle_seen or serve_seen:
        # Explicit zeros so the count gates (lifecycle.rollbacks>0,
        # lifecycle.quarantines>0) compare against a baseline serve run
        # that simply had no lifecycle trouble, instead of evaporating
        # when one side lacks the metric.
        for key in ("lifecycle.rollbacks", "lifecycle.quarantines"):
            metrics.setdefault(key, 0.0)
    if serve_seen:
        # Same explicit-zero contract for the HTTP gates: a serve run
        # with the front end off (or one that simply saw no trouble)
        # reads 0, so baselines stay comparable across http on/off.
        for key in ("http.errors_5xx", "http.worker_crashes",
                    "http.retries_exhausted", "serve.host_staging"):
            metrics.setdefault(key, 0.0)

    summaries = [r for r in records if r.get("event") == "run_summary"]
    if summaries:
        s = summaries[-1]
        for src in ("wall_s", "total_iters", "score", "ideal_k"):
            v = _num(s.get(src))
            if v is not None:
                metrics[src] = v
        wall = _num(s.get("wall_s"))
        iters = _num(s.get("total_iters"))
        if wall and iters is not None and wall > 0:
            metrics["iters_per_s"] = round(iters / wall, 3)
        comp = s.get("compile") or {}
        # Pre-v2.5 streams only: the derived first-vs-warm estimate was
        # deleted once CompileWatch's measured compile_seconds (folded
        # from ``profile`` below) covered every run.
        v = _num(comp.get("est_compile_s"))
        if v is not None:
            metrics["est_compile_s"] = v
        prof = s.get("profile")
        if isinstance(prof, dict):
            _fold_profile(prof, metrics)
        phases = (s.get("phase_profile") or {}).get("seconds") or {}
        for name, sec in phases.items():
            v = _num(sec)
            if v is not None:
                metrics[f"phase.{name}_s"] = v
        health = s.get("health") or {}
        metrics["health_fatal"] = float(bool(health.get("fatal")))
        for src, dst in (("recoveries", "health_recoveries"),
                         ("io_retries", "health_io_retries")):
            v = _num(health.get(src))
            if v is not None:
                metrics[dst] = v
        counters = health.get("counters") or {}
        flagged = sum(v for v in counters.values()
                      if isinstance(v, (int, float)))
        metrics["health_flagged"] = float(flagged)
        if info["run_id"] is None:
            info["run_id"] = s.get("run_id")

    if tune_events:
        # Autotune audit (rev v2.5): how many knobs the resolver touched,
        # and how many of its MEASURED predictions (db/probe rows carry a
        # wall/iter; static predictions are too coarse to gate on) the
        # run's actual wall/iter blew through by >20%.
        metrics["tune.decisions"] = float(len(tune_events))
        wall = metrics.get("wall_s")
        iters = metrics.get("total_iters")
        measured = (wall / iters if wall and iters else None)
        regressions = 0
        for t in tune_events:
            pred = _num(t.get("predicted_s"))
            if pred is None or pred <= 0 \
                    or t.get("source") not in ("db", "probe"):
                continue
            if measured is not None \
                    and measured > TUNE_REGRESSION_TOLERANCE * pred:
                regressions += 1
        metrics["tune.regressions"] = float(regressions)

    info["metrics"] = metrics
    return info


def _fold_profile(prof: dict, metrics: Dict[str, float]) -> None:
    """run_summary/serve_summary ``profile`` -> flat compile metrics."""
    for src in ("compiles", "compile_seconds", "xla_compiles",
                "xla_compile_seconds", "hbm_peak_bytes"):
        v = _num(prof.get(src))
        if v is not None:
            metrics[src] = v
    for name, slot in (prof.get("sites") or {}).items():
        for field in ("compiles", "seconds"):
            v = _num((slot or {}).get(field))
            if v is not None:
                metrics[f"compile.{name}.{field}"] = v
    cost = prof.get("cost") or {}
    for field in ("flops", "bytes_accessed"):
        v = _num(cost.get(field))
        if v is not None:
            metrics[f"cost.{field}"] = v


def summarize_bench(record: dict) -> dict:
    """One ``bench.py`` JSON record -> the same rollup shape."""
    metrics: Dict[str, float] = {}
    _flatten(record, "", metrics)
    return {"kind": "bench",
            "run_id": record.get("run_id"),
            "fingerprint": None,
            "backend": record.get("backend") or record.get("platform"),
            "platform": record.get("platform"),
            "metrics": metrics}


def stream_files(path: str) -> List[str]:
    """The stream files behind one run target: the file itself, or every
    ``*.jsonl`` in a directory of per-rank streams. Shared by ``gmm
    diff``, ``gmm runs``, and ``gmm timeline`` (telemetry/timeline.py),
    which all accept the same target grammar."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if f.endswith(".jsonl"))
    return [path]


_stream_files = stream_files  # historical private name (pre-v2.3 callers)


def load_target(path: str) -> dict:
    """One diff target -> rollup. A directory merges its per-rank
    ``*.jsonl`` streams; a file is a JSONL stream when its records carry
    ``event``, otherwise the last JSON object wins (a captured bench
    line). Raises OSError/ValueError on unreadable input."""
    files = _stream_files(path)
    if not files:
        raise ValueError(f"{path}: no *.jsonl streams in directory")
    records: List[dict] = []
    for f in files:
        records.extend(r for r in read_stream(f) if isinstance(r, dict))
    if not records:
        raise ValueError(f"{path}: no records")
    if any("event" in r for r in records):
        return summarize_run(records)
    return summarize_bench(records[-1])


# -- fail-on specs -------------------------------------------------------

class FailSpec:
    """One ``metric>threshold[%]`` (or ``metric<...``: lower-is-worse,
    e.g. throughput) regression gate."""

    def __init__(self, raw: str):
        self.raw = raw.strip()
        op_idx = max(self.raw.find(">"), self.raw.find("<"))
        if op_idx <= 0 or op_idx == len(self.raw) - 1:
            raise ValueError(
                f"bad --fail-on spec {raw!r} (want 'metric>threshold' "
                f"or 'metric>threshold%')")
        self.metric = self.raw[:op_idx].strip()
        self.op = self.raw[op_idx]
        thr = self.raw[op_idx + 1:].strip()
        self.relative = thr.endswith("%")
        try:
            self.threshold = float(thr[:-1] if self.relative else thr)
        except ValueError:
            raise ValueError(f"bad --fail-on threshold in {raw!r}")

    def check(self, a: Optional[float],
              b: Optional[float]) -> Optional[str]:
        """A regression message, or None (clean / not comparable)."""
        if a is None or b is None:
            return None
        delta = (b - a) if self.op == ">" else (a - b)
        if self.relative:
            if a == 0:
                exceeded = delta > 0 and self.threshold >= 0
                pct = None
            else:
                pct = delta / abs(a) * 100.0
                exceeded = pct > self.threshold
            if not exceeded:
                return None
            how = (f"{pct:+.1f}%" if pct is not None
                   else "from zero")
            return (f"{self.metric}: {a:g} -> {b:g} ({how}, limit "
                    f"{self.op}{self.threshold:g}%)")
        if delta <= self.threshold:
            return None
        return (f"{self.metric}: {a:g} -> {b:g} ({delta:+g}, limit "
                f"{self.op}{self.threshold:g})")


def diff_runs(a: dict, b: dict,
              specs: List[FailSpec]) -> Tuple[List[str], List[str]]:
    """(regressions, notes) of rollup ``b`` against baseline ``a``."""
    regressions: List[str] = []
    notes: List[str] = []
    am, bm = a.get("metrics") or {}, b.get("metrics") or {}
    if (a.get("fingerprint") and b.get("fingerprint")
            and a["fingerprint"] != b["fingerprint"]):
        notes.append(
            f"config fingerprints differ ({a['fingerprint']} vs "
            f"{b['fingerprint']}): comparing anyway")
    for spec in specs:
        msg = spec.check(am.get(spec.metric), bm.get(spec.metric))
        if msg is not None:
            regressions.append(msg)
    return regressions, notes


def _render_table(a: dict, b: dict, show_all: bool) -> List[str]:
    am, bm = a.get("metrics") or {}, b.get("metrics") or {}
    shared = sorted(set(am) & set(bm))
    lines = [f"  {'metric':<28} {'A':>14} {'B':>14} {'delta':>12}"]
    for name in shared:
        va, vb = am[name], bm[name]
        if not show_all and va == vb == 0:
            continue
        delta = vb - va
        pct = f" ({delta / abs(va) * 100.0:+.1f}%)" if va else ""
        lines.append(f"  {name:<28} {va:>14g} {vb:>14g} "
                     f"{delta:>+12g}{pct}")
    only_a = sorted(set(am) - set(bm))
    only_b = sorted(set(bm) - set(am))
    if only_a:
        lines.append(f"  (only in A: {', '.join(only_a[:8])}"
                     f"{' ...' if len(only_a) > 8 else ''})")
    if only_b:
        lines.append(f"  (only in B: {', '.join(only_b[:8])}"
                     f"{' ...' if len(only_b) > 8 else ''})")
    return lines


def diff_main(argv=None) -> int:
    """``gmm diff A B``: exit 0 clean / 1 named regressions / 2 usage."""
    parser = argparse.ArgumentParser(
        prog="gmm diff",
        description="Compare two runs (JSONL streams, per-rank stream "
                    "directories, or bench JSON records) and gate on "
                    "regressions.")
    parser.add_argument("a", help="baseline run (stream/dir/bench JSON)")
    parser.add_argument("b", help="candidate run to judge against A")
    parser.add_argument("--fail-on", action="append", default=[],
                        metavar="SPEC",
                        help="regression gate, e.g. 'wall_s>10%%' "
                             "(relative) or 'serve.p99_ms>5' (absolute); "
                             "'<' flips direction for lower-is-worse "
                             "metrics like iters_per_s. Repeatable; adds "
                             "to the default count gates.")
    parser.add_argument("--no-default-gates", action="store_true",
                        help="drop the built-in compile/health/serve "
                             "count gates; only --fail-on specs apply")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable result on stdout")
    parser.add_argument("--all", action="store_true",
                        help="show all shared metrics, including 0 -> 0")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    try:
        specs = [] if args.no_default_gates else \
            [FailSpec(s) for s in DEFAULT_FAIL_ON]
        specs.extend(FailSpec(s) for s in args.fail_on)
    except ValueError as e:
        print(f"gmm diff: {e}")
        return 2
    try:
        a = load_target(args.a)
        b = load_target(args.b)
    except (OSError, ValueError) as e:
        print(f"gmm diff: {e}")
        return 2
    regressions, notes = diff_runs(a, b, specs)
    if args.json:
        print(json.dumps({
            "a": a, "b": b,
            "fail_on": [s.raw for s in specs],
            "regressions": regressions, "notes": notes,
            "clean": not regressions,
        }, sort_keys=True))
        return 1 if regressions else 0
    print(f"gmm diff: A={args.a} (run {a.get('run_id') or '?'})  "
          f"B={args.b} (run {b.get('run_id') or '?'})")
    for note in notes:
        print(f"note: {note}")
    for line in _render_table(a, b, args.all):
        print(line)
    if regressions:
        for msg in regressions:
            print(f"REGRESSION {msg}")
        print(f"{len(regressions)} regression(s)")
        return 1
    shared = len(set(a.get("metrics") or {}) & set(b.get("metrics") or {}))
    print(f"clean: no regressions ({shared} shared metrics, "
          f"{len(specs)} gates)")
    return 0


# -- gmm runs ------------------------------------------------------------

def _health_word(metrics: Dict[str, float]) -> str:
    if metrics.get("health_fatal"):
        return "FATAL"
    flagged = metrics.get("health_flagged") or 0
    recov = metrics.get("health_recoveries") or 0
    if flagged or recov:
        return f"{int(flagged)} flagged/{int(recov)} recovered"
    return "ok"


def runs_main(argv=None) -> int:
    """``gmm runs DIR``: index historical runs so diff targets are
    discoverable. Exit 0 (even when empty) / 2 unreadable directory."""
    parser = argparse.ArgumentParser(
        prog="gmm runs",
        description="List historical runs (one row per *.jsonl stream "
                    "in DIR): run id, config fingerprint, backend, "
                    "wall, iters/s, health.")
    parser.add_argument("dir", help="directory of *.jsonl run streams")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable rows on stdout")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0
    if not os.path.isdir(args.dir):
        print(f"gmm runs: {args.dir}: not a directory")
        return 2
    rows = []
    for f in _stream_files(args.dir):
        try:
            rollup = summarize_run(
                [r for r in read_stream(f) if isinstance(r, dict)])
        except (OSError, ValueError):
            continue  # non-stream jsonl in the same directory
        m = rollup.get("metrics") or {}
        rows.append({
            "file": os.path.basename(f),
            "run_id": rollup.get("run_id"),
            "fingerprint": rollup.get("fingerprint"),
            "backend": rollup.get("backend"),
            "wall_s": m.get("wall_s"),
            "iters_per_s": m.get("iters_per_s"),
            "health": _health_word(m),
        })
    if args.json:
        print(json.dumps({"dir": args.dir, "runs": rows},
                         sort_keys=True))
        return 0
    if not rows:
        print(f"gmm runs: no run streams in {args.dir}")
        return 0
    print(f"  {'run_id':<14} {'config':<12} {'backend':<10} "
          f"{'wall_s':>10} {'iters/s':>10}  {'health':<24} file")
    for r in rows:
        wall = f"{r['wall_s']:.3f}" if r["wall_s"] is not None else "-"
        ips = (f"{r['iters_per_s']:.1f}"
               if r["iters_per_s"] is not None else "-")
        print(f"  {str(r['run_id'] or '?'):<14} "
              f"{str(r['fingerprint'] or '?'):<12} "
              f"{str(r['backend'] or '?'):<10} {wall:>10} {ips:>10}  "
              f"{r['health']:<24} {r['file']}")
    return 0
