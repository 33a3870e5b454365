"""Offline rendering of a telemetry stream: the ``gmm report`` backend.

Turns a ``--metrics-file`` JSONL stream back into the reference's
human-readable surfaces -- the 7-category phase-profile table
(``gaussian.cu:967``'s layout, shared with ``PhaseTimer.report`` so the
live ``--profile`` print and the offline report are byte-compatible), the
per-K selection sweep summary, and the per-iteration loglik trajectory --
from the stream alone: no pickle, no state files, no devices.

``gmm report --follow`` (alias ``gmm top``; rev v2.1) is the live
counterpart: an incremental tailer over the same stream -- a single
JSONL file, or a directory of per-rank ``*.jsonl`` streams -- that
re-renders a one-screen view as records arrive. It leans on the
recorder's line-buffered flush-per-record sink: a reader only ever sees
whole lines, so the tailer never has to re-parse a torn record. Where
``mono_s`` (rev v2.1 envelope) is present, rates and ages are computed
from monotonic deltas rather than wall-clock ``ts``.

The port's own copy of the JAX package's ``telemetry/report.py``: the
same stream renders to the same bytes under either package.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

from .schema import validate_stream


def render_phase_table(seconds: Dict[str, float],
                       counts: Optional[Dict[str, int]] = None) -> str:
    """Total + per-call average per category (gaussian.cu:967's layout).

    The single formatter behind both the live ``PhaseTimer.report`` and
    the offline ``gmm report`` phase table.
    """
    counts = counts or {}
    lines = ["Phase profile (seconds total / calls / avg):"]
    for name, total in seconds.items():
        n = max(counts.get(name, 0), 1)
        lines.append(f"  {name:<10s}\t{total:9.4f}\t{counts.get(name, 0):6d}"
                     f"\t{total / n:9.6f}")
    return "\n".join(lines)


def _fmt_run_start(rec: dict) -> str:
    bits = [f"run {rec.get('run_id', '?')}",
            f"platform={rec.get('platform', '?')}",
            f"N={rec.get('num_events', '?')}",
            f"D={rec.get('num_dimensions', '?')}",
            f"start_k={rec.get('start_k', '?')}"]
    if rec.get("target_k"):
        bits.append(f"target_k={rec['target_k']}")
    if rec.get("path"):
        bits.append(f"path={rec['path']}")
    if rec.get("em_backend"):
        # rev v1.5: which E-step backend actually ran; a fallback away
        # from a requested kernel carries its reason.
        b = f"backend={rec['em_backend']}"
        if rec.get("em_backend") == "jnp" and rec.get("em_backend_reason"):
            b += f" ({rec['em_backend_reason']})"
        bits.append(b)
    if rec.get("mesh"):
        bits.append(f"mesh={rec['mesh']}")
    if rec.get("process_count", 1) and rec.get("process_count", 1) > 1:
        bits.append(f"processes={rec['process_count']}")
    return "  ".join(str(b) for b in bits)


def _count_spans(node: dict) -> int:
    """Descendant count of one span-tree node (elision bookkeeping)."""
    return sum(1 + _count_spans(c) for c in node["children"])


def _render_span_profile(span_recs: List[dict], top_n: int = 10) -> List[str]:
    """"Span profile" section (rev v2.2): the top-N slowest spans by
    SELF time (total minus direct children), aggregated by span name --
    where the wall actually went, not just where the tree is deepest."""
    from .spans import build_span_tree

    agg: Dict[str, List[float]] = {}  # name -> [self_s, total_s, count]
    stack = list(build_span_tree(span_recs))
    while stack:
        node = stack.pop()
        s = node["span"]
        total = float(s.get("duration_s", 0) or 0)
        child_s = sum(float(c["span"].get("duration_s", 0) or 0)
                      for c in node["children"])
        slot = agg.setdefault(str(s.get("name", "?")), [0.0, 0.0, 0])
        slot[0] += max(total - child_s, 0.0)
        slot[1] += total
        slot[2] += 1
        stack.extend(node["children"])
    if not agg:
        return []
    rows = sorted(agg.items(), key=lambda kv: kv[1][0], reverse=True)
    out = [f"Span profile (top {min(top_n, len(rows))} by self time):",
           f"  {'span':<18s} {'self_s':>9s} {'total_s':>9s} {'count':>6s}"]
    for name, (self_s, total_s, count) in rows[:top_n]:
        out.append(f"  {name:<18s} {self_s:>9.3f} {total_s:>9.3f} "
                   f"{count:>6d}")
    if len(rows) > top_n:
        out.append(f"  ... {len(rows) - top_n} more span name(s)")
    out.append("")
    return out


def render_report(records: List[dict], max_trajectory_rows: int = 400) -> str:
    """The full ``gmm report`` text for one decoded stream."""
    out: List[str] = []
    starts = [r for r in records if r.get("event") == "run_start"]
    iters = [r for r in records if r.get("event") == "em_iter"]
    dones = [r for r in records if r.get("event") == "em_done"]
    merges = [r for r in records if r.get("event") == "merge"]
    chunks = [r for r in records if r.get("event") == "chunk_flush"]
    summaries = [r for r in records if r.get("event") == "run_summary"]

    serve_reqs = [r for r in records if r.get("event") == "serve_request"]
    serve_batches = [r for r in records
                     if r.get("event") == "serve_batch"]
    serve_summaries = [r for r in records
                       if r.get("event") == "serve_summary"]
    serve_sheds = [r for r in records if r.get("event") == "serve_shed"]
    serve_deadlines = [r for r in records
                       if r.get("event") == "serve_deadline"]
    serve_reloads = [r for r in records
                     if r.get("event") == "serve_reload"]
    serve_windows = [r for r in records
                     if r.get("event") == "serve_window"]
    circuits = [r for r in records if r.get("event") == "circuit"]
    http_reqs = [r for r in records if r.get("event") == "http_request"]
    worker_spawns = [r for r in records
                     if r.get("event") == "worker_spawn"]
    worker_exits = [r for r in records if r.get("event") == "worker_exit"]
    drift_windows = [r for r in records if r.get("event") == "drift"]
    drift_alarms = [r for r in records
                    if r.get("event") == "drift_alarm"]
    lifecycles = [r for r in records if r.get("event") == "lifecycle"]
    registry_torns = [r for r in records
                      if r.get("event") == "registry_torn"]

    fleet_starts = [r for r in records if r.get("event") == "fleet_start"]
    tenant_dones = [r for r in records if r.get("event") == "tenant_done"]
    fleet_summaries = [r for r in records
                       if r.get("event") == "fleet_summary"]

    rebuckets = [r for r in records if r.get("event") == "rebucket"]
    heartbeats = [r for r in records if r.get("event") == "heartbeat"]
    span_recs = [r for r in records if r.get("event") == "span"]
    compile_recs = [r for r in records if r.get("event") == "compile"]
    tune_recs = [r for r in records if r.get("event") == "tune"]

    selects = [r for r in records if r.get("event") == "restart_select"]
    healths = [r for r in records if r.get("event") == "health"]
    recoveries = [r for r in records if r.get("event") == "recovery"]
    io_retries = [r for r in records if r.get("event") == "io_retry"]
    preempts = [r for r in records if r.get("event") == "preempt"]
    shutdowns = [r for r in records if r.get("event") == "shutdown"]
    peer_losts = [r for r in records if r.get("event") == "peer_lost"]
    shrinks = [r for r in records if r.get("event") == "elastic_shrink"]
    resumes = [r for r in records if r.get("event") == "elastic_resume"]

    for s in starts:
        out.append(_fmt_run_start(s))
    if starts:
        out.append("")

    if tune_recs:
        # Autotune decisions (rev v2.5): what the profile-guided
        # resolver picked, from which fallback-ladder rung, against
        # which recorded/modelled wall.
        out.append(f"Autotune ({len(tune_recs)} decision(s)):")
        for r in tune_recs:
            line = (f"  {r.get('knob')}: {r.get('chosen')} "
                    f"[{r.get('source')}]")
            if r.get("default") not in (None, r.get("chosen")):
                line += f" (default {r.get('default')})"
            pred = r.get("predicted_s")
            if isinstance(pred, (int, float)):
                line += f", predicted {float(pred):.4f}s/iter"
            if r.get("surface") not in (None, "fit"):
                line += f" ({r.get('surface')})"
            out.append(line)
        out.append("")

    if dones:
        out.append("Model-order sweep (em_done):")
        out.append(f"  {'K':>5s}  {'loglik':>15s}  {'score':>15s}"
                   f"  {'iters':>6s}  {'seconds':>9s}")
        for r in dones:
            out.append(f"  {r['k']:>5d}  {r['loglik']:>15.6e}"
                       f"  {r['score']:>15.6e}  {r['iters']:>6d}"
                       f"  {r['seconds']:>9.3f}")
        if merges:
            out.append(f"  ({len(merges)} closest-pair merges)")
        if rebuckets:
            widths = ", ".join(
                f"{r.get('from_width')}->{r.get('to_width')}"
                for r in rebuckets[:8])
            if len(rebuckets) > 8:
                widths += ", ..."
            out.append(f"  ({len(rebuckets)} bucket recompactions: "
                       f"{widths})")
        out.append("")
    elif rebuckets:
        out.append(f"{len(rebuckets)} bucket recompactions "
                   "(rebucket; sweep_k_buckets)")
        out.append("")

    if iters:
        out.append("Loglik trajectory (em_iter):")
        out.append(f"  {'K':>5s} {'iter':>5s}  {'loglik':>15s}"
                   f"  {'delta':>12s}  {'wall_s':>9s}")
        shown = iters[:max_trajectory_rows]
        for r in shown:
            delta = r.get("delta")
            dstr = f"{delta:>12.4e}" if delta is not None else f"{'-':>12s}"
            out.append(f"  {r['k']:>5d} {r['iter']:>5d}"
                       f"  {r['loglik']:>15.6e}  {dstr}"
                       f"  {r['wall_s']:>9.4f}")
        if len(iters) > len(shown):
            out.append(f"  ... {len(iters) - len(shown)} more rows elided")
        out.append("")

    ingest_starts = [r for r in records if r.get("event") == "ingest_start"]
    ingest_summaries = [r for r in records
                        if r.get("event") == "ingest_summary"]
    if chunks or ingest_starts or ingest_summaries:
        if chunks:
            total_bytes = sum(int(r.get("bytes", 0)) for r in chunks)
            line = (f"Streaming: {len(chunks)} block flushes, "
                    f"{total_bytes / 1e6:.1f} MB host->device")
            waits = [float(r["prefetch_wait_s"]) for r in chunks
                     if r.get("prefetch_wait_s") is not None]
            computes = [float(r["compute_s"]) for r in chunks
                        if r.get("compute_s") is not None]
            if waits or computes:
                # rev v1.9 split: total host wall blocked on ingestion vs.
                # in the statistics dispatch, across all blocks.
                line += (f"; prefetch wait {sum(waits):.3f}s / "
                         f"compute {sum(computes):.3f}s")
            out.append(line)
        for r in ingest_starts:
            out.append(
                f"  ingest: {r.get('source', '?')} rows "
                f"[{r.get('row_start', '?')}, {r.get('row_stop', '?')}) "
                f"in {r.get('blocks', '?')} blocks, "
                f"queue depth {r.get('queue_depth', '?')}"
                + (f", mode={r['mode']}" if r.get("mode") else ""))
        for r in ingest_summaries:
            out.append(
                f"  ingest summary: {r.get('blocks_read', 0)} blocks "
                f"served, peak {r.get('peak_resident_blocks', 0)} resident "
                f"(queue depth {r.get('queue_depth', '?')}), "
                f"{float(r.get('bytes', 0)) / 1e6:.1f} MB read, "
                f"prefetch wait {float(r.get('prefetch_wait_s', 0)):.3f}s")
        out.append("")

    if (serve_reqs or serve_batches or serve_summaries or serve_sheds
            or serve_deadlines or serve_reloads or serve_windows
            or circuits or drift_windows or http_reqs or worker_spawns
            or worker_exits):
        out.append("Serving (rev v1.6; docs/SERVING.md):")
        if serve_reqs:
            by_model: Dict[str, List[dict]] = {}
            for r in serve_reqs:
                by_model.setdefault(str(r.get("model")), []).append(r)
            for model, rs in sorted(by_model.items()):
                ok = sum(1 for r in rs if r.get("ok"))
                rows = sum(int(r.get("n", 0)) for r in rs)
                lat = sorted(float(r.get("latency_ms", 0.0)) for r in rs)
                p50 = lat[len(lat) // 2] if lat else 0.0
                out.append(
                    f"  {model:<20s} {len(rs):6d} requests "
                    f"({len(rs) - ok} failed)  {rows:8d} rows  "
                    f"p50 {p50:.3f} ms")
        if serve_batches:
            reqs = sum(int(r.get("requests", 0)) for r in serve_batches)
            rows = sum(int(r.get("rows", 0)) for r in serve_batches)
            padded = sum(int(r.get("padded_rows", 0))
                         for r in serve_batches)
            compiled = sum(int(r.get("compiled", 0))
                           for r in serve_batches)
            out.append(
                f"  {len(serve_batches)} micro-batches: "
                f"{reqs / max(len(serve_batches), 1):.2f} requests/batch, "
                f"{rows} rows ({padded} dispatched after bucketing), "
                f"{compiled} AOT compiles")
        # Resilience (rev v1.7; docs/ROBUSTNESS.md "Serving").
        if serve_sheds:
            by_reason: Dict[str, int] = {}
            for r in serve_sheds:
                by_reason[str(r.get("reason"))] = \
                    by_reason.get(str(r.get("reason")), 0) + 1
            out.append("  shed: " + ", ".join(
                f"{n} {reason}" for reason, n in sorted(by_reason.items())))
        if serve_deadlines:
            waits = [float(r.get("waited_ms", 0.0))
                     for r in serve_deadlines]
            out.append(
                f"  {len(serve_deadlines)} requests expired past their "
                f"deadline (max waited {max(waits):.1f} ms)")
        for r in serve_reloads:
            out.append(
                f"  hot-reload {r.get('model')}: "
                f"v{r.get('from_version')} -> v{r.get('to_version')}")
        if serve_windows:
            # Adaptive micro-batching (rev v2.8): adaptation mix plus
            # where the gather window ended up.
            by_reason: Dict[str, int] = {}
            for r in serve_windows:
                reason = str(r.get("reason"))
                by_reason[reason] = by_reason.get(reason, 0) + 1
            last = serve_windows[-1]
            out.append(
                f"  adaptive window: {len(serve_windows)} adaptation(s) ("
                + ", ".join(f"{n} {reason}"
                            for reason, n in sorted(by_reason.items()))
                + f"), now {float(last.get('window_ms', 0)):.3f} ms")
        for r in circuits:
            ver = (f"@{r['version']}" if r.get("version") is not None
                   else "")
            tail = ""
            if r.get("state") == "open":
                tail = (f" (failures={r.get('failures')}, "
                        f"reason={r.get('reason')}, "
                        f"backoff {r.get('backoff_s')}s)")
            out.append(f"  circuit {r.get('model')}{ver}: "
                       f"{r.get('state')}{tail}")
        # Network front end (rev v2.7; docs/SERVING.md "HTTP front end").
        if http_reqs:
            by_status: Dict[str, int] = {}
            for r in http_reqs:
                key = f"{int(r.get('status', 0)) // 100}xx"
                by_status[key] = by_status.get(key, 0) + 1
            lat = sorted(float(r.get("latency_ms", 0.0))
                         for r in http_reqs)
            retried = sum(1 for r in http_reqs if r.get("retried"))
            line = (f"  http: {len(http_reqs)} requests ("
                    + ", ".join(f"{n} {k}"
                                for k, n in sorted(by_status.items()))
                    + f"), p50 {lat[len(lat) // 2]:.3f} ms")
            if retried:
                line += f", {retried} answered via sibling retry"
            out.append(line)
        if worker_spawns or worker_exits:
            crashes = [r for r in worker_exits if r.get("crash")]
            quarantined = [r for r in worker_exits
                           if r.get("quarantined")]
            respawns = sum(1 for r in worker_spawns if r.get("respawn"))
            line = (f"  workers: {len(worker_spawns)} spawn(s) "
                    f"({respawns} respawns), {len(crashes)} crash(es)")
            if quarantined:
                line += f", {len(quarantined)} quarantined"
            out.append(line)
            for r in crashes:
                out.append(
                    f"    worker {r.get('worker')} pid {r.get('pid')} "
                    f"exited {r.get('exitcode')}"
                    + (" -> QUARANTINED" if r.get("quarantined")
                       else ""))
        if drift_windows:
            # Drift plane (rev v2.4): latest window per (model, version);
            # alarm count from the dedicated drift_alarm records so a
            # superseded window's alarm still shows.
            latest_w: Dict[str, dict] = {}
            for r in drift_windows:
                ver = r.get("version")
                key = (f"{r.get('model')}@{ver}" if ver is not None
                       else str(r.get("model")))
                latest_w[key] = r
            for key, r in sorted(latest_w.items()):
                flag = " ALARM" if r.get("alarm") else ""
                out.append(
                    f"  drift {key}: psi {float(r.get('psi', 0)):.4f} "
                    f"ks {float(r.get('ks', 0)):.4f} "
                    f"occ_l1 {float(r.get('occupancy_l1', 0)):.4f} "
                    f"over {int(r.get('window_rows', 0))} rows "
                    f"({len(drift_windows)} window(s)){flag}")
            if drift_alarms:
                out.append(
                    f"  {len(drift_alarms)} drift alarm(s) "
                    f"(psi threshold "
                    f"{drift_alarms[-1].get('threshold')})")
        for s in serve_summaries:
            lat = s.get("latency_ms") or {}
            out.append(
                f"  summary: {s.get('requests')} requests in "
                f"{s.get('wall_s', 0):.2f}s = {s.get('qps')} QPS; "
                f"latency p50 {lat.get('p50')} ms, p99 {lat.get('p99')} "
                f"ms, max {lat.get('max')} ms")
            ex = s.get("executor") or {}
            if ex:
                out.append(
                    f"  executor: {ex.get('live_executables', 0)} live "
                    f"executables, {ex.get('compiles', 0)} compiles, "
                    f"{ex.get('hits', 0)} hits / "
                    f"{ex.get('misses', 0)} misses, "
                    f"{ex.get('evictions', 0)} evictions, "
                    f"{ex.get('pinned_states', 0)} pinned state(s), "
                    f"{ex.get('host_stagings', 0)} host staging(s)")
            win = s.get("window") or {}
            if win:
                out.append(
                    f"  window: {win.get('adaptations', 0)} "
                    f"adaptation(s), {win.get('window_ms', 0)} ms in "
                    f"[{win.get('min_ms', 0)}, {win.get('max_ms', 0)}]"
                    + (", auto-stack on" if win.get("auto_stack")
                       else ""))
            br = s.get("breaker") or {}
            if any(s.get(k) for k in ("shed", "deadline_expired",
                                      "reloads")) or any(br.values()):
                out.append(
                    f"  resilience: {s.get('shed', 0)} shed, "
                    f"{s.get('deadline_expired', 0)} past deadline, "
                    f"{br.get('trips', 0)} breaker trips "
                    f"({br.get('fastfails', 0)} fast-fails, "
                    f"{br.get('open_routes', 0)} open), "
                    f"{s.get('reloads', 0)} hot-reloads")
            http = s.get("http") or {}
            if http:
                out.append(
                    f"  http: {http.get('requests', 0)} requests "
                    f"({http.get('errors_4xx', 0)} 4xx, "
                    f"{http.get('errors_5xx', 0)} 5xx, "
                    f"{http.get('shed_connections', 0)} shed); "
                    f"workers {http.get('workers', 0)}: "
                    f"{http.get('worker_crashes', 0)} crash(es), "
                    f"{http.get('worker_respawns', 0)} respawn(s), "
                    f"{http.get('worker_quarantines', 0)} quarantined; "
                    f"{http.get('retries', 0)} sibling retries "
                    f"({http.get('retries_exhausted', 0)} exhausted)")
        out.append("")

    if lifecycles or registry_torns:
        out.append("Lifecycle (rev v2.6; docs/ROBUSTNESS.md "
                   "\"Model lifecycle\"):")
        for r in lifecycles:
            phase = str(r.get("phase"))
            model = str(r.get("model"))
            outc = r.get("outcome")
            bits = [f"  {phase} {model}"]
            if outc:
                bits.append(f"{outc}")
            if phase == "retrain" and r.get("candidate_version") is not None:
                bits.append(f"candidate v{r['candidate_version']}")
            if phase == "canary" and r.get("psi") is not None:
                bits.append(
                    f"psi {float(r['psi']):.4f} "
                    f"ks {float(r.get('ks', 0)):.4f} "
                    f"regression {float(r.get('regression', 0)):.4f} "
                    f"(tol {float(r.get('tolerance', 0)):.4f})")
            if phase in ("promote", "rollback") \
                    and r.get("to_version") is not None:
                bits.append(f"v{r.get('from_version')} -> "
                            f"v{r.get('to_version')}")
            if r.get("reason"):
                bits.append(f"reason={r['reason']}")
            if r.get("attempt") is not None:
                bits.append(f"attempt {r['attempt']}")
            out.append(": ".join([bits[0], " ".join(bits[1:])])
                       if len(bits) > 1 else bits[0])
        for r in registry_torns:
            out.append(
                f"  registry torn: {r.get('model')} v{r.get('version')} "
                f"unreadable, walked back ({r.get('error')})")
        out.append("")

    if fleet_starts or tenant_dones or fleet_summaries:
        out.append("Fleet (rev v1.8; docs/TENANCY.md):")
        for r in fleet_starts:
            out.append(
                f"  {r.get('tenants')} tenants in {r.get('groups')} "
                f"packed group(s), mode={r.get('mode')} "
                f"D={r.get('num_dimensions', '?')} "
                f"{r.get('covariance_type', '')}")
        for r in tenant_dones:
            if r.get("dropped"):
                out.append(f"  {str(r.get('tenant')):<20s} DROPPED "
                           f"({r.get('error', '?')})")
            else:
                score = r.get("score")
                sval = (f"{score:.6e}" if isinstance(score, (int, float))
                        else "-")
                out.append(
                    f"  {str(r.get('tenant')):<20s} K={r.get('k'):>3} "
                    f"{r.get('criterion', 'score')}={sval}  "
                    f"{r.get('iters', 0):>5} EM iters")
        for r in fleet_summaries:
            out.append(
                f"  summary: {r.get('tenants')} tenants "
                f"({r.get('dropped')} dropped) in {r.get('groups')} "
                f"group(s), {r.get('wall_s', 0):.2f}s")
        out.append("")

    for r in selects:
        scores = r.get("scores") or []
        out.append(f"Restart selection ({r.get('mode', '?')}, "
                   f"batch_size={r.get('batch_size', '?')}): "
                   f"winner init {r.get('winner')} of {len(scores)}")
        for i, s in enumerate(scores):
            marks = []
            if i == r.get("winner"):
                marks.append("winner")
            if i in (r.get("dropped") or []):
                marks.append("DROPPED")
            tail = f"  ({', '.join(marks)})" if marks else ""
            sval = f"{s:.6e}" if isinstance(s, (int, float)) else "-"
            out.append(f"  init {i:>3d}  "
                       f"{r.get('criterion', 'score')}={sval}{tail}")
    if selects:
        out.append("")

    if healths or recoveries or io_retries:
        out.append("Health / recovery (docs/ROBUSTNESS.md):")
        for r in healths:
            k = r.get("k")
            names = ",".join(r.get("flag_names") or []) or "?"
            where = r.get("where", "em")
            out.append(f"  health   K={k if k is not None else '-':>4} "
                       f"[{where}] flags=0x{int(r.get('flags', 0)):x} "
                       f"({names})")
        for r in recoveries:
            out.append(f"  recovery K={r.get('k', '-'):>4} "
                       f"attempt={r.get('attempt')} "
                       f"action={r.get('action')} -> {r.get('outcome')}")
        for r in io_retries:
            tail = " GAVE UP" if r.get("gave_up") else ""
            out.append(f"  io_retry {r.get('op')} "
                       f"step={r.get('step', '-')} "
                       f"attempt={r.get('attempt')}: "
                       f"{r.get('error')}{tail}")
        out.append("")

    if preempts or shutdowns or peer_losts or shrinks or resumes:
        out.append("Run lifecycle (preemption; docs/ROBUSTNESS.md):")
        for r in peer_losts:
            out.append(f"  peer_lost rank={r.get('rank')} heartbeat "
                       f"stale {r.get('age_s', '?')}s > timeout "
                       f"{r.get('timeout_s', '?')}s")
        for r in shrinks:
            survivors = r.get("survivors") or []
            lost = ",".join(str(x) for x in (r.get("lost_ranks") or []))
            out.append(f"  elastic_shrink gen={r.get('generation')} -> "
                       f"{r.get('world_size')} host(s) {survivors}"
                       + (f" (lost rank {lost})" if lost else "")
                       + (f" attempt={r['attempt']}"
                          if r.get("attempt") is not None else ""))
        for r in resumes:
            pos = ""
            if r.get("step") is not None:
                pos = f" from step {r['step']}"
                if r.get("k") is not None:
                    pos += f" (K={r['k']})"
            out.append(f"  elastic_resume gen={r.get('generation')} "
                       f"continued the sweep{pos}")
        for r in preempts:
            pos = ""
            if r.get("k") is not None:
                pos = f" at K={r['k']}"
                if r.get("em_iter") is not None:
                    pos += f" iter={r['em_iter']}"
            out.append(f"  preempt  reason={r.get('reason')} "
                       f"[{r.get('where', '?')}]{pos}")
        for r in shutdowns:
            if r.get("checkpointed"):
                pos = ""
                if r.get("step") is not None:
                    pos = f" (step {r['step']}"
                    pos += (f" iter {r['em_iter']})"
                            if r.get("em_iter") is not None else ")")
                ck = "checkpoint durable" + pos
            else:
                ck = "NO checkpoint (not resumable)"
            out.append(f"  shutdown reason={r.get('reason')} -> exit 75, "
                       f"{ck}")
        out.append("")

    if heartbeats:
        last = heartbeats[-1]
        out.append(
            f"Liveness: {len(heartbeats)} heartbeat(s), last "
            f"phase={last.get('phase', '?')} at "
            f"elapsed={float(last.get('elapsed_s', 0)):.0f}s")
        samples = [r for r in heartbeats if r.get("sampler")]
        rss = [int(r["rss_bytes"]) for r in samples
               if r.get("rss_bytes") is not None]
        if rss:
            line = (f"  resources ({len(samples)} samples): host RSS "
                    f"peak {max(rss) / 1e6:.1f} MB")
            hbm = [int((r.get("memory_stats") or {}).get(
                       "peak_bytes_in_use",
                       (r.get("memory_stats") or {}).get(
                           "bytes_in_use", 0)))
                   for r in samples if r.get("memory_stats")]
            if any(hbm):
                line += f", device peak {max(hbm) / 1e6:.1f} MB"
            out.append(line)
        out.append("")

    if span_recs:
        from .spans import build_span_tree

        traces = {str(r.get("trace_id")) for r in span_recs}
        out.append(f"Trace spans (rev v2.1): {len(span_recs)} span(s) "
                   f"in {len(traces)} trace(s)")
        max_span_rows = 120
        shown = 0
        elided = 0
        # Depth-first with an explicit stack; children are pre-sorted by
        # start time in build_span_tree.
        stack = [(root, 0) for root in reversed(build_span_tree(span_recs))]
        while stack:
            node, depth = stack.pop()
            s = node["span"]
            if shown >= max_span_rows:
                elided += 1 + _count_spans(node)
                continue
            shown += 1
            label = str(s.get("name", "?"))
            for key in ("k", "group", "model", "step"):
                if s.get(key) is not None:
                    label += f" {key}={s[key]}"
            status = ("" if s.get("status", "ok") == "ok"
                      else f"  [{s.get('status')}]")
            out.append(f"  {'  ' * depth}{label:<{max(30 - 2 * depth, 8)}s}"
                       f" {float(s.get('duration_s', 0)):>9.3f}s{status}")
            for child in reversed(node["children"]):
                stack.append((child, depth + 1))
        if elided:
            out.append(f"  ... {elided} more span(s) elided")
        out.append("")

    if span_recs:
        out.extend(_render_span_profile(span_recs))

    if compile_recs:
        # rev v2.2 (telemetry/profiling.py): per-compile observations --
        # instrumented cache builds ("aot", with cost/memory analyses)
        # vs. bare XLA backend compiles outside any site ("xla").
        aot = [r for r in compile_recs if r.get("source") == "aot"]
        xla = [r for r in compile_recs if r.get("source") != "aot"]
        out.append(
            f"Compile activity (rev v2.2): {len(aot)} instrumented "
            f"cache build(s) ({sum(float(r.get('seconds', 0)) for r in aot):.3f}s), "
            f"{len(xla)} other XLA compile(s) "
            f"({sum(float(r.get('seconds', 0)) for r in xla):.3f}s)")
        by_site: Dict[str, List[dict]] = {}
        for r in aot:
            by_site.setdefault(str(r.get("site", "?")), []).append(r)
        for site, rs in sorted(by_site.items()):
            line = (f"  {site}: {len(rs)} compile(s), "
                    f"{sum(float(r.get('seconds', 0)) for r in rs):.3f}s")
            flops = [float(r["flops"]) for r in rs
                     if r.get("flops") is not None]
            ba = [float(r["bytes_accessed"]) for r in rs
                  if r.get("bytes_accessed") is not None]
            if flops:
                line += f"; max {max(flops):.3g} flops"
            if ba:
                line += f" / {max(ba) / 1e6:.1f} MB accessed"
            temp = [int(r["temp_bytes"]) for r in rs
                    if r.get("temp_bytes") is not None]
            if temp:
                line += f"; temp {max(temp) / 1e6:.1f} MB"
            out.append(line)
        out.append("")

    for s in summaries:
        prof = s.get("phase_profile") or {}
        if prof.get("seconds"):
            out.append(render_phase_table(prof["seconds"],
                                          prof.get("counts")))
        comp = s.get("compile") or {}
        watch_prof = s.get("profile") or {}
        if comp or watch_prof:
            first = comp.get("first_call_s")
            warm = comp.get("warm_call_s")
            # rev v2.2: prefer MEASURED compile seconds (CompileWatch)
            # over the first-minus-warm heuristic; pre-v2.2 streams
            # carry only est_compile_s and keep rendering through it.
            measured = watch_prof.get("compile_seconds")
            est = comp.get("est_compile_s")
            out.append(
                "Compile/execute split: first call "
                + (f"{first:.3f}s" if first is not None else "-")
                + ", warm call "
                + (f"{warm:.3f}s" if warm is not None else "-")
                + ", compile "
                + (f"{measured:.3f}s (measured)" if measured is not None
                   else (f"{est:.3f}s (est.)" if est is not None else "-")))
        if watch_prof:
            line = (f"Profile (rev v2.2): {watch_prof.get('compiles', 0)} "
                    f"site compile(s), "
                    f"{watch_prof.get('xla_compiles', 0)} XLA compile(s) "
                    f"({float(watch_prof.get('xla_compile_seconds', 0)):.3f}s"
                    " total)")
            cost = watch_prof.get("cost") or {}
            if cost.get("flops") is not None:
                line += (f"; peak program {float(cost['flops']):.3g} flops"
                         f" / {float(cost.get('bytes_accessed', 0)) / 1e6:.1f}"
                         " MB accessed")
            if watch_prof.get("hbm_peak_bytes"):
                line += (f"; HBM peak "
                         f"{int(watch_prof['hbm_peak_bytes']) / 1e6:.1f} MB")
            out.append(line)
        hs = s.get("health")
        if hs is not None:
            if hs.get("flags"):
                out.append(
                    "Health: flags=0x%x (%s)%s  recoveries=%d io_retries=%d"
                    % (int(hs["flags"]),
                       ",".join(hs.get("flag_names") or []),
                       " FATAL" if hs.get("fatal") else "",
                       int(hs.get("recoveries", 0)),
                       int(hs.get("io_retries", 0))))
            else:
                out.append("Health: clean (all flags zero)")
        el = s.get("elastic")
        if el:
            out.append(
                f"Elastic: generation {el.get('generation')} "
                f"({el.get('world_size')} host(s) at finish, "
                f"{el.get('shrinks', 0)} shrink(s), "
                f"{el.get('resumes', 0)} resume(s))")
        backend = (f"  [backend={s['em_backend']}]"
                   if s.get("em_backend") else "")
        out.append(
            f"Best model: K={s.get('ideal_k')} "
            f"{s.get('criterion', 'score')}={s.get('score'):.6e} "
            f"loglik={s.get('final_loglik'):.6e} "
            f"({s.get('total_iters')} EM iterations, "
            f"{s.get('wall_s'):.2f}s){backend}")
        metrics = s.get("metrics") or {}
        counters = metrics.get("counters")
        if counters:
            out.append("Counters: " + "  ".join(
                f"{k}={v:g}" for k, v in sorted(counters.items())))
        out.append("")

    if not out:
        return "(no telemetry records)"
    return "\n".join(out).rstrip() + "\n"


# -- gmm report --follow / gmm top (rev v2.1) ---------------------------

# Records that end a stream: once one arrives, the tailer renders a last
# screen and exits instead of polling a finished run forever.
_TERMINAL_EVENTS = frozenset(
    ("run_summary", "serve_summary", "fleet_summary", "shutdown"))


def _discover_streams(path: str) -> List[str]:
    """The stream files behind one ``gmm top`` target: the file itself,
    or every ``*.jsonl`` in a directory of per-rank streams."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".jsonl"))
    return [path]


class StreamTailer:
    """Incremental reader of one JSONL stream file.

    Keeps a byte offset; each :meth:`poll` returns the records completed
    since the last one. Only whole lines are consumed -- a torn final
    line (caught mid-write) stays unread until its newline lands, which
    the recorder's flush-per-record sink guarantees eventually happens.
    A file that SHRANK (a new run truncating the same path) restarts the
    offset from zero.
    """

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []  # not created yet (or vanished): keep waiting
        if size < self._offset:
            self._offset = 0
        if size == self._offset:
            return []
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self._offset)
                chunk = fh.read()
        except OSError:
            # The path races with the run: it can vanish between getsize
            # and open, or turn out to be a directory (a `gmm top` target
            # that did not exist at startup and was later created as a
            # per-rank stream dir -- follow_stream's per-poll rescan then
            # tails the member files; this placeholder just stays quiet).
            return []
        nl = chunk.rfind(b"\n")
        if nl < 0:
            return []
        consumed = chunk[:nl + 1]
        self._offset += len(consumed)
        records: List[dict] = []
        for raw in consumed.splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                records.append(json.loads(raw.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue  # live view: skip a bad line, don't die
        return records


def _iter_rate(iters: List[dict], window: int = 50) -> Optional[float]:
    """EM iterations/s over the trailing window -- from ``mono_s``
    deltas when every record carries one (rev v2.1), immune to
    wall-clock slew; ``ts`` fallback for older streams."""
    if len(iters) < 2:
        return None
    tail = iters[-window:]
    key = "mono_s" if all("mono_s" in r for r in tail) else "ts"
    dt = float(tail[-1][key]) - float(tail[0][key])
    if dt <= 0:
        return None
    return (len(tail) - 1) / dt


def render_follow(records: List[dict]) -> str:
    """The ``gmm top`` screen: a one-screen live view of the stream."""
    if not records:
        return "(gmm top: waiting for telemetry records...)\n"
    by: Dict[str, List[dict]] = {}
    for r in records:
        by.setdefault(str(r.get("event")), []).append(r)
    out: List[str] = []

    starts = by.get("run_start", [])
    fleet_starts = by.get("fleet_start", [])
    head = ["gmm top"]
    if starts:
        s = starts[-1]
        head.append(f"run {s.get('run_id', '?')}")
        head.append(f"platform={s.get('platform', '?')}")
        head.append(f"N={s.get('num_events', '?')} "
                    f"D={s.get('num_dimensions', '?')}")
        if s.get("path"):
            head.append(f"path={s['path']}")
    elif fleet_starts:
        s = fleet_starts[-1]
        head.append(f"fleet run {s.get('run_id', '?')}")
        head.append(f"platform={s.get('platform', '?')}")
    elif by.get("serve_request") or by.get("serve_batch"):
        head.append(f"serve run {records[-1].get('run_id', '?')}")
    out.append("  ".join(head))
    out.append("")

    iters = by.get("em_iter", [])
    dones = by.get("em_done", [])
    if iters:
        cur = iters[-1]
        rate = _iter_rate(iters)
        line = (f"EM: K={cur.get('k')} iter={cur.get('iter')} "
                f"loglik={float(cur.get('loglik', 0)):.6e}")
        if cur.get("delta") is not None:
            line += f" delta={float(cur['delta']):.3e}"
        if rate is not None:
            line += f"  ({rate:.1f} iters/s)"
        out.append(line)
    if dones:
        import math

        best = min(
            (r for r in dones
             if isinstance(r.get("score"), (int, float))
             and not math.isnan(float(r["score"]))),
            key=lambda r: float(r["score"]), default=None)
        line = f"Sweep: {len(dones)} model order(s) done"
        if best is not None:
            line += (f"; best K={best.get('k')} "
                     f"score={float(best['score']):.6e}")
        out.append(line)

    tenant_dones = by.get("tenant_done", [])
    if fleet_starts or tenant_dones:
        total = (fleet_starts[-1].get("tenants", "?")
                 if fleet_starts else "?")
        dropped = sum(1 for r in tenant_dones if r.get("dropped"))
        out.append(f"Fleet: {len(tenant_dones)}/{total} tenant(s) done"
                   + (f" ({dropped} dropped)" if dropped else ""))

    serve_reqs = by.get("serve_request", [])
    if serve_reqs:
        failed = sum(1 for r in serve_reqs if not r.get("ok"))
        rows = sum(int(r.get("n", 0)) for r in serve_reqs)
        lat = sorted(float(r.get("latency_ms", 0.0))
                     for r in serve_reqs[-200:])
        p50 = lat[len(lat) // 2] if lat else 0.0
        line = (f"Serve: {len(serve_reqs)} requests ({failed} failed), "
                f"{rows} rows, p50 {p50:.2f} ms")
        extras = []
        for kind, tag in (("serve_shed", "shed"),
                          ("serve_deadline", "deadline"),
                          ("serve_reload", "reload")):
            n = len(by.get(kind, []))
            if n:
                extras.append(f"{n} {tag}")
        opens = sum(1 for r in by.get("circuit", [])
                    if r.get("state") == "open")
        if opens:
            extras.append(f"{opens} breaker trip(s)")
        windows = by.get("serve_window", [])
        if windows:
            extras.append(
                f"{len(windows)} window adaptation(s) -> "
                f"{float(windows[-1].get('window_ms', 0)):.2f} ms")
        if extras:
            line += "  [" + ", ".join(extras) + "]"
        out.append(line)

    http_reqs = by.get("http_request", [])
    if http_reqs:
        # HTTP front-end rollup (rev v2.7): status classes + tail p50.
        err5 = sum(1 for r in http_reqs
                   if int(r.get("status", 0)) >= 500)
        retried = sum(1 for r in http_reqs if r.get("retried"))
        lat = sorted(float(r.get("latency_ms", 0.0))
                     for r in http_reqs[-200:])
        p50 = lat[len(lat) // 2] if lat else 0.0
        line = (f"http: {len(http_reqs)} requests ({err5} 5xx), "
                f"p50 {p50:.2f} ms")
        if retried:
            line += f"  [{retried} sibling retr{'y' if retried == 1 else 'ies'}]"
        out.append(line)
    worker_exits = by.get("worker_exit", [])
    worker_spawns = by.get("worker_spawn", [])
    if worker_spawns or worker_exits:
        crashes = sum(1 for r in worker_exits if r.get("crash"))
        quarantined = sum(1 for r in worker_exits
                          if r.get("quarantined"))
        line = (f"workers: {len(worker_spawns)} spawn(s), "
                f"{crashes} crash(es)")
        if quarantined:
            line += f"  [{quarantined} QUARANTINED]"
        out.append(line)

    drifts = by.get("drift", [])
    if drifts:
        # Drift rollup (rev v2.4): latest window per model; alarms from
        # the dedicated drift_alarm records so a scrolled-off window
        # still counts.
        latest: Dict[str, dict] = {}
        for r in drifts:
            latest[str(r.get("model"))] = r
        worst = max(latest.values(),
                    key=lambda r: float(r.get("psi", 0.0)))
        alarms = len(by.get("drift_alarm", []))
        line = (f"drift: {len(drifts)} window(s), "
                f"worst psi {float(worst.get('psi', 0.0)):.4f} "
                f"ks {float(worst.get('ks', 0.0)):.4f} "
                f"({worst.get('model')})")
        if alarms:
            line += f"  [{alarms} ALARM(s)]"
        out.append(line)

    lifecycles = by.get("lifecycle", [])
    if lifecycles:
        # Lifecycle rollup (rev v2.6): phase counts + the newest edge.
        phases: Dict[str, int] = {}
        for r in lifecycles:
            phases[str(r.get("phase"))] = \
                phases.get(str(r.get("phase")), 0) + 1
        last = lifecycles[-1]
        line = "lifecycle: " + ", ".join(
            f"{n} {phase}" for phase, n in sorted(phases.items()))
        line += (f"  [last: {last.get('phase')} {last.get('model')}"
                 + (f" {last.get('outcome')}" if last.get("outcome")
                    else "") + "]")
        out.append(line)
    torns = by.get("registry_torn", [])
    if torns:
        out.append(f"registry: {len(torns)} torn version walk-back(s)")

    healths = by.get("health", [])
    recoveries = by.get("recovery", [])
    if healths or recoveries:
        out.append(f"Health: {len(healths)} nonzero flag word(s), "
                   f"{len(recoveries)} recovery action(s)")
    shrinks = by.get("elastic_shrink", [])
    if shrinks:
        last = shrinks[-1]
        out.append(f"Elastic: generation {last.get('generation')} "
                   f"({last.get('world_size')} host(s))")

    samples = [r for r in by.get("heartbeat", []) if r.get("sampler")]
    if samples:
        last = samples[-1]
        line = "Resources:"
        if last.get("rss_bytes") is not None:
            line += f" host RSS {int(last['rss_bytes']) / 1e6:.1f} MB"
        mem = last.get("memory_stats") or {}
        if mem.get("bytes_in_use") is not None:
            line += f", device {int(mem['bytes_in_use']) / 1e6:.1f} MB"
            if mem.get("peak_bytes_in_use") is not None:
                line += (" (peak "
                         f"{int(mem['peak_bytes_in_use']) / 1e6:.1f} MB)")
        out.append(line)

    spans = by.get("span", [])
    if spans:
        last = spans[-1]
        out.append(f"Spans: {len(spans)} closed, last "
                   f"{last.get('name', '?')} "
                   f"({float(last.get('duration_s', 0)):.3f}s)")

    last = records[-1]
    tail = f"last event: {last.get('event')}"
    if last.get("ts") is not None:
        age = max(0.0, time.time() - float(last["ts"]))
        tail += f" ({age:.1f}s ago)"
    if any(k in _TERMINAL_EVENTS for k in by):
        # Anywhere, not just last: with the live plane on, the closing
        # fit/fleet span records land AFTER run_summary (they close when
        # the plane's ExitStack unwinds around the emitting code).
        tail += "  -- stream ended"
    out.append("")
    out.append(tail)
    return "\n".join(out) + "\n"


def follow_stream(path: str, interval_s: float = 1.0,
                  max_renders: Optional[int] = None, out=None) -> int:
    """The ``--follow`` loop: poll, merge, re-render until the stream
    ends (a terminal record) or ``max_renders`` screens were drawn."""
    out = out if out is not None else sys.stdout
    clear = bool(getattr(out, "isatty", lambda: False)())
    tailers: Dict[str, StreamTailer] = {}
    records: List[dict] = []
    renders = 0
    ended = False

    def _poll_all() -> List[dict]:
        # Re-discover EVERY poll, not just at startup: rank files that
        # join late (elastic regrowth, slow NFS create, a serve stream
        # landing beside a fit stream) get a tailer mid-follow and their
        # records appear on the next screen.
        for stream_path in _discover_streams(path):
            if stream_path not in tailers:
                tailers[stream_path] = StreamTailer(stream_path)
        new: List[dict] = []
        for t in tailers.values():
            new.extend(t.poll())
        return new

    def _render() -> None:
        nonlocal renders
        if clear:
            out.write("\x1b[2J\x1b[H")  # clear + home, like top(1)
        elif renders:
            out.write("\n--- refresh ---\n")
        out.write(render_follow(records))
        out.flush()
        renders += 1

    while True:
        new = _poll_all()
        if new or renders == 0:
            records.extend(new)
            _render()
        ended = ended or any(
            r.get("event") in _TERMINAL_EVENTS for r in new)
        if ended:
            # The run is over, but teardown records can TRAIL the
            # terminal one (with the live plane on, the closing
            # fit/fleet spans emit after run_summary, when the plane's
            # ExitStack unwinds). One short drain catches them, then a
            # final screen.
            time.sleep(min(interval_s, 0.2))
            tail_records = _poll_all()
            if tail_records:
                records.extend(tail_records)
                _render()
            return 0
        if max_renders is not None and renders >= max_renders:
            return 0
        time.sleep(interval_s)


def report_main(argv=None) -> int:
    """``gmm report <metrics.jsonl>``: render a stream on stdout."""
    import argparse

    from .recorder import read_stream

    p = argparse.ArgumentParser(
        prog="gmm report",
        description="Render a --metrics-file JSONL telemetry stream: phase "
        "profile, loglik trajectory, and model-order sweep summary. "
        "--follow (alias: `gmm top`) tails a LIVE stream -- a file or a "
        "directory of per-rank *.jsonl streams -- re-rendering a "
        "one-screen view as records arrive.")
    p.add_argument("metrics_file", help="JSONL stream from --metrics-file "
                   "(with --follow: a file or a stream directory)")
    p.add_argument("--validate", action="store_true",
                   help="exit nonzero if any record fails schema validation")
    p.add_argument("--json", action="store_true",
                   help="machine-readable rollup on stdout (the same "
                   "flat-metric shape `gmm diff` compares) instead of "
                   "the rendered report")
    p.add_argument("--follow", "-f", action="store_true",
                   help="live view: poll the stream and re-render one "
                   "screen as it grows; exits when the run's terminal "
                   "record (run_summary / serve_summary / fleet_summary "
                   "/ shutdown) arrives")
    p.add_argument("--interval", type=float, default=1.0, metavar="S",
                   help="--follow poll cadence in seconds (default 1)")
    p.add_argument("--max-renders", type=int, default=None, metavar="N",
                   help="--follow: stop after N screens (automation and "
                   "tests; default: until the stream ends)")
    args = p.parse_args(argv)
    if args.follow:
        return follow_stream(args.metrics_file,
                             interval_s=args.interval,
                             max_renders=args.max_renders)
    try:
        records = read_stream(args.metrics_file)
    except OSError as e:
        print(f"Cannot read {args.metrics_file!r}: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not records:
        print(f"{args.metrics_file}: empty stream", file=sys.stderr)
        return 1
    errors = validate_stream(records)
    for e in errors:
        print(f"schema: {e}", file=sys.stderr)
    if args.json:
        from .diff import summarize_run

        print(json.dumps(summarize_run(records), sort_keys=True))
    else:
        print(render_report(records), end="")
    return 1 if (errors and args.validate) else 0
