"""``gmm lifecycle``: the closed loop, offline.

Replays the ``drift_alarm`` events of a RECORDED serve stream into a
:class:`LifecycleController` over a registry: debounce, shadow
minibatch-EM retrain (from ``--data`` or the policy's configured
source), canary gates on the holdout slice, and -- when every gate
passes -- an atomic promotion the next serve run's hot-reload adopts.
The duplicate-dispatch shadow window and the post-promotion watch need
live traffic, so offline runs skip straight from a passed canary to
promote + cooldown; rejected candidates are quarantined exactly as in
serve mode. Lifecycle events are appended to ``--out`` (rev v2.6) for
``gmm report`` / ``gmm diff``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

from .controller import (LifecycleController, LifecycleError,
                         LifecyclePolicy)


def _stream_alarms(path: str) -> List[Tuple[str, int]]:
    """(model, version) per drift_alarm record of a serve stream."""
    alarms: List[Tuple[str, int]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue  # torn tail line: a live stream's last record
            if r.get("event") == "drift_alarm" and r.get("model"):
                alarms.append((str(r["model"]),
                               int(r.get("version") or 0)))
    return alarms


def lifecycle_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gmm lifecycle",
        description="Drive the drift->retrain->canary->promote loop "
        "offline from a recorded serve stream (docs/ROBUSTNESS.md "
        "'Model lifecycle').")
    p.add_argument("stream", help="recorded serve stream (*.jsonl) "
                   "whose drift_alarm events trigger the loop")
    p.add_argument("--registry", required=True, metavar="DIR",
                   help="model registry root (gmm export)")
    p.add_argument("--policy", required=True, metavar="POLICY.json",
                   help="lifecycle policy (see docs/API.md)")
    p.add_argument("--data", default=None, metavar="FILE.bin",
                   help="retrain data source (overrides the policy's "
                   "retrain.data)")
    p.add_argument("--out", default=None, metavar="FILE.jsonl",
                   help="write lifecycle telemetry events here")
    p.add_argument("--max-wall-s", type=float, default=300.0,
                   help="bound on the retry/backoff pump (default 300)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable verdict on stdout")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the refit and the canary scoring "
                   "(default cuda; without a GPU it exits 2 unless "
                   "--device cpu)")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    from .. import telemetry
    from ..serving.executor import device_or_raise
    from ..serving.registry import ModelRegistry
    from ..telemetry.recorder import RunRecorder

    try:
        device_or_raise(args.device)
    except RuntimeError as e:
        print(f"lifecycle: {e}", file=sys.stderr)
        return 2

    try:
        policy = LifecyclePolicy.from_file(args.policy)
    except LifecycleError as e:
        print(f"lifecycle: {e}", file=sys.stderr)
        return 2
    if args.data:
        policy.retrain["data"] = args.data
    try:
        alarms = _stream_alarms(args.stream)
    except OSError as e:
        print(f"lifecycle: cannot read stream: {e}", file=sys.stderr)
        return 2

    registry = ModelRegistry(args.registry)
    ctl = LifecycleController(registry, policy, device=args.device)
    rec = RunRecorder(path=args.out)
    with telemetry.use(rec), rec:
        for model, version in alarms:
            ctl.observe_alarm(model, version)
        # Pump the state machine until every route settles (retry
        # backoffs are real waits, bounded by --max-wall-s).
        deadline = time.monotonic() + max(1.0, float(args.max_wall_s))
        while time.monotonic() < deadline:
            ctl.on_tick()
            routes = ctl.stats()["routes"]
            if all(s in ("idle", "cooldown") for s in routes.values()):
                break
            time.sleep(0.02)
    verdict = {
        "alarms": len(alarms),
        "counts": ctl.counts,
        "routes": {name: {"state": state,
                          "live_versions": registry.versions(name)}
                   for name, state in ctl.stats()["routes"].items()},
    }
    if args.json:
        print(json.dumps(verdict, sort_keys=True))
    else:
        print(f"lifecycle: {len(alarms)} alarm(s) -> "
              f"{ctl.counts['retrains']} retrain(s), "
              f"{ctl.counts['promotes']} promotion(s), "
              f"{ctl.counts['quarantines']} quarantine(s)")
        for name, row in verdict["routes"].items():
            print(f"  {name}: live versions {row['live_versions']}")
    return 1 if ctl.counts["quarantines"] else 0
