"""``gmm drift``: offline drift analytics against a training envelope.

Stream rev v2.4. The serve-time drift plane (serving/server.py) emits
windowed ``drift`` events while traffic flows; this module is the
offline half of the loop (docs/OBSERVABILITY.md "Drift detection"):
compare a recorded serve stream OR a raw dataset file against the
training envelope a registry version carries, and gate the result for
CI with ``gmm diff``-style ``--fail-on`` specs.

Target grammar (mirrors ``gmm diff``/``gmm timeline``):

* a ``*.jsonl`` file or a directory of per-rank streams is a recorded
  serve stream -- its ``drift`` events' serialized sketches are merged
  (sketch merge is exact, so N windows re-aggregate into one) and the
  merged window is re-scored against the envelope;
* anything else is a raw dataset file (the fit CLI's input formats):
  rows are scored under the registry model through the same
  :class:`~..serving.executor.ScoringExecutor` family the server uses,
  then sketched on the envelope's ladder.

``--rebuild-envelope`` flips the dataset mode from *judging* to
*publishing*: the computed envelope atomically replaces
``envelope.json`` for the (model, version) -- ``model.npz`` and
``manifest.json`` stay bit-identical -- which is how pre-v2.4 registry
versions are backfilled.

Exit-code contract (docs/API.md):

* 0 = clean (no gate tripped; report-only when no ``--fail-on`` given),
* 1 = at least one named gate tripped,
* 2 = usage error / unreadable target / version without an envelope.

Gates are ABSOLUTE (``psi>0.2`` trips when the observed PSI exceeds
0.2); relative ``%`` specs need a baseline run and belong to ``gmm
diff``, so they are rejected here.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Tuple

from . import sketch as tl_sketch
from .diff import FailSpec, stream_files
from .recorder import read_stream

# The metric namespace --fail-on specs may gate on: the keys of
# compare_to_envelope()'s verdict. A typo'd gate that could never trip
# is a silent hole in CI, so unknown metrics are a usage error (unlike
# gmm diff, whose metric space is open-ended).
GATE_METRICS = ("psi", "ks", "occupancy_l1", "window_rows")


def _check_gate(spec: FailSpec, value: Optional[float]) -> Optional[str]:
    """Absolute-threshold gate: a trip message, or None."""
    if value is None:
        return None
    tripped = (value > spec.threshold if spec.op == ">"
               else value < spec.threshold)
    if not tripped:
        return None
    return (f"{spec.metric}: {value:g} (limit "
            f"{spec.op}{spec.threshold:g})")


def _is_stream_target(path: str) -> bool:
    return os.path.isdir(path) or path.endswith(".jsonl")


def _merge_stream(path: str, model: Optional[str],
                  version: Optional[int]
                  ) -> Tuple[str, Optional[int],
                             tl_sketch.StreamSketch, List[int]]:
    """Merge a recorded stream's ``drift`` events into one window.

    Returns (model, version, merged sketch, summed occupancy); raises
    ValueError when the stream carries no usable drift events or spans
    several models and ``--model`` did not disambiguate.
    """
    files = stream_files(path)
    if not files:
        raise ValueError(f"{path}: no *.jsonl streams in directory")
    events: List[dict] = []
    for f in files:
        for r in read_stream(f):
            if not isinstance(r, dict) or r.get("event") != "drift":
                continue
            if model is not None and r.get("model") != model:
                continue
            if version is not None and r.get("version") != version:
                continue
            if r.get("score_sketch"):
                events.append(r)
    if not events:
        raise ValueError(
            f"{path}: no drift events"
            + (f" for model {model!r}" if model else "")
            + " (serve with --drift-interval-s to record them)")
    names = sorted({str(r.get("model")) for r in events})
    if len(names) > 1:
        raise ValueError(
            f"{path}: drift events for several models "
            f"({', '.join(names)}); pick one with --model")
    versions = sorted({r.get("version") for r in events
                       if r.get("version") is not None})
    sk = tl_sketch.StreamSketch.from_dict(events[0]["score_sketch"])
    occ_width = max((len(r.get("occupancy") or []) for r in events),
                    default=0)
    import numpy as np
    occ = np.zeros(max(occ_width, 1), dtype=np.int64)
    for i, r in enumerate(events):
        if i:
            sk.merge(tl_sketch.StreamSketch.from_dict(r["score_sketch"]))
        row = np.asarray(r.get("occupancy") or [], dtype=np.int64)
        occ[:len(row)] += row
    return (names[0], (versions[-1] if len(versions) == 1 else version),
            sk, [int(c) for c in occ])


def _sketch_dataset(path: str, served, bounds, device: str = "cuda"
                    ) -> Tuple[tl_sketch.StreamSketch, List[int]]:
    """Score a raw dataset under a registry model (the server's own
    executor family on ``device`` -- same shift, same numeric path) and
    sketch it on ``bounds``."""
    import numpy as np

    from ..io.readers import read_data
    from ..serving.executor import ScoringExecutor

    data = read_data(path)
    if data.ndim != 2 or data.shape[1] != served.d:
        raise ValueError(
            f"{path}: {data.shape} does not match model "
            f"{served.name}@{served.version} (d={served.d})")
    rows = data.astype(np.dtype(served.dtype), copy=False)
    rows = rows - served.data_shift[None, :].astype(rows.dtype)
    ex = ScoringExecutor(dtype=served.dtype, diag_only=served.diag_only,
                         device=device)
    sk = tl_sketch.StreamSketch(bounds)
    occ = np.zeros(served.k, dtype=np.int64)
    block = 65536
    for lo in range(0, rows.shape[0], block):
        w, logz = ex.infer(served.state, rows[lo:lo + block],
                           want="proba")
        sk.update(logz)
        occ += np.bincount(np.argmax(w[:, :served.k], axis=1),
                           minlength=served.k)
    return sk, [int(c) for c in occ]


def drift_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gmm drift",
        description="Compare a recorded serve stream (*.jsonl / stream "
                    "directory) or a raw dataset file against a "
                    "registry version's training envelope; gate on "
                    "PSI/KS/occupancy shift for CI.")
    parser.add_argument("target",
                        help="serve stream (*.jsonl file or per-rank "
                        "stream directory) or raw dataset file")
    parser.add_argument("--registry", required=True, metavar="DIR",
                        help="model registry root (gmm export)")
    parser.add_argument("--model", default=None,
                        help="model name (required for dataset targets; "
                        "inferred from a single-model stream)")
    parser.add_argument("--version", type=int, default=None,
                        help="registry version (default: stream's "
                        "version, else newest)")
    parser.add_argument("--fail-on", action="append", default=[],
                        metavar="SPEC",
                        help="absolute gate over "
                        + "/".join(GATE_METRICS)
                        + ", e.g. 'psi>0.2' or 'window_rows<100'. "
                        "Repeatable; no specs = report-only (exit 0).")
    parser.add_argument("--rebuild-envelope", action="store_true",
                        help="dataset targets only: recompute the "
                        "training envelope from TARGET and atomically "
                        "publish envelope.json for (model, version); "
                        "model.npz and manifest stay bit-identical")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable verdict on stdout")
    parser.add_argument("--device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="torch device for dataset scoring (default "
                        "cuda; without a GPU pass --device cpu; stream "
                        "targets never touch a device)")
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    specs: List[FailSpec] = []
    try:
        for raw in args.fail_on:
            spec = FailSpec(raw)
            if spec.relative:
                raise ValueError(
                    f"relative spec {raw!r}: gmm drift gates are "
                    f"absolute (use gmm diff for run-vs-run deltas)")
            if spec.metric not in GATE_METRICS:
                raise ValueError(
                    f"unknown drift metric {spec.metric!r} in {raw!r} "
                    f"(choose from {', '.join(GATE_METRICS)})")
            specs.append(spec)
    except ValueError as e:
        print(f"gmm drift: {e}")
        return 2

    from ..serving.registry import ModelRegistry, RegistryError

    stream_mode = _is_stream_target(args.target)
    if not stream_mode and not args.model:
        print("gmm drift: dataset targets need --model")
        return 2
    if args.rebuild_envelope and stream_mode:
        print("gmm drift: --rebuild-envelope needs a raw dataset "
              "target (a serve stream only holds windowed sketches)")
        return 2

    registry = ModelRegistry(args.registry)
    try:
        model_name = args.model
        version = args.version
        if stream_mode:
            model_name, version, sk, occ = _merge_stream(
                args.target, args.model, args.version)
            served = registry.load(model_name, version)
        else:
            served = registry.load(model_name, version)
            if args.rebuild_envelope:
                bounds = tl_sketch.SCORE_BOUNDS
            elif served.envelope and served.envelope.get("score"):
                bounds = served.envelope["score"]["bounds"]
            else:
                bounds = tl_sketch.SCORE_BOUNDS
            sk, occ = _sketch_dataset(args.target, served, bounds,
                                      args.device)
        version = int(served.version)
        model_name = served.name
    except (OSError, ValueError, RuntimeError, RegistryError) as e:
        print(f"gmm drift: {e}")
        return 2

    if args.rebuild_envelope:
        envelope = tl_sketch.make_envelope(
            sk, occ, k=served.k, num_events=sk.count)
        try:
            registry.publish_envelope(model_name, version, envelope)
        except (OSError, RegistryError) as e:
            print(f"gmm drift: {e}")
            return 2
        if args.json:
            print(json.dumps({
                "model": model_name, "version": version,
                "rebuilt": True,
                "envelope": tl_sketch.envelope_stanza(envelope),
            }, sort_keys=True))
        else:
            print(f"gmm drift: rebuilt envelope for "
                  f"{model_name}@{version} from {sk.count} rows "
                  f"(k={served.k}); model.npz/manifest untouched")
        return 0

    envelope = served.envelope
    if not envelope or not envelope.get("score"):
        print(f"gmm drift: {model_name}@{version} has no training "
              f"envelope (refit with envelope=True or backfill via "
              f"gmm drift --rebuild-envelope DATA)")
        return 2

    try:
        stats: Dict[str, float] = tl_sketch.compare_to_envelope(
            envelope, sk, occ)
    except ValueError as e:
        print(f"gmm drift: {e}")
        return 2

    failures = [msg for msg in (_check_gate(s, stats.get(s.metric))
                                for s in specs) if msg is not None]
    verdict = {
        "model": model_name,
        "version": version,
        "source": "stream" if stream_mode else "dataset",
        "target": args.target,
        "train_rows": int(envelope["score"].get("count", 0)),
        "fail_on": [s.raw for s in specs],
        "failures": failures,
        "clean": not failures,
        **stats,
    }
    if args.json:
        print(json.dumps(verdict, sort_keys=True))
        return 1 if failures else 0
    print(f"gmm drift: {model_name}@{version} vs "
          f"{'stream' if stream_mode else 'dataset'} {args.target}")
    print(f"  window_rows  {stats['window_rows']:>10}   "
          f"(envelope: {verdict['train_rows']} rows)")
    for name in ("psi", "ks", "occupancy_l1"):
        print(f"  {name:<12} {stats[name]:>10g}")
    if failures:
        for msg in failures:
            print(f"DRIFT {msg}")
        print(f"{len(failures)} gate(s) tripped")
        return 1
    print(f"clean: no gates tripped ({len(specs)} gates)")
    return 0
