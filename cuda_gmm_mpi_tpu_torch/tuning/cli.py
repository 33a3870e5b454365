"""``gmm tune``: the offline candidate sweep + decision table.

Runs the microprobe ladder for every probeable knob at a requested (or
file-derived) shape on ``--device`` (the card unless the caller asks for
the CPU), records the measurements into the tuning database, and prints
the decision table a subsequent ``--autotune db`` fit/serve will resolve
from. A fresh machine needs nothing but this command: the probes ARE the
measurements (no prior runs, no shipped DB). On the card the rows are
keyed ``gpu|<card name>|...``, beside any other platform's rows of the
same database file.

Exit codes: 0 = swept and wrote the DB, 1 = bad shape/flags, 2 = input
file unreadable (the fit CLI's convention).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def build_tune_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmm tune",
        description="Probe candidate knob settings at a shape and write "
                    "the tuning database (docs/PERF.md 'Autotuning').")
    p.add_argument("infile", nargs="?", default=None,
                   help="optional event file (CSV/BIN): probe on the "
                   "real data; omit to probe a synthetic --n/--d shape")
    p.add_argument("--n", type=int, default=20000,
                   help="synthetic event count (ignored with infile)")
    p.add_argument("--d", type=int, default=16,
                   help="synthetic dimensionality (ignored with infile)")
    p.add_argument("--k", type=int, default=8,
                   help="cluster count the probe fits at")
    p.add_argument("--covariance-type", default="full",
                   choices=["full", "diag", "spherical", "tied"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--probe-iters", type=int, default=3,
                   help="EM iterations per timed candidate call (2-3 "
                   "bounds the sweep; the first call also pays compile)")
    p.add_argument("--tuning-db", default=None, metavar="PATH",
                   help="database path (default GMM_TUNING_DB or "
                   "~/.cache/gmm/tuning.json)")
    p.add_argument("--envelope", action="store_true",
                   help="probe at the paper's reference envelope shape "
                   "(K=512, D=32) instead of --n/--d/--k; on the CPU "
                   "this is SLOW")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for the synthetic probe data")
    p.add_argument("--json", action="store_true",
                   help="emit the decision table as one JSON object "
                   "instead of text")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device the probe fits run on (default "
                   "cuda; without a GPU it exits 1 unless --device cpu)")
    return p


def _probe_data(args):
    """The events the probe fits: the real file when given, else a
    deterministic synthetic mixture of the requested shape."""
    import numpy as np

    if args.infile is not None:
        from ..io import read_data

        return np.asarray(read_data(args.infile), dtype=args.dtype)
    rng = np.random.default_rng(args.seed)
    n, d, k = int(args.n), int(args.d), int(args.k)
    centers = rng.normal(size=(k, d)) * 4.0
    assign = rng.integers(0, k, size=n)
    return (centers[assign]
            + rng.normal(size=(n, d))).astype(args.dtype)


def render_decision_table(decisions: List[dict]) -> str:
    """The human decision table: one knob per row, candidates ranked."""
    lines = ["knob                 chosen    source  candidates "
             "(wall/iter s)"]
    for d in decisions:
        cands = d.get("candidates") or {}

        def _rank(item):
            wall = item[1]
            return (wall if isinstance(wall, (int, float))
                    else float("inf"), item[0])

        shown = "  ".join(
            f"{name}:{wall:.4f}" if isinstance(wall, (int, float))
            else f"{name}:-"
            for name, wall in sorted(cands.items(), key=_rank)) or "-"
        chosen = "auto" if d.get("chosen") is None else d["chosen"]
        lines.append(f"{d['knob']:<20} {str(chosen):<9} "
                     f"{d['source']:<7} {shown}")
    return "\n".join(lines)


def tune_main(argv: Optional[List[str]] = None) -> int:
    args = build_tune_parser().parse_args(argv)
    if args.envelope:
        args.n = max(int(args.n), 100_000)
        args.d, args.k = 32, 512
    if args.k < 1 or args.d < 1 or args.n < 2:
        print("tune: need n >= 2, d >= 1, k >= 1", file=sys.stderr)
        return 1
    if args.probe_iters < 1:
        print("tune: --probe-iters must be >= 1", file=sys.stderr)
        return 1
    if args.infile is not None and not os.path.isfile(args.infile):
        print("Invalid infile.\n", file=sys.stderr)
        return 2

    from ..config import GMMConfig
    from .autotune import _platform_key, _resolve_knob, fit_knobs
    from .db import TuningDB
    from .probe import PROBEABLE, probe_knob

    from ..serving.executor import device_or_raise

    try:
        device_or_raise(args.device)
        config = GMMConfig(covariance_type=args.covariance_type,
                           dtype=args.dtype, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"tune: {e}", file=sys.stderr)
        return 1
    data = _probe_data(args)
    n_events, n_dims = (int(s) for s in data.shape)
    key = _platform_key(config, n_events, n_dims, args.k)
    db = TuningDB.open(args.tuning_db)
    if db.load_error:
        print(db.load_error, file=sys.stderr)

    decisions = []
    for knob in fit_knobs(key.platform):
        if knob == "restart_batch_size":
            continue  # meaningful only under n_init > 1 fits
        if knob in PROBEABLE:
            probe_knob(config, data, args.k, key, db, knob,
                       iters=args.probe_iters, full_ladder=True)
        d = _resolve_knob(knob, config, key, db, "db",
                          n_events=n_events)
        if d is not None:
            decisions.append(d)
    db.save()

    if args.json:
        print(json.dumps({"key": key.as_str(), "db": db.path,
                          "decisions": decisions}))
    else:
        print(f"tuning db: {db.path}")
        print(f"key:       {key.as_str()}")
        print(render_decision_table(decisions))
    return 0
