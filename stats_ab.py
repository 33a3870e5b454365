#!/usr/bin/env python3
"""K1's kernel source of this checkout against other versions of
csrc/fused_stats.cu, on its narrow route (K <= 64 at 'highest') and at the
main path's K = 100, on one NVIDIA GPU.

    python3 stats_ab.py [--other NAME=PATH ...] [--reps N]

Each other source must export this checkout's C entries of fused_stats.cu
(``ops/kernels/_build.py``'s SIGNATURES); all are built with that file's
flags, one nvcc each, started together. Then, on the shapes of
chip_smoke.py (seed 0):

1. K1 at K = 16, 32 and 64 (the narrow route) and 100 (the 128-wide
   route) on the main path's 1M x 24 events (one cluster inactive), and
   K3's per-lane-events form on phase 19's 32 tenants at K = 16 (31 live
   lanes of 33,000-65,536 events), full and diag, through each version:
   every version's outputs torch.equal to this checkout's;
2. the CUDA-event time of one launch of each version on prebuilt
   operands, in turns (this, the others, then back);
3. this checkout's per-lane form at K_pad 16, 32, 64 and 128 on prebuilt
   operands: torch.equal, and the time of each width in turns.

It prints the card's name and power limit, a line per case and one JSON
line with every number (also written to chiprun_out/stats_ab.json), and
exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

SRC = "fused_stats.cu"
K1_KS = (16, 32, 64, 100)


def build_others(others: dict) -> dict:
    """{name: loaded library} of the other sources, built in parallel."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = _build.ARCH + _build.BASE_FLAGS + _build.EXTRA_FLAGS.get(SRC, [])
    procs = {}
    for name, path in others.items():
        out = _build.BUILD_DIR / f"libfused_stats_{name}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc()] + flags + ["-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in _build.SIGNATURES[SRC]:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


def through(lib, fn):
    """``fn`` with the wrappers' launches going to ``lib``."""
    def run():
        with cs.using_lib(lib):
            return fn()
    return run


def k1_cases(x_np):
    for k in K1_KS:
        for diag in (False, True):
            _, _, _, (x, wt, A, h, g) = cs.stats_inputs(x_np, k, diag,
                                                        (k // 2,))
            d = x.shape[1]
            tile = fs.stats_tile(k, d, diag)
            a_ext, g_pad = fs._ext_operands(A, h, g, d, diag, tile.k_pad)[:2]
            yield (f"K1 K={k} {'diag' if diag else 'full'}",
                   functools.partial(fs._launch_k1, x, wt, a_ext, g_pad, k,
                                     diag, tile, "highest"))


def fleet_operands(tenants, diag):
    args, _, n_np, _ = cs.p19_form_operands(tenants, diag)
    x, wt, n, lanes, A, h, g = args
    return (x, wt, n, lanes, A, h, g), int(n_np.max())


def fleet_run(ops, diag, k_pad):
    (x, wt, n, lanes, A, h, g), most = ops
    k, d = A.shape[-1], x.shape[-1]
    tile = (fs.wide_tile(k, d, diag) if k_pad == fs.TILE
            else fs.stats_tile(k, d, diag)._replace(k_pad=k_pad))
    a_ext, g_pad = fs._ext_operands(A, h, g, d, diag, k_pad)[:2]
    return functools.partial(fs._launch_fleet, x, wt, n, lanes, a_ext, g_pad,
                             k, diag, tile, "highest", most)


def equal(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH", help="another fused_stats.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stats_ab: no CUDA device", file=sys.stderr)
        return 1
    others = dict(o.split("=", 1) for o in args.other)
    card = cs.card_line()
    print(card)
    _build.library(SRC)
    libs = {"this": _build._libs[SRC], **build_others(others)}
    rec = dict(card=card, versions=list(libs), cases={}, differ=[])

    def compare(label, run):
        ref = run()
        for name, lib in libs.items():
            if not equal(through(lib, run)(), ref):
                rec["differ"].append(f"{label}: {name}")
        times = cs.in_turns(*(through(lib, run) for lib in libs.values()),
                            reps=args.reps)
        rec["cases"][label] = dict(zip(libs, times))
        print(f"  {label}: " + ", ".join(f"{n} {t:.3f} ms"
                                         for n, t in zip(libs, times)))

    x_np = cs.make_blobs(0, cs.N_EVENTS, cs.DIMS, cs.K_TARGET)
    for label, run in k1_cases(x_np):
        compare(label, run)
    tenants = cs.p19_tenants(0)
    rec["fleet_widths"] = {}
    for diag in (False, True):
        ops = fleet_operands(tenants, diag)
        kind = "diag" if diag else "full"
        compare(f"per-lane form K=16 {kind}", fleet_run(ops, diag, 16))
        runs = {w: fleet_run(ops, diag, w) for w in fs.STATS_WIDTHS
                + (fs.TILE,)}
        ref = runs[16]()
        for w, run in runs.items():
            if not equal(run(), ref):
                rec["differ"].append(f"per-lane form {kind}: K_pad {w}")
        times = cs.in_turns(*runs.values(), reps=args.reps)
        rec["fleet_widths"][kind] = dict(zip(runs, times))
        print(f"  per-lane form K=16 {kind}, this version, in turns: "
              + ", ".join(f"K_pad {w} {t:.3f} ms"
                          for w, t in zip(runs, times)))
    print(f"  outputs differ: {rec['differ'] or 'none'}")
    line = json.dumps(rec)
    os.makedirs("chiprun_out", exist_ok=True)
    Path("chiprun_out/stats_ab.json").write_text(line + "\n")
    print(line)
    return 1 if rec["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
