#!/usr/bin/env python3
"""S1 of this checkout against an earlier csrc/score.cu, on one NVIDIA GPU.

    git show 477d8c7:cuda_gmm_mpi_tpu_torch/csrc/score.cu > build/s1_first.cu
    python3 s1_ab.py --first build/s1_first.cu [--quick]

The earlier source must export the first version's ``gmm_score`` (commit
477d8c7: x, a, g, w, logz, labels, n, d, kb, diag, assign, centered,
is_double, stream). It is built with the library flags of
``ops/kernels/_build.py`` beside this checkout's kernels, and then:

1. ``chip_smoke.p17_bits_digests`` through each version, against
   ``chip_smoke.P17_BITS``;
2. both versions on seeded random models at D 1-255, Kb 1-1024 (inactive
   slots, a whole slot tile inactive), 1-20,011 rows, both forms, full and
   diag, float32 and float64, 'proba' and 'assign': ``torch.equal``
   (``--quick``: 37 rows, and the 20,011-row cases);
3. the device time of one launch of each (``chip_smoke.graph_ms``, in
   turns: first, this, this, first) at 64 / 256 / 4,096 / 65,536 rows of a
   K 96 of Kb 128, D 24 float32 model, both forms, full and diag, beside
   ``chip_smoke.s1_bound``;
4. this version's two kernels' device time at those shapes
   (torch.profiler).

It prints the card's name and power limit and one JSON line with every
number, and exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1

_P, _I = ctypes.c_void_p, ctypes.c_int
SHAPES = (64, 256, 4096, 65536)


def load_first(src: Path):
    """The earlier score.cu built into the package's build directory."""
    out = _build.BUILD_DIR / "libscore_first.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc()] + _build.ARCH + _build.BASE_FLAGS
                   + ["-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.gmm_score.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    lib.gmm_score.restype = ctypes.c_int

    def launch(x, a_ext, g, logz, *, diag, w=None, labels=None,
               centered=False):
        n, d = x.shape
        assign = w is None
        err = lib.gmm_score(
            x.data_ptr(), a_ext.data_ptr(), g.data_ptr(),
            0 if assign else w.data_ptr(), logz.data_ptr(),
            labels.data_ptr() if assign else 0, n, d, g.shape[0],
            int(diag), int(assign), int(centered),
            int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the first S1: CUDA error {err}")

    return launch


def model(k, kb, d, diag, centered, n, dt, seed=0, off=()):
    """S1's operands of a random K-slot model padded to Kb (slots ``off``
    inactive) and ``n`` rows near its means, on the card."""
    gen = torch.Generator().manual_seed(seed)
    f64 = dict(generator=gen, dtype=torch.float64)
    mu = torch.randn(k, d, **f64) * 3
    low = torch.randn(k, d, d, **f64) * 0.3
    rinv = low @ low.transpose(1, 2) + torch.eye(d, dtype=torch.float64)
    if diag:
        rinv = torch.diag_embed(torch.diagonal(rinv, dim1=1, dim2=2))
        tri = torch.diagonal(rinv, dim1=1, dim2=2)
    else:
        i, j = torch.triu_indices(d, d)
        tri = rinv[:, i, j] * torch.where(i == j, 1.0, 2.0).double()
    base = -30 - 10 * torch.rand(k, **f64)
    if centered:
        tail, gk = mu, base
    else:
        h = torch.einsum("kde,ke->kd", rinv, mu)
        tail, gk = -2 * h, -0.5 * (h * mu).sum(1) + base
    gk[list(off)] = -float("inf")
    a = torch.zeros(tri.shape[1] + d, kb, dtype=torch.float64)
    a[:, :k] = torch.cat([tri, tail], 1).T
    g = torch.full((kb,), -float("inf"), dtype=torch.float64)
    g[:k] = gk
    x = mu[torch.randint(0, k, (n,), generator=gen)] + torch.randn(n, d, **f64)
    return tuple(t.to(dt).cuda().contiguous() for t in (x, a, g))


def run(launch, x, a, g, diag, centered, kind):
    n, kb = x.shape[0], g.shape[0]
    z = torch.full((n,), 7.0, dtype=x.dtype, device="cuda")
    if kind == "proba":
        o = torch.full((n, kb), 7.0, dtype=x.dtype, device="cuda")
        launch(x, a, g, z, diag=diag, w=o, centered=centered)
    else:
        o = torch.full((n,), -7, dtype=torch.int32, device="cuda")
        launch(x, a, g, z, diag=diag, labels=o, centered=centered)
    return o, z


def digests(first) -> dict:
    this = cs.p17_bits_digests()
    keep = s1.score_launch
    s1.score_launch = first
    try:
        old = cs.p17_bits_digests()
    finally:
        s1.score_launch = keep
    return dict(cases=len(cs.P17_BITS),
                this_equal=sum(this[k] == v for k, v in cs.P17_BITS.items()),
                first_equal=sum(old[k] == v for k, v in cs.P17_BITS.items()))


def sweep(first, quick: bool) -> dict:
    cases = [(d, kb, min(12, kb), (1,) if kb > 2 else ())
             for d, kb in itertools.product((1, 5, 24, 64),
                                            (1, 16, 128, 1024))]
    cases += [(255, 16, 12, (3,)), (24, 1024, 700, (5, 600)),
              (24, 128, 96, tuple(range(32, 64)))]
    large = [(24, 128, 96, (5,)), (5, 256, 200, ()), (64, 128, 100, (1,)),
             (24, 128, 96, tuple(range(32, 64)))]
    equal, differ = 0, []
    for (d, kb, k, off), centered, diag, dt in itertools.product(
            cases + large, (False, True), (False, True),
            (torch.float32, torch.float64)):
        if (d, kb, k, off) in large:
            rows = (20011,)
        elif quick:
            rows = (37,)
        else:
            rows = (1, 37, 4097) if d < 255 else (1, 37, 300)
        for n in rows:
            x, a, g = model(k, kb, d, diag, centered, n, dt,
                            seed=d * 7 + kb, off=off)
            for kind in ("proba", "assign"):
                o1, z1 = run(s1.score_launch, x, a, g, diag, centered, kind)
                o2, z2 = run(s1.score_launch, x, a, g, diag, centered, kind)
                p1, q1 = run(first, x, a, g, diag, centered, kind)
                torch.cuda.synchronize()
                if (torch.equal(o1, p1) and torch.equal(z1, q1)
                        and torch.equal(o1, o2) and torch.equal(z1, z2)):
                    equal += 1
                else:
                    differ.append(f"d{d} kb{kb} k{k} n{n} centered "
                                  f"{centered} diag {diag} {dt} {kind}")
    return dict(equal=equal, differ=differ)


def timings(first) -> dict:
    out = {}
    for centered, diag in itertools.product((False, True), (False, True)):
        for n in SHAPES:
            x, a, g = model(96, 128, 24, diag, centered, n, torch.float32,
                            seed=n)
            z = torch.empty(n, device="cuda")
            w = torch.empty((n, 128), device="cuda")
            fns = {"first": lambda: first(x, a, g, z, diag=diag, w=w,
                                          centered=centered),
                   "this": lambda: s1.score_launch(x, a, g, z, diag=diag,
                                                   w=w, centered=centered)}
            t = {"first": [], "this": []}
            for who in ("first", "this", "this", "first"):
                t[who].append(cs.graph_ms(fns[who]))
            b, by = cs.s1_bound(n, 96, 128, 24, diag, centered)
            key = (f"{'centered' if centered else 'expanded'} "
                   f"{'diag' if diag else 'full'} {n}")
            out[key] = dict(first_ms=t["first"], this_ms=t["this"],
                            bound_ms=b, bound_by=by)
            print(f"  {key}: first {t['first'][0]:.4f} / "
                  f"{t['first'][1]:.4f} ms, this {t['this'][0]:.4f} / "
                  f"{t['this'][1]:.4f} ms (bound {b:.4f}, {by})")
    return out


def kernel_split() -> dict:
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for centered, diag in itertools.product((False, True), (False, True)):
        for n in SHAPES:
            x, a, g = model(96, 128, 24, diag, centered, n, torch.float32,
                            seed=n)
            z = torch.empty(n, device="cuda")
            w = torch.empty((n, 128), device="cuda")
            launch = lambda: s1.score_launch(x, a, g, z, diag=diag, w=w,
                                             centered=centered)
            launch()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    launch()
                torch.cuda.synchronize()
            parts = {}
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = ev.cuda_time_total
                for name in ("logp_kernel", "scan_kernel"):
                    if name in ev.key:
                        parts[name] = parts.get(name, 0.0) + t / 10e3
            key = (f"{'centered' if centered else 'expanded'} "
                   f"{'diag' if diag else 'full'} {n}")
            out[key] = parts
            print(f"  {key}: " + ", ".join(f"{k} {v:.4f} ms"
                                           for k, v in parts.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first", required=True, type=Path,
                    help="the earlier csrc/score.cu")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("s1_ab: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    _build.build_all()
    first = load_first(args.first)
    rec = dict(card=card, digests=digests(first))
    print(f"  digests equal to P17_BITS: this {rec['digests']['this_equal']}"
          f", first {rec['digests']['first_equal']} of "
          f"{rec['digests']['cases']}")
    rec["sweep"] = sweep(first, args.quick)
    print(f"  torch.equal to the first version: {rec['sweep']['equal']} "
          f"cases, {len(rec['sweep']['differ'])} differ "
          f"{rec['sweep']['differ'][:4]}")
    rec["times"] = timings(first)
    rec["split"] = kernel_split()
    print(json.dumps(rec))
    same = (rec["digests"]["this_equal"] == rec["digests"]["first_equal"]
            == rec["digests"]["cases"] and not rec["sweep"]["differ"])
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
