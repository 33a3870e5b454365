#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cuda_gmm_mpi_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed S]

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written kernels from csrc/ with nvcc (parallel, one nvcc
   per source) and print the card's name and power limit;
2. K1 (fused E+M statistics) against its plain PyTorch version at the main
   path's shapes (the N=1,000,000 real events of the 65536-event chunk
   grid, D=24, K=100; full and diag covariance) and on a ragged N with
   inactive clusters, with the tests/test_pallas.py tolerance class applied
   normwise (max |kernel - plain| over each output against its largest
   entry: loglik 1e-5, Nk 1e-5, M1 1e-4, M2 1e-4 + 1e-3); two launches on
   the same inputs must be bit-identical. Both K1 and the plain version are
   also held against a float64 evaluation of the same function on the same
   inputs: K1's normwise error may be at most twice the plain version's
   (floored at the float32 epsilon 2^-23). On blobs centred far from the
   global mean (|x| ~ 170), where two float32 evaluations of the expanded
   quadratic form differ by more than the class, only this float64 check
   applies;
3. K2 (M-step epilogue) against its plain version: torch.equal;
4. the main path: a fit of 1,000,000 x 24 float32 events (well-separated
   Gaussian blobs made from --seed with numpy) from K=100 down to 96 with
   min = max = 20 EM iterations through K1/K2, with .summary and .results
   written; the launch counters must match the iteration counts; the same
   fit on the torch-ops path must select the same K and merge pairs with
   the final loglik within rtol 1e-4; then a shorter diag-only fit through
   the kernels, and a small float32 kernel fit against a float64 torch-ops
   fit on the CPU.

It prints a ``kernels:`` summary line, one JSON object with each kernel's
launches, error and times, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Times come from CUDA events; the
bound is the larger of the bytes over 3.35 TB/s and the operations over the
fp32 non-tensor peak of 67 TFLOP/s (matmul_precision 'highest' excludes
TF32), both for an H100 SXM at 700 W. K1's operations are what its
function needs on this run's real events: 2 N K (T+D) for logp and
2 N K (T+D+1) for Nk/M1/M2, with T = D(D+1)/2 distinct products of the
symmetric x x^T (T = D in diag mode). That is less than the TPU kernel's
own estimate of 4 N K D^2, which counts both triangles of x x^T.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
N_EVENTS, DIMS, K0, K_TARGET, ITERS = 1_000_000, 24, 100, 96, 20
TOL = {"ll": (1e-5, 0.0), "nk": (1e-5, 0.0), "m1": (1e-4, 0.0),
       "m2": (1e-4, 1e-3)}
FP32_EPS = 2.0 ** -23  # floor of the K1-vs-plain float64 error comparison
NEAR, FAR = 10.0, 60.0  # blob centres uniform in +-spread: |x| ~ 30 or ~ 170


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_blobs(seed: int, n: int, d: int, k: int,
               spread: float = NEAR) -> np.ndarray:
    """Well-separated Gaussian blobs of unequal sizes and spreads, so that
    no merge choice sits on a float32 knife-edge: centres uniform in
    +-spread per dimension against spreads of 0.5-1.5. At the default
    spread the expanded quadratic form's float32 cancellation (|x|^2 terms)
    stays small; FAR puts clusters far from the global mean."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(k, d))
    weights = rng.uniform(0.5, 1.5, size=k)
    labels = rng.choice(k, size=n, p=weights / weights.sum())
    scales = rng.uniform(0.5, 1.5, size=k)
    x = centers[labels] + rng.normal(size=(n, d)) * scales[labels, None]
    return x.astype(np.float32)


def stats_inputs(x_np, k, diag, inactive=(), chunk=65536):
    """K1's prepared inputs from a realistic state: seeded from the data,
    then one torch-ops M-step (so covariances are not the identity)."""
    import torch

    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats, apply_mstep
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_clusters

    x_np = x_np - x_np.mean(axis=0)
    chunks_np, wts_np = chunk_events(x_np, chunk)
    chunks = torch.as_tensor(chunks_np, device="cuda")
    wts = torch.as_tensor(wts_np, device="cuda")
    state = seed_clusters(torch.as_tensor(x_np, device="cuda"), k)
    state = apply_mstep(state, accumulate_stats(state, chunks, wts,
                                                diag_only=diag),
                        diag_only=diag)
    if inactive:
        active = state.active.clone()
        active[list(inactive)] = False
        state = state.replace(active=active)
    x, wt = fs._prep_events(chunks, wts)
    x, wt = x[:len(x_np)], wt[:len(x_np)]  # the real events, as fit_gmm does
    A, h, g = fs._prep_params(state, x.shape[1], diag)
    return state, chunks, wts, (x, wt, A, h, g)


def normwise(a, ref64) -> float:
    """max |a - ref| over the output against its largest |ref| entry."""
    err = float((a.double() - ref64).abs().max())
    return err / max(float(ref64.abs().max()), 1e-300)


def phase_k1(x_np, diag, inactive, label, timed, near=True):
    """K1 against its plain version (the tolerance class, where the data are
    well conditioned) and both against float64 (always)."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats

    k = K0
    chunk = 65536 if timed else x_np.shape[0]  # one unpadded chunk
    state, chunks, wts, args = stats_inputs(x_np, k, diag, inactive, chunk)
    x, wt, A, h, g = args
    out = fs.fused_stats(*args, diag=diag)
    out2 = fs.fused_stats(*args, diag=diag)
    ref = fs.fused_stats_plain(*args, diag=diag)
    ref64 = fs.fused_stats_plain(*(t.double() for t in args), diag=diag)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, out2)),
          f"K1 {label}: two launches differ")
    worst = worst_rel = worst64 = worst64_plain = 0.0
    for name, a, b, c in zip(("ll", "nk", "m1", "m2"), out, ref, ref64):
        check(bool(torch.isfinite(a).all()), f"K1 {label}: non-finite {name}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rtol, atol = TOL[name]
        check(not near or err <= atol + rtol * scale,
              f"K1 {label}: {name} max|err| {err:.3e} > {atol} + {rtol} x "
              f"{scale:.3e}")
        e64, p64 = normwise(a, c), normwise(b, c)
        check(e64 <= 2.0 * max(p64, FP32_EPS),
              f"K1 {label}: {name} float64 error {e64:.2e} > 2 x the plain "
              f"version's {p64:.2e}")
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(scale, 1e-30))
        worst64, worst64_plain = max(worst64, e64), max(worst64_plain, p64)
        print(f"  K1 {label} {name}: max|K1 - plain| {err:.3e} (normwise "
              f"{err / max(scale, 1e-30):.2e}); normwise vs float64: K1 "
              f"{e64:.2e}, plain {p64:.2e}")
    if inactive:
        check(bool((out[1][0, list(inactive)] == 0).all()),
              f"K1 {label}: inactive clusters got weight")
    rec = {"max_abs_err": worst, "normwise_err": worst_rel,
           "fp64_err": worst64, "plain_fp64_err": worst64_plain}
    if timed:
        n, d = x.shape
        f = A.shape[0]
        t = d if diag else d * (d + 1) // 2
        nbytes = 4 * (n * d + n + A.numel() + h.numel() + g.numel()
                      + 1 + k + k * d + k * f)
        flops = 2.0 * n * k * (t + d) + 2.0 * n * k * (t + d + 1)
        rec["ms"] = time_ms(lambda: fs.fused_stats(*args, diag=diag))
        rec["plain_ms"] = time_ms(lambda: fs.fused_stats_plain(*args, diag=diag))
        rec["library_ms"] = time_ms(
            lambda: accumulate_stats(state, chunks, wts, diag_only=diag))
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
        print(f"  K1 {label}: kernel {rec['ms']:.3f} ms, plain "
              f"{rec['plain_ms']:.3f} ms, torch-ops accumulate_stats "
              f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']})")
    return rec, (state, out)


def phase_k2(state, stats_out, diag, label):
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, mstep_update

    ll, nk, m1, m2 = stats_out
    K, D = state.means.shape
    nk = nk[0].clone()
    nk[1], nk[2] = 0.0, 0.7  # force the empty and dead-zone guards
    stats = SuffStats(ll[0, 0], nk, m1, m2 if diag else m2.reshape(K, D, D))
    ops = fs._mstep_operands(state, stats, diag)
    out = fs.mstep(*ops, diag=diag)
    ref = fs.mstep_plain(*ops, diag=diag)
    torch.cuda.synchronize()
    for name, a, b in zip(("n", "mean", "cov"), out, ref):
        check(torch.equal(a, b), f"K2 {label}: {name} differs from plain")
    N, means, R = mstep_update(state, stats, diag_only=diag)
    cov = torch.diag_embed(out[2]) if diag else out[2].reshape(K, D, D)
    check(torch.equal(out[0][:, 0], N) and torch.equal(out[1], means)
          and torch.equal(cov, R), f"K2 {label}: differs from mstep_update")
    f = ops[2].shape[1]
    nbytes = 4 * (3 * K + K * D + K * f + K + K * D + K * f)
    rec = {"max_abs_err": max(float((a - b).abs().max())
                              for a, b in zip(out, ref))}
    rec["ms"] = time_ms(lambda: fs.mstep(*ops, diag=diag), reps=20)
    rec["plain_ms"] = time_ms(lambda: fs.mstep_plain(*ops, diag=diag), reps=20)
    rec["torch_ops_ms"] = time_ms(
        lambda: mstep_update(state, stats, diag_only=diag), reps=20)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 8.0 * K * f)
    print(f"  K2 {label}: torch.equal to plain and to mstep_update; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, torch-ops "
          f"mstep_update {rec['torch_ops_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def fit(data, k0, target, iters, **cfg):
    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm

    config = GMMConfig(min_iters=iters, max_iters=iters, **cfg)
    model = GMMModel(config)
    t0 = time.perf_counter()
    result = fit_gmm(data, k0, target, config=config, model=model)
    return result, model, config, time.perf_counter() - t0


def phase_main_path(data, workdir: Path):
    import torch

    from cuda_gmm_mpi_tpu_torch.io import read_data, stream_results, write_bin, write_summary
    from cuda_gmm_mpi_tpu_torch.models import iter_memberships
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    infile = workdir / "events.bin"
    write_bin(str(infile), data)
    # --- the main path, counted: read, fit, write .summary and .results
    fs.fused_stats.launches = 0
    fs.mstep.launches = 0
    t0 = time.perf_counter()
    events = read_data(str(infile))
    result, model, config, fit_s = fit(events, K0, K_TARGET, ITERS)
    write_summary(str(workdir / "out.summary"), result)
    n_written = stream_results(str(workdir / "out.results"),
                               iter_memberships(result, events, config, model))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": fs.fused_stats.launches, "K2": fs.mstep.launches}
    check(model.estep_backend == "cuda",
          f"main path resolved to {model.estep_backend!r}")
    total_iters = sum(r[3] for r in result.sweep_log)
    n_k = len(result.sweep_log)
    print(f"  main path: K {K0} -> {result.ideal_num_clusters}, {n_k} Ks, "
          f"{total_iters} EM iterations, fit {fit_s:.2f} s, with I/O "
          f"{wall:.2f} s; launches K1 {launches['K1']}, K2 {launches['K2']}")
    for k, ll, score, it, secs in result.sweep_log:
        print(f"    K={k}: loglik {ll:.6e} rissanen {score:.6e} {it} iters "
              f"{secs:.3f} s ({it / secs:.2f} EM iters/s)")
    check(launches["K2"] == total_iters,
          f"K2 launched {launches['K2']} times for {total_iters} iterations")
    check(launches["K1"] == total_iters + n_k,
          f"K1 launched {launches['K1']} times for {total_iters} iterations "
          f"+ {n_k} initial E-steps")
    check(result.ideal_num_clusters == K_TARGET, "wrong final K")
    check(n_written == N_EVENTS, ".results row count")
    summary = (workdir / "out.summary").read_text()
    check(summary.count("Cluster #") == K_TARGET, ".summary cluster count")
    with open(workdir / "out.results") as f:
        head = [next(f) for _ in range(1000)]
    memb = np.array([[float(v) for v in line.split("\t")[1].split(",")]
                     for line in head])
    check(memb.shape == (1000, K_TARGET) and np.isfinite(memb).all()
          and np.allclose(memb.sum(axis=1), 1.0, atol=1e-4),
          ".results memberships")
    check(np.isfinite(result.means).all() and np.isfinite(result.final_loglik),
          "non-finite model")
    (workdir / "out.results").unlink()

    # --- the same fit on the torch-ops path (the yardstick)
    ref, ref_model, _, ref_s = fit(events, K0, K_TARGET, ITERS,
                                   estep_backend="torch")
    check(ref_model.estep_backend == "torch", "reference backend")
    pairs = [m[1] for m in result.merges]
    ref_pairs = [m[1] for m in ref.merges]
    print(f"  torch-ops path: fit {ref_s:.2f} s, final loglik "
          f"{ref.final_loglik:.9e} vs kernels {result.final_loglik:.9e}")
    check(ref.ideal_num_clusters == result.ideal_num_clusters,
          "kernel and torch-ops paths selected different K")
    check(pairs == ref_pairs,
          f"merge pairs differ: kernels {pairs}, torch ops {ref_pairs}")
    rel = abs(result.final_loglik - ref.final_loglik) / abs(ref.final_loglik)
    check(rel <= 1e-4, f"final loglik rtol {rel:.2e} > 1e-4")
    print(f"  same K ({result.ideal_num_clusters}) and merge pairs {pairs}; "
          f"final loglik rtol {rel:.2e}")
    em_kernel = sum(r[4] for r in result.sweep_log)
    em_ref = sum(r[4] for r in ref.sweep_log)
    print(f"  EM iters/s: kernels {total_iters / em_kernel:.2f}, torch ops "
          f"{sum(r[3] for r in ref.sweep_log) / em_ref:.2f}")
    return launches, result


def phase_diag(data):
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    k1, k2 = fs.fused_stats.launches, fs.mstep.launches
    result, model, _, secs = fit(data, K0, K0 - 8, 10, diag_only=True)
    it = sum(r[3] for r in result.sweep_log)
    d1, d2 = fs.fused_stats.launches - k1, fs.mstep.launches - k2
    check(model.estep_backend == "cuda" and d2 == it
          and d1 == it + len(result.sweep_log),
          f"diag fit launches K1 {d1}, K2 {d2} for {it} iterations")
    ks = [r[0] for r in result.sweep_log]
    check(np.isfinite(result.final_loglik) and np.isfinite(result.means).all()
          and result.ideal_num_clusters in ks, "diag fit result")
    print(f"  diag fit: Ks {ks} (best {result.ideal_num_clusters}), {it} EM "
          f"iterations in {secs:.2f} s through K1/K2")


def phase_small_reference(seed: int):
    """A small input through the kernels (float32, card) against the
    torch-ops path at float64 on the CPU."""
    rng = np.random.default_rng(seed + 7)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    res, model, _, _ = fit(x, 8, 4, 10)
    ref, _, _, _ = fit(x, 8, 4, 10, dtype="float64", device="cpu")
    check(model.estep_backend == "cuda", "small fit backend")
    check([m[1] for m in res.merges] == [m[1] for m in ref.merges],
          "small fit: merge pairs differ from the float64 CPU reference")
    err = float(np.abs(res.means - ref.means).max())
    check(err < 1e-3, f"small fit: means differ by {err:.2e}")
    print(f"  small input (2000 x 5, K 8 -> 4): same merge pairs as the "
          f"float64 CPU torch-ops fit, means within {err:.1e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()

    print("phase 1: build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"  built {len(_build.SIGNATURES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")

    print("phase 2: K1 against its plain version")
    data = make_blobs(args.seed, N_EVENTS, DIMS, K_TARGET)
    k1_full, (state_full, out_full) = phase_k1(data, False, (7, 50), "full",
                                               True)
    k1_diag, (state_diag, out_diag) = phase_k1(data, True, (7,), "diag", True)
    phase_k1(data[:999_997], False, (3,), "full ragged N=999997", False)
    far = make_blobs(args.seed + 1, N_EVENTS, DIMS, K_TARGET, spread=FAR)
    k1_far, _ = phase_k1(far, False, (7, 50), "full |x|~170", False, near=False)
    k1_far_diag, _ = phase_k1(far, True, (7,), "diag |x|~170", False,
                              near=False)
    del far

    print("phase 3: K2 against its plain version")
    k2_full = phase_k2(state_full, out_full, False, "full")
    phase_k2(state_diag, out_diag, True, "diag")

    print("phase 4: the main path")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        launches, _ = phase_main_path(data, workdir)
        phase_diag(data)
        phase_small_reference(args.seed)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    src = "cuda_gmm_mpi_tpu_torch/csrc/"
    pallas = "cuda_gmm_mpi_tpu/ops/pallas/fused_stats.py:"
    kernels = [
        dict(name="K1 fused_stats", route="cuda", source=src + "fused_stats.cu",
             replaces=pallas + "94", launches=launches["K1"],
             max_abs_err=k1_full["max_abs_err"],
             normwise_err=k1_full["normwise_err"],
             fp64_err=k1_full["fp64_err"],
             plain_fp64_err=k1_full["plain_fp64_err"],
             far_fp64_err=k1_far["fp64_err"],
             far_plain_fp64_err=k1_far["plain_fp64_err"],
             far_diag_fp64_err=k1_far_diag["fp64_err"],
             far_diag_plain_fp64_err=k1_far_diag["plain_fp64_err"],
             ms=k1_full["ms"],
             plain_ms=k1_full["plain_ms"], bound_ms=k1_full["bound_ms"],
             bound_by=k1_full["bound_by"], library_ms=k1_full["library_ms"],
             diag_ms=k1_diag["ms"], diag_plain_ms=k1_diag["plain_ms"],
             diag_library_ms=k1_diag["library_ms"],
             diag_bound_ms=k1_diag["bound_ms"]),
        dict(name="K2 mstep", route="cuda", source=src + "mstep.cu",
             replaces=pallas + "681", launches=launches["K2"],
             max_abs_err=k2_full["max_abs_err"], ms=k2_full["ms"],
             plain_ms=k2_full["plain_ms"], bound_ms=k2_full["bound_ms"],
             bound_by=k2_full["bound_by"], library_ms=None,
             torch_ops_ms=k2_full["torch_ops_ms"]),
    ]
    print("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} pass" for k in kernels)
        + f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
