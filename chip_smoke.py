#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cuda_gmm_mpi_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed S]

Phases (any failure exits non-zero, and no result line is printed):

1. build the hand-written kernels from csrc/ with nvcc (parallel, one nvcc
   per source) and print the card's name and power limit; beside the build,
   compile fused_stats.cu twice more: to a cubin with ``-Xptxas -v``, to
   print each ``fused_stats_kernel`` instance's (the 'high' and 'default'
   ones of K1/K3 and K5/K6 among them) and ``shard_kernel`` instance's
   registers, static shared memory and spills and, where the toolkit has
   cuobjdump, the HMMA (tensor-core) instructions in its SASS, and for the
   shard kernel (K5/K6 on a shard of at most 64 clusters) the CTAs per SM
   that its registers and its shared memory at D=24 allow, beside the
   card's occupancy calculator (which must fit the tile's CTAs per SM, and
   more than one); and with -DGMM_PHASE_CLOCKS, a library whose kernels
   count the cycles of their phases (phases 2 and 8 print each phase's
   share of one K1, K5 and K6 launch);
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
3. K2 (the whole M-step: the guarded update and the Cholesky constants,
   one launch) on the main path's state and K1's statistics, on the same
   with the guard cases forced (an empty cluster, a dead-zone one, an M2
   whose update is not positive definite, a NaN in M2) and with a cluster
   of condition number ~1e6 (full and diag): ok, N, means and R
   torch.equal to the plain version and to the torch-ops ``apply_mstep``,
   ok equal to the torch-ops and the float64 flags; Rinv and constant
   against a float64 ``compute_constants`` of the same updated R at most
   twice the torch-ops path's normwise error (floored at 2^-23); pi within
   4 ulps of torch ops; two launches bit-identical. Times: the launch
   alone on prebuilt operands, the whole M-step hook, torch-ops
   ``apply_mstep``, the plain version, and the launch floor (the same
   kernel at K = 1, D = 1);
4. the main path: a fit of 1,000,000 x 24 float32 events (well-separated
   Gaussian blobs made from --seed with numpy) from K=100 down to 96 with
   min = max = 20 EM iterations through K1/K2, read from BIN and with
   .summary and .results written through the native I/O library
   (``use_native='always'``); then the Python reader and writer
   (``'never'``) on the same file and model, timed the same way, the two
   .results held to tests/test_native_io.py's rule (a line may differ only
   in a last digit, on a tie) and both with-I/O walls printed; the launch
   counters must match the iteration counts; the same
   fit on the torch-ops path must select the same K and merge pairs with
   the final loglik within rtol 1e-4; then a shorter diag-only fit through
   the kernels, a small float32 kernel fit against a float64 torch-ops
   fit on the CPU, and a torch.profiler window (the card's activity only)
   over 5 EM iterations of the main path at full width (after a warm-up):
   the device's busy and idle share, device time by kernel name (top 10),
   and the mean gap between the end of one K1 launch and the start of the
   next;
5. K3 (restart-batched statistics) on R = 4 lanes at the main path's shapes
   (full and diag): four k-means++ seeds of the centred data, one lane with
   inactive clusters, lane 2 frozen by the lane mask. Every live lane must
   be bit-identical (torch.equal) to K1 on that lane's operands and the
   frozen lane all zeros; two launches bit-identical; against the plain
   version the phase-2 tolerance class over the live lanes, and against
   float64 at most twice the plain version's error. Then the batched EM
   loop (``run_em_batched``, 4 lanes, min 3 and per-lane max 40/8/40/20
   iterations) against ``run_em`` per lane through K1/K2: the same
   iteration counts and torch.equal loglik, means and R;
6. K4 (restart-batched M-step, R = 4 lanes) on K3's statistics and with
   phase 3's guard cases forced in every lane: each lane torch.equal to K2
   on its operands and held to the torch-ops M-step as K2 is; times as in
   phase 3 (torch ops: ``apply_mstep`` lane by lane);
7. the restart path: the phase-4 blobs fitted K = 100 -> 96 with min = max
   = 20 iterations, n_init = 4, restart_batch_size = 4 through K3/K4 (K3
   launches once per batched iteration plus once per sweep step, K4 once
   per iteration, K1/K2 never), then restart_batch_size = 1 (the
   sequential path through K1/K2): the same init_index, K and merge
   pairs, final loglik within rtol 1e-5;
8. K5 (local log-sum-exp) and K6 (statistics from the global logZ) against
   their plain versions on the phase-2 events, K = 100 split over C = 2 and
   C = 4 cluster shards, full and diag, the last shard with every cluster
   inactive: K5's per-event max and shifted sum against a float64
   evaluation, at most twice the plain version's error there (two float32
   evaluations of logp differ by more than 1e-6 normwise on full
   covariance); K6 in the phase-2 class; two
   launches bit-identical; the shards combined as
   ``fused_stats_cuda_sharded`` combines them (torch max and sum in place
   of the all_reduce calls) side by side against K1 on the whole K in the
   phase-2 class, and against float64 at most twice the plain
   combination's error. The same checks at K_s = 64 (the 64-wide shard
   kernel's widest shard), 65 (K1's kernel on one 128-wide tile) and 130
   (two tiles), on the first 524,288 events. Times, phase shares and CTAs
   per SM at the shape of one rank of phase 9 (the first 524,288 events,
   50 of the 100 clusters), beside the torch-ops route that full
   covariance takes on a cluster-sharded mesh today. Then K5/K6 at 'high'
   and 'default' (K1's kernel in their modes, every shard width), full and
   diag, at K_s = 50 (C = 2 on K = 100) and K_s = 130: each against its
   plain version at that precision (the phase-2 class; K6's M1/M2 at
   'default' within the mode's unit roundoff, 2^-9: one bf16 pass of w
   flips between two float32 evaluations), against float64 at twice the
   plain version's error floored at the mode's unit roundoff (2^-17,
   2^-9), the shards combined against K1 at that precision, bit-identical
   from launch to launch, and K5's max different from the 'highest'
   launch's; timed at one rank's shape beside the plain versions and the
   torch-ops local half at that precision;
9. the mesh path on the one card: a world of 4 ranks on cuda:0 (gloo,
   which stages the collectives through the host; a file:// store in the
   build directory), mesh (2, 2), each rank running ``fit_gmm`` on the
   phase-4 blobs with phase 4's diag fit (K = 100 -> 92, 10 iterations):
   every rank must report K5 and K6 launches equal to that fit's K1
   launches (and no K1 or K2 launch), the same K and merge pairs, and a
   final loglik within rtol 1e-4. Every rank times its fit's EM loop at
   its hooks (the statistics, the data-axis all_reduce, the M-step, each
   synchronised on the host clock; the rest is the host loop), so that the
   pieces add up to the iteration time; then, outside the fit, one
   iteration at K = 100 split finer (K5, the two collectives of [N]
   scalars, K6, the data all_reduce, the M-step). On the same ranks two
   more fits at the same depth: spherical at 'high' (every rank's K5/K6
   launches all at 'high' and > 0, the K, merge pairs and final loglik
   (rtol 1e-4) of a single-device spherical 'high' fit through K1) and
   diag at 'default' (its launches all at 'default' and > 0, a sweep down
   to K 92, a finite loglik);
10. the matmul precisions 'high' (three bf16 passes) and 'default' (one):
   K1 on phase 2's events, full and diag, held against its plain version
   at that precision (the phase-2 class), against float64 at most twice
   the plain version's error, and bit-identical from launch to launch,
   timed beside its plain version, torch-ops ``accumulate_stats`` at that
   precision and its phase shares; K3 as in phase 5 at each precision
   (each live lane torch.equal to K1 at that precision); then the main
   path (K 100 -> 96, 20 iterations) and the restart path (phase 7's batch)
   at each precision through the kernels, counted from zero, and at 'high'
   the main path on torch ops at 'high' beside it: the same K and merge
   pairs, final loglik within rtol 1e-4, EM iterations/s of both and of
   phase 4's 'highest' run;
11. ``GaussianMixture(100, target_components=96)``, 20 iterations per K,
   on phase 4's events: full, diag, spherical and tied on the kernel path
   (K1 launches every E-step; K2 every M-step of full/diag, never for
   spherical/tied, whose M-step is torch ops), each with the K, merge pairs
   and final loglik (rtol 1e-4) of the same fit on torch ops, its EM
   iterations/s, fit wall and one M-step's share of an iteration; a BIC
   search K 16 -> 1 on 200,000 events of 8 blobs (the torch-ops search's
   K); integer sample weights in {1, 2} against the replicated rows (same
   K and merge pairs, loglik rtol 1e-4, init pinned, no avgvar loading);
   predict_proba rows summing to 1 within 1e-5 and the sum of
   score_samples equal to loglik_ (rtol 1e-4) on the 1M events; the
   .summary round trip through ``from_summary``; and the CLI's
   --init-from and --predict-from on a 65,536-event BIN slice (formatting
   the 1M-event .results would add ~18 s), the --predict-from memberships
   held to the tie rule against ``from_summary(...).predict_proba``'s.

12. containment and resume on the card, at phase 4's main path (K 100 ->
   96, 20 iterations): (a) the fit with ``metrics_file`` and
   ``checkpoint_dir`` beside the same fit without them, in turns (bare,
   instrumented, instrumented, bare), EM iterations/s of each and the
   checkpoint write per K; with ``--parent DIR`` (a checkout of another
   commit, e.g. ``git archive`` of the parent) also that commit's main path
   in subprocesses, in turns with this one's (parent, this, this, parent),
   each subprocess ``python chip_smoke.py --rate-of ROOT`` building ROOT's
   kernels and timing its main path; (b) an injected ``nan_loglik`` at
   iteration 3 of K = 100 armed twice, so rung 1 (regularize, K1/K2) stays
   fatal and rung 2 ('centered') rebuilds the model on torch ops: each
   rung's route printed with its reason, the final K and merge pairs
   equal to the torch-ops path's under the same injection (loglik rtol
   1e-4), and the EM iterations/s the sticky 'centered' rung runs at; (c) a
   NaN in one cluster's mean through K1 (full, diag) and K3 (lane 2 of 4):
   the loglik non-finite and ``nonfinite_loglik`` set, as on the plain
   version (K1 takes its row maxima with fmaxf, which drops a NaN); (d) an
   injected ``preempt`` landing in the sweep's second K (K = 99), then
   resume: final loglik, K, sweep log and merge pairs ``==`` phase 4's
   uninterrupted fit, with the emergency and per-K checkpoint times; (e)
   4 batched restarts through K3/K4 with ``nan_loglik`` on restart 2: the
   same dropped restart and winner as the torch-ops batched path; (f) the
   event stream of (a) validated by the port's schema, its event counts.

13. the captured EM loop and the fused sweep (PR 11). The main path (and
   so phases 4, 10, 11 and 12) runs each EM iteration as one CUDA-graph
   replay (models/em_program.py). (a) phase 4's fit in turns eager
   (``GMMModel(_eager_em=True)``, the host loop), captured, captured,
   eager: K, merge pairs, sweep log, final loglik and best state ``==``
   (and ``==`` phase 4's), EM iterations/s of each, the capture seconds per
   width and the graph pool's bytes; phase 4's profiler window over 5
   captured iterations (idle share, K1 -> K1 gap); the captured
   iteration's host time with and without the one status read per replay.
   (b) the fused sweep on
   the same fit ``==`` the host sweep at ``sweep_k_buckets='off'`` (K,
   sweep log, final loglik, best state), its wall beside 'off' and 'pow2'
   (turns off, fused, pow2, pow2, fused, off); with ``checkpoint_dir`` the
   per-K emission's save; a stop requested during K = 99 lands at that K's
   emission (exit 75 in the CLI), and the resumed fit ``==`` the
   uninterrupted fused fit. (c) ``nan_loglik`` at iteration 3 of K = 100
   in the fused sweep under 'retry': the ``health``/``recovery``
   (``host_fallback``) records, and the host-driven fallback ``==`` phase
   4's fit (the fused program consumed the plan). (d) K1/K2's counters of
   (a) equal the iterations (and the initial E-steps).

14. the fit's observability at the main path's shape (K 100 -> 96, 20
   iterations). (a) The fit with ``metrics_file``, ``metrics_port=0``
   (the live plane), ``profile`` and the envelope, while a thread scrapes
   /metrics at ~10 Hz: the result ``==`` phase 4's (K, merge pairs, sweep
   log, final loglik, best state); the stream valid under the port's
   schema; its span tree fit > sweep > one em_k per K; one ``em_program``
   compile event per captured width, as the model's own capture log; the
   ``em_k`` and ``sweep`` watermarks not null and below the card's memory;
   no scrape error, the scrapes seeing ``gmm_em_iters_total`` rise and
   ``gmm_hbm_peak_bytes``; the envelope over 1,000,000 events with the
   occupancy summing to them; K1/K2 launches counted from zero. (b) Bare
   and observed fits in turns (bare, observed, observed, bare), EM
   iterations/s of each, and the envelope pass on its own, twice. (c) The
   bare fit under ``utils.profiling.trace`` (``--trace-dir``): the Chrome
   trace's K1 kernel events beside the launch counter plus the two
   uncounted warm-up launches of each captured width (a trace with no
   kernel event fails; a count that differs is printed, not hidden). (d) The
   port's CLI on (a)'s stream: ``report --validate``, ``diff`` against
   itself, ``runs`` and ``timeline --validate`` (exit 0 each), and
   ``report`` in a fresh process, which imports no jax.

15. the mesh made whole: 2 ranks of a (2, 1) mesh sharing the card over
   gloo (a ``file://`` store in the build directory), the main path's
   events at K = 100 -> 98 with 10 iterations per K. (a) ``--n-init 4``
   on the mesh against the one-card batched restart fit on the same events
   and seeds: the same chosen init, K and merge pairs, final loglik within
   rtol 1e-5; K3 and K4 launches per rank counted from 0 (K1/K2 never),
   ms per batched iteration and lane-iterations/s per rank (K4 launches x
   4 lanes over the EM seconds). (b) A ``preempt`` at iteration 4, first
   in K = 100, then (resumed) in K = 99, then the resume: both ranks stop
   at the same step and iteration (the CLI's exit 75), and the resumed fit
   == the uninterrupted mesh fit; rank 0's checkpoint ms per K. (c)
   ``rank_lost`` of rank 1 at iteration 3 of K = 100: without elastic
   both ranks stop with PeerLostError (exit 75) within the peer timeout
   plus the grace of the declaration; with elastic rank 1 leaves, rank 0
   seals generation 1 and finishes at world 1, its fit == one process
   resumed (elastic) from the first run's emergency sub-step. (d) The
   port's CLI on a BIN file, 2 ranks with ``--part-dir`` beside one
   process, at float64 (a float32 mesh sums the data axis in another
   order): each rank's range reads inside its ``host_range``, ``.summary``
   and ``.results`` byte-identical, each process's host memory above its
   CUDA baseline. (e) diag restarts (2 inits) on a (1, 2) mesh: the lanes
   of the cluster-sharded loop, K5 and K6 per lane (K1-K4 never), against
   the one-card batched fit (init, K, merge pairs, loglik rtol 1e-5). One
   JSON line per part, each with the card's name and power limit.

16. out-of-core EM (models/streaming.py, io/pipeline.py) at 10,000,000 x
   24 float32 events of phase 4's generator (960 MB, written to a BIN file
   in slices), K 100 -> 98, 10 iterations per K, 65,536-event blocks (153
   per pass). (a) Each fit in a process of its own (``--p16-arm``), after a
   warm-up fit, so that its host peak is its own: in memory (K1/K2 on the
   whole grid), streaming 'resident', streaming 'pipelined' and 'resident'
   at 1,048,576-event blocks: EM iterations/s after the first K, K1/K2
   launches (K1 once per block per pass, K2 once per M-step), the peak
   device memory and the peak VmRSS above the process's baseline (sampled
   every 10 ms). The streaming fits have the in-memory fit's K and merge
   pairs with the final loglik within rtol 1e-4; 'pipelined' equals
   'resident' exactly (means, R, pi, loglik), and its host peak lies at
   least 0.7 x the file below 'resident''s. (b) One pipelined pass under a
   torch.profiler window: K1's device time per block, the device idle
   share, the host-to-device copies and the host's wait on ingestion
   against the rest of the pass. (c) Stepwise EM on the pipelined 10M file
   (minibatches of 1,048,576 events, 40 steps per K): steps/s and the
   final loglik's distance from (a)'s full EM, printed; the bar of
   tests/test_ingest.py (within 10 x convergence_epsilon of full EM) in
   that test's regime at 1M events (4 blobs, K = 4, 12 full iterations
   against 340 steps over a quarter of the events). (d) On phase 4's 1M
   events, pipelined: a ``preempt`` at pass 3, block 7 of K = 100 stops
   the fit (exit 75 in the CLI) with the partial accumulator in the
   sub-step, and the resumed fit == the uninterrupted one. (e) 2 ranks of
   a (2, 1) data mesh on the one card (gloo), each streaming its half of
   the 1M BIN pipelined: each rank's K1 launches (8 blocks per pass) and
   K2 launches, the one-process streaming fit's K and merge pairs with the
   loglik within rtol 1e-5, ms per pass per rank.

It prints a ``kernels:`` summary line, one JSON object with each kernel's
launches, error and times, the card's name and power limit, and as its last
line ``{"ok": true, "device": {...}}``. Whatever happens, it leaves no
process of its own running when it exits: the mesh ranks are joined, the
resource tracker that ``spawn`` starts is stopped with them, and a last
sweep stops and reaps any process it started that still runs (a build or a
rank that a failed phase left behind). Times come from CUDA events; the
bound is the larger of the bytes over 3.35 TB/s and the operations over the
peak of the units that run them, for an H100 SXM at 700 W. K1's kernel
(K1, K3, K5, K6) at 'highest' runs phase 1 (logp) on the fp32 FMA units,
67 TFLOP/s, and phase 3 (the statistics) on the tensor cores in three TF32
passes (fp32-class error), three times its operations at 495 TFLOP/s; the
units run side by side, so its bound is the larger of the two times. At
'high' and 'default' (K1, K3) both products run on the tensor cores in
three or one bf16 passes at 989 TFLOP/s. The figure with every operation on
the FMA units stands beside it as ``fp32_bound_ms``. K1's operations are
what its function needs on this run's real events: 2 N K (T+D) for logp
and 2 N K (T+D+1) for Nk/M1/M2, with T = D(D+1)/2 distinct products of the
symmetric x x^T (T = D in diag mode). That is less than the TPU kernel's
own estimate of 4 N K D^2, which counts both triangles of x x^T. K3's are
the same per live lane. K2/K4's are the update's ~8 per covariance entry,
D^3/3 per cluster for the Cholesky and D^3/3 each for L^-1 and L^-T L^-1
where the factorization held, against their bytes (M2 in, R and Rinv out;
bytes bound them). K5's operations are
2 N K_s (T+D) for its shard's K_s clusters, K6's that plus
2 N K_s (T+D+1). K5 and K6 have no PyTorch call that computes their
function; beside them stands the torch-ops route of the same shard (its
arithmetic without the two collectives).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
TF32_PASSES = 3  # K1's kernel: small*big + big*small + big*big
BF16_PASSES = {"high": 3, "default": 1}  # K1/K3's bf16 modes, both products
N_EVENTS, DIMS, K0, K_TARGET, ITERS = 1_000_000, 24, 100, 96, 20
LANES = 4  # restarts per batch in phases 5-7
FROZEN = 2  # the lane phase 5 freezes through the lane mask
LANE_MAX_ITERS = np.array([40, 8, 40, 20])  # phase 5's per-lane bounds
MESH, DIAG_ITERS, DIAG_TARGET = (2, 2), 10, K0 - 8  # phase 9 = phase 4's diag fit
# Phase 9's fits at the bf16 precisions, phase 9's depth (K 100 -> 92, 10
# iterations): spherical at 'high' (held to the single-device fit), diag at
# 'default' (counted). Not 98: the spherical fit empties 6 clusters at
# K = 100, and the sweep's first merge then lands at K = 93.
BF16_MESH_FITS = (("spherical", "high"), ("diag", "default"))
BF16_MESH_TARGET = DIAG_TARGET
RANK_EVENTS, RANK_CLUSTERS = 524_288, K0 // 2  # one rank of phase 9 (K5/K6 times)
MESH_TIMEOUT_S = 420
TOL = {"ll": (1e-5, 0.0), "nk": (1e-5, 0.0), "m1": (1e-4, 0.0),
       "m2": (1e-4, 1e-3)}
FP32_EPS = 2.0 ** -23  # floor of the K1-vs-plain float64 error comparison
# The floor of that comparison per precision: the mode's unit roundoff
# ('high' keeps 16 of an operand's 24 mantissa bits, 'default' 8).
FP64_FLOOR = {"highest": FP32_EPS, "high": 2.0 ** -17, "default": 2.0 ** -9}


def hold_stat(label, name, a, plain, ref64, precision) -> bool:
    """A K6 statistic (or the K5 + K6 combination's) at ``precision``:
    against float64 at most twice its plain version's error, floored at the
    mode's unit roundoff, always; against the plain version in the phase-2
    class, which it may miss only where the plain version itself lies
    outside that class of float64 (never at 'highest'): there two float32
    evaluations of the mode differ by their own error (K6's weights
    exp(logp - logZ) carry logp's absolute error; one bf16 pass rounds each
    w to 8 bits: tests/test_torch_cuda.py's ``_hold_stat``). An all-zero
    float64 reference (the all-masked shard) needs an all-zero output.
    Returns whether it met the class."""
    import torch

    check(bool(torch.isfinite(a).all()), f"{label}: non-finite {name}")
    if float(ref64.abs().max()) == 0.0:
        check(not a.any(), f"{label}: {name} not zero on the masked shard")
        return True
    e64, p64 = normwise(a, ref64), normwise(plain, ref64)
    check(e64 <= 2.0 * max(p64, FP64_FLOOR[precision]),
          f"{label}: {name} float64 error {e64:.2e} > 2 x the plain "
          f"version's {p64:.2e}")
    rtol, atol = TOL[name]
    err, scale = float((a - plain).abs().max()), float(plain.abs().max())
    met = err <= atol + rtol * scale
    check(met or (precision != "highest" and p64 > rtol),
          f"{label}: {name} max|err| {err:.3e} > {atol} + {rtol} x {scale:.3e}"
          f" (the plain version's float64 error {p64:.2e})")
    return met
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


def route_bound(nbytes: float, fma_flops: float, tc_flops: float = 0.0,
                precision: str = "highest") -> dict:
    """The bound of K1's kernel (K1, K3, K5, K6) on its route: at 'highest'
    phase 1's flops on the fp32 FMA units and phase 3's three TF32 passes
    on the tensor cores, which run side by side, so the larger time; at
    'high' / 'default' both products on the tensor cores in three / one
    bf16 passes. Beside it the figure with every flop on the FMA units."""
    if precision == "highest":
        t_ops = max(fma_flops / FP32_FLOPS_PER_S,
                    TF32_PASSES * tc_flops / TF32_FLOPS_PER_S) * 1e3
    else:
        t_ops = (BF16_PASSES[precision] * (fma_flops + tc_flops)
                 / BF16_FLOPS_PER_S * 1e3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "fp32_bound_ms": bound_ms(nbytes, fma_flops + tc_flops)[0]}


KERNEL_MODES = {"0": "stats (K1/K3)", "1": "local_lse (K5)",
                "2": "stats_logz (K6)"}
SM_REGISTERS, REG_UNIT, THREADS = 65536, 8, 256  # per SM; per-thread unit; per CTA


PHASES = ("events", "phase 1 (logp, FMA)", "phase 2 (log-sum-exp or w)",
          "phase 3 products (tensor cores)", "phase 3 partial-buffer update")


def start_extra_builds():
    """Two more compiles of fused_stats.cu, started now so that they run
    beside the library build: a cubin with nvcc -Xptxas -v (read by
    :func:`kernel_report`) and a library with -DGMM_PHASE_CLOCKS (used by
    :func:`phase_shares`). Returns (cubin, clocks library, processes)."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "fused_stats.cu")
    cubin = _build.BUILD_DIR / "fused_stats_report.cubin"
    clocks = _build.BUILD_DIR / "libfused_stats_clocks.so"
    cmds = [[_build.nvcc()] + _build.ARCH + ["-std=c++17", "-O3", "-cubin",
                                             "-Xptxas", "-v", "-o", str(cubin), src],
            [_build.nvcc()] + _build.ARCH + _build.BASE_FLAGS
            + ["-DGMM_PHASE_CLOCKS", "-o", str(clocks), src]]
    return cubin, clocks, [subprocess.Popen(c, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
                           for c in cmds]


def load_fused_stats(path):
    """A build of fused_stats.cu loaded with ctypes, its K1/K3/K5/K6 entry
    points typed."""
    import ctypes

    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build.SIGNATURES["fused_stats.cu"][:4]:
        getattr(lib, name).argtypes = argtypes
    return lib


@contextlib.contextmanager
def using_lib(lib):
    """The kernel wrappers launch from ``lib`` (another build of
    fused_stats.cu) inside the block."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build

    saved = _build._libs["fused_stats.cu"]
    _build._libs["fused_stats.cu"] = lib
    try:
        yield
    finally:
        _build._libs["fused_stats.cu"] = saved


def phase_shares(clocks, launch) -> dict:
    """``launch`` (a call of a K1, K5 or K6 wrapper) twice through the
    -DGMM_PHASE_CLOCKS build: each phase's share of the cycles that thread 0
    of every CTA counted between the barriers in the second call (two
    launches more, outside any counted run)."""
    import ctypes

    import torch

    lib = load_fused_stats(clocks)
    lib.gmm_phase_cycles.argtypes = [ctypes.c_void_p]
    cycles = np.zeros(len(PHASES), np.uint64)
    with using_lib(lib):
        launch()
        torch.cuda.synchronize()
        check(lib.gmm_phase_cycles(cycles.ctypes.data) == 0, "phase clocks reset")
        launch()
        torch.cuda.synchronize()
        check(lib.gmm_phase_cycles(cycles.ctypes.data) == 0, "phase clocks read")
    total = float(cycles.sum())
    return {name: float(c) / total for name, c in zip(PHASES, cycles)}


def shares_line(shares: dict) -> str:
    return ", ".join(f"{k} {100 * v:.1f}%" for k, v in shares.items())


def kernel_report(cubin, procs) -> list:
    """Waits for :func:`start_extra_builds`; returns the registers, static
    shared memory and spills of each fused_stats_kernel and shard_kernel
    instance, and its HMMA instructions where the toolkit has cuobjdump
    (else None); for the shard kernel also the CTAs per SM that its
    registers, its shared memory at D=DIMS (the mesh cell's) and the card's
    occupancy calculator allow. Call after the libraries are built."""
    import ctypes
    import re

    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    logs = [proc.communicate(timeout=600)[0] for proc in procs]
    for proc, log in zip(procs, logs):
        check(proc.returncode == 0, f"nvcc failed:\n{log}")
    log = logs[0]
    props, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S+?)'?(?: for|$)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or not re.search("fused_stats_kernel|shard_kernel",
                                            current):
            continue
        rec = props.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rec["static_smem"] = int(m.group(1)) if m else 0
    hmma = {}
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    if Path(tool).exists():
        sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        current = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                hmma[current] = 0
            elif current and "HMMA" in line:
                hmma[current] += 1
    out = []
    lib = _build.library("fused_stats.cu")
    for name, rec in sorted(props.items()):
        m = (re.search(r"fused_stats_kernelILi(\d)ELb([01])ELi(\d+)ELi(\d)E",
                       name)
             or re.search(r"shard_kernelILi(\d)ELb([01])EE", name))
        check(m is not None and "registers" in rec,
              f"unparsed ptxas report for {name}: {rec}")
        mode, diag = m.group(1), m.group(2) == "1"
        width = "diag" if diag else "full"
        if "shard_kernel" not in name:
            prec = ("", " high", " default")[int(m.group(4))]
            out.append(dict(instance=f"{KERNEL_MODES[mode]} {width} "
                            f"{m.group(3)}-row tiles{prec}",
                            hmma=hmma.get(name), **rec))
            continue
        tile = fs.shard_tile(RANK_CLUSTERS, DIMS, diag, stats=mode == "2")
        regs = -(-rec["registers"] // REG_UNIT) * REG_UNIT
        card = ctypes.c_int(0)
        check(lib.gmm_shard_occupancy(int(mode), DIMS, int(diag),
                                      ctypes.addressof(card)) == 0,
              "gmm_shard_occupancy failed")
        rec.update(
            ctas_by_registers=SM_REGISTERS // (regs * THREADS),
            ctas_by_smem=fs.SM_SMEM_BYTES // (tile.smem + rec["static_smem"]
                                               + fs.CTA_RESERVED_SMEM),
            ctas_card=card.value, ctas_tile=tile.ctas_per_sm,
            smem=tile.smem)
        check(card.value >= tile.ctas_per_sm > 1,
              f"shard kernel {name}: {card.value} CTAs per SM fit on the card, "
              f"the tile counts on {tile.ctas_per_sm}")
        out.append(dict(instance=f"{KERNEL_MODES[mode]} {width} 64-wide shard "
                        f"tile", hmma=hmma.get(name), **rec))
    # 12 'highest' instances of K1's kernel (3 modes x full/diag x 64/128-row
    # tiles), 24 in 'high'/'default' (K1/K3, K5 and K6 alike), 4 of the
    # shard kernel.
    check(len(out) == 40, f"{len(out)} kernel instances reported")
    return out


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


def phase_k1(x_np, diag, inactive, label, timed, near=True, clocks=None,
             precision="highest"):
    """K1 against its plain version at ``precision`` (the tolerance class,
    where the data are well conditioned) and both against float64
    (always); when timed, its time and (with the ``clocks`` library) its
    phases' shares."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats

    k = K0
    chunk = 65536 if timed else x_np.shape[0]  # one unpadded chunk
    state, chunks, wts, args = stats_inputs(x_np, k, diag, inactive, chunk)
    x, wt, A, h, g = args
    k1 = functools.partial(fs.fused_stats, *args, diag=diag,
                           precision=precision)
    plain = functools.partial(fs.fused_stats_plain, *args, diag=diag,
                              precision=precision)
    out, out2, ref = k1(), k1(), plain()
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
        rec["ms"] = time_ms(k1)
        rec["plain_ms"] = time_ms(plain)
        rec["library_ms"] = time_ms(
            lambda: accumulate_stats(state, chunks, wts, diag_only=diag,
                                     matmul_precision=precision))
        rec.update(route_bound(nbytes, 2.0 * n * k * (t + d),
                               2.0 * n * k * (t + d + 1), precision))
        print(f"  K1 {label}: kernel {rec['ms']:.3f} ms, plain "
              f"{rec['plain_ms']:.3f} ms, torch-ops accumulate_stats "
              f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}; fp32 non-tensor "
              f"{rec['fp32_bound_ms']:.3f} ms)")
        if clocks is not None:
            rec["phase_shares"] = phase_shares(clocks, k1)
            print(f"  K1 {label} phases (thread-0 cycles of every CTA): "
                  + shares_line(rec["phase_shares"]))
    return rec, (state, out)


def guard_stats(stats, diag, rng):
    """The main path's statistics with the M-step's guard cases forced in
    clusters 1-4: empty (Nk = 0), dead zone (Nk = 0.7), an M2 whose update
    has a negative eigenvalue, a NaN in M2 below the diagonal."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats

    nk, m2 = stats.Nk.clone(), stats.M2.clone()
    nk[1], nk[2], nk[3], nk[4] = 0.0, 0.7, 50.0, 50.0
    d = stats.M1.shape[-1]
    for c, last in ((3, -1.0), (4, 1.0)):
        mu = stats.M1[c] / nk[c]
        if diag:
            m2[c] = nk[c] * (mu * mu + 1.0)
        else:
            q, _ = torch.linalg.qr(torch.as_tensor(
                rng.normal(size=(d, d)), dtype=torch.float32, device="cuda"))
            lam = torch.ones(d, device="cuda")
            lam[-1] = last
            m2[c] = nk[c] * (torch.outer(mu, mu) + (q * lam) @ q.T)
    if diag:
        m2[3, 0] -= 2.0 * nk[3]
        m2[4, 1] = float("nan")
    else:
        m2[4, 3, 1] = float("nan")
    return SuffStats(stats.loglik, nk, stats.M1, m2)


def ill_conditioned(state, stats, diag, rng, c=5):
    """Cluster ``c`` made to update to R = M2 with condition number 1e6
    (Nk = 1, zero mean and loading; M2 = Q diag(1 .. 1e-6) Q^T, or that
    diagonal). Returns (state, stats, cond)."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, mstep_update

    d = stats.M1.shape[-1]
    lam = np.logspace(0.0, -6.0, d)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    nk, m1, m2 = stats.Nk.clone(), stats.M1.clone(), stats.M2.clone()
    nk[c], m1[c] = 1.0, 0.0
    m2[c] = torch.as_tensor(lam if diag else (q * lam) @ q.T,
                            dtype=torch.float32, device="cuda")
    avgvar = state.avgvar.clone()
    avgvar[c] = 0.0
    state = state.replace(avgvar=avgvar)
    stats = SuffStats(stats.loglik, nk, m1, m2)
    R = mstep_update(state, stats, diag_only=diag)[2][c].double()
    return state, stats, float(torch.linalg.cond(R))


def hold_mstep(out, state, stats, diag, label, only=slice(None)):
    """K2's (or one K4 lane's) outputs against the torch-ops M-step
    (``apply_mstep``, which the plain version computes term for term):
    ``ok`` equal to its flag, N, means and R torch.equal; Rinv and constant
    (of the clusters ``only``) against a float64 ``compute_constants`` of
    the same updated R at most twice the torch-ops path's normwise error
    (floored at 2^-23); pi within 4 ulps. Returns the float64 errors."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.constants import constants
    from cuda_gmm_mpi_tpu_torch.ops.mstep import apply_mstep, mstep_update

    n, mean, R, Rinv, constant, pi, ok = out
    N, means, R_upd = mstep_update(state, stats, diag_only=diag)
    ref = apply_mstep(state, stats, diag_only=diag)
    ref_ok = constants(N, R_upd, state.active, diag_only=diag)[4]
    check(torch.equal(ok, ref_ok), f"{label}: ok differs from torch ops")
    check(torch.equal(n, ref.N) and torch.equal(mean, ref.means)
          and torch.equal(R, ref.R), f"{label}: N, means or R differ from "
          "torch ops")
    _, rinv64, const64, _, ok64 = constants(N.double(), R_upd.double(),
                                            state.active, diag_only=diag)
    check(torch.equal(ok64, ok), f"{label}: ok differs from float64's")
    errs = {}
    for name, a, b, c in (("rinv", Rinv, ref.Rinv, rinv64),
                          ("const", constant, ref.constant, const64)):
        e, p = normwise(a[only], c[only]), normwise(b[only], c[only])
        check(e <= 2.0 * max(p, FP32_EPS), f"{label}: {name} float64 error "
              f"{e:.2e} > 2 x the torch-ops path's {p:.2e}")
        errs[name + "_fp64_err"], errs["plain_" + name + "_fp64_err"] = e, p
    spacing = torch.nextafter(ref.pi.abs(), torch.full_like(ref.pi, np.inf))
    ulps = float(((pi - ref.pi).abs() / (spacing - ref.pi.abs())).max())
    check(ulps <= 4.0, f"{label}: pi {ulps:.1f} ulps from torch ops")
    errs["pi_ulps"] = ulps
    return errs


def mstep_bound(out, k: int, d: int, diag: bool, lanes: int = 1):
    """(bound ms, by) of K2/K4 on these outputs: the bytes of each input
    read once and each output written once, against the update's ~8 flops
    per element, the Cholesky's D^3/3 per cluster and D^3/3 each for L^-1
    and L^-T L^-1 where the factorization held (full); the reciprocal and
    log per diagonal entry (diag)."""
    f = d if diag else d * d
    nbytes = lanes * (4 * (2 * k + k * d + k * f) + k  # nk, avgvar, m1, m2; act
                      + 4 * (3 * k + k * d + 2 * k * d * d) + k)  # outputs; ok
    n_ok = int(out[6].sum())
    flops = lanes * 8.0 * k * f + (2.0 * lanes * k * d if diag else
                                   lanes * k * d ** 3 / 3 + n_ok * 2 * d ** 3 / 3)
    return bound_ms(nbytes, flops)


def mstep_times(ops, hook, torch_ops, launch, plain, floor_ops) -> dict:
    """K2's or K4's times (CUDA events, 20 calls): the launch alone on
    prebuilt operands, the whole M-step hook, the torch-ops M-step, the
    plain version, and the same kernel at K = 1, D = 1 (the launch
    floor)."""
    return {"ms": time_ms(lambda: launch(*ops), reps=20),
            "hook_ms": time_ms(hook, reps=20),
            "torch_ops_ms": time_ms(torch_ops, reps=20),
            "plain_ms": time_ms(lambda: plain(*ops), reps=20),
            "launch_floor_ms": time_ms(lambda: launch(*floor_ops), reps=20)}


def floor_operands(diag, lanes=()):
    """K = 1, D = 1 operands (an empty cluster) for the launch floor."""
    import torch

    z = lambda *s: torch.zeros(lanes + s, device="cuda")
    return (z(1), z(1, 1), z(1, 1), z(1),
            torch.ones(lanes + (1,), dtype=torch.bool, device="cuda"))


def phase_k2(state, stats_out, diag, label, seed):
    """K2 on the main path's state and K1's statistics (the main path's
    case), the same with the guard cases forced, and with a cluster of
    condition number 1e6; then its times."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_mstep_fn
    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, apply_mstep

    rng = np.random.default_rng(seed)
    ll, nk, m1, m2 = stats_out
    K, D = state.means.shape
    stats = SuffStats(ll[0, 0], nk[0], m1, m2 if diag else m2.reshape(K, D, D))
    cases = {"main path": (state, stats),
             "guards": (state, guard_stats(stats, diag, rng))}
    st_c, stats_c, cond = ill_conditioned(state, stats, diag, rng)
    check(3e5 < cond < 3e6, f"K2 {label}: cond {cond:.2e}, not ~1e6")
    cases["cond 1e6"] = (st_c, stats_c)
    rec = {"cond": cond}
    for case, (st, sts) in cases.items():
        ops = fs._mstep_operands(st, sts, diag)
        out = fs.mstep(*ops, diag=diag)
        again = fs.mstep(*ops, diag=diag)
        plain = fs.mstep_plain(*ops, diag=diag)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K2 {label} {case}: two launches differ")
        check(all(torch.equal(out[i], plain[i]) for i in (0, 1, 2, 6)),
              f"K2 {label} {case}: ok, N, means or R differ from plain")
        errs = hold_mstep(out, st, sts, diag, f"K2 {label} {case}",
                          only=slice(5, 6) if case == "cond 1e6" else slice(None))
        if case == "guards":
            check(not out[6][3] and not out[6][4] and bool(out[6][1:3].all()),
                  f"K2 {label}: guard clusters' ok {out[6][1:5].tolist()}")
        tag = {"main path": "", "guards": "guards_", "cond 1e6": "cond_"}[case]
        rec.update({tag + key: v for key, v in errs.items()})
        print(f"  K2 {label} {case}: ok, N, means, R torch.equal to plain and "
              f"torch ops; float64 error Rinv {errs['rinv_fp64_err']:.2e} "
              f"(torch ops {errs['plain_rinv_fp64_err']:.2e}), constant "
              f"{errs['const_fp64_err']:.2e} ({errs['plain_const_fp64_err']:.2e}"
              f"), pi {errs['pi_ulps']:.1f} ulps")
    ops = fs._mstep_operands(state, stats, diag)
    out = fs.mstep(*ops, diag=diag)
    rec["max_abs_err"] = max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(out, fs.mstep_plain(*ops, diag=diag)))
    hook = make_mstep_fn(GMMConfig(diag_only=diag))
    rec.update(mstep_times(
        ops, lambda: hook(state, stats),
        lambda: apply_mstep(state, stats, diag_only=diag),
        functools.partial(fs.mstep, diag=diag),
        functools.partial(fs.mstep_plain, diag=diag), floor_operands(diag)))
    rec["bound_ms"], rec["bound_by"] = mstep_bound(out, K, D, diag)
    print(f"  K2 {label}: launch {rec['ms']:.4f} ms, hook {rec['hook_ms']:.4f}"
          f" ms, torch-ops apply_mstep {rec['torch_ops_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, launch floor (K = D = 1) "
          f"{rec['launch_floor_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms "
          f"({rec['bound_by']})")
    return rec


def fit(data, k0, target, iters, eager=False, **cfg):
    """One ``fit_gmm`` on a fresh model; ``eager`` runs the host EM loop
    (``GMMModel(_eager_em=True)``) in place of the captured one."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm

    config = GMMConfig(min_iters=iters, max_iters=iters, **cfg)
    model = GMMModel(config, **({"_eager_em": True} if eager else {}))
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
    events = read_data(str(infile), use_native="always")
    t_read = time.perf_counter() - t0
    result, model, config, fit_s = fit(events, K0, K_TARGET, ITERS)
    write_summary(str(workdir / "out.summary"), result)
    t1 = time.perf_counter()
    n_written = stream_results(str(workdir / "out.results"),
                               iter_memberships(result, events, config, model),
                               use_native="always")
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t1
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
    io = native_io(infile, workdir, result, events, config, model, wall,
                   t_read, t_write)

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
    io["em_iters_per_s"] = total_iters / em_kernel
    return launches, result, io


def _results_tie_rule(a_path, b_path) -> int:
    """tests/test_native_io.py's rule between the native and the Python
    .results: a line may differ only in last digits on ties (every value
    within 2e-6, the same field count). Returns the differing lines."""
    differ = 0
    with open(a_path) as fa, open(b_path) as fb:
        for n, (x, y) in enumerate(itertools.zip_longest(fa, fb)):
            check(x is not None and y is not None,
                  f".results line counts differ at line {n}")
            if x == y:
                continue
            differ += 1
            xs = x.replace("\t", ",").split(",")
            ys = y.replace("\t", ",").split(",")
            check(len(xs) == len(ys) and np.allclose(
                np.array(xs, float), np.array(ys, float), rtol=0, atol=2e-6),
                f".results line {n} differs beyond a tie: {x!r} / {y!r}")
    return differ


def native_io(infile, workdir, result, events, config, model, wall, t_read,
              t_write) -> dict:
    """Phase 4's I/O: the counted run read the BIN file and wrote .results
    through the native library (use_native='always'); here the Python
    reader and writer ('never') on the same file and model, timed the same
    way, and the two .results held to the tie rule. The with-I/O walls
    differ by the reader's and the writer's times."""
    from cuda_gmm_mpi_tpu_torch.io import read_data, stream_results
    from cuda_gmm_mpi_tpu_torch.models import iter_memberships

    t0 = time.perf_counter()
    py_events = read_data(str(infile), use_native="never")
    py_read = time.perf_counter() - t0
    check(np.array_equal(py_events, events), "native and Python readers differ")
    t0 = time.perf_counter()
    stream_results(str(workdir / "py.results"),
                   iter_memberships(result, events, config, model),
                   use_native="never")
    py_write = time.perf_counter() - t0
    t0 = time.perf_counter()  # the memberships alone, formatted by neither
    for _ in iter_memberships(result, events, config, model):
        pass
    memb_s = time.perf_counter() - t0
    differ = _results_tie_rule(workdir / "out.results", workdir / "py.results")
    rec = {"native_read_s": t_read, "native_write_s": t_write,
           "python_read_s": py_read, "python_write_s": py_write,
           "with_io_native_s": wall,
           "with_io_python_s": wall - t_read - t_write + py_read + py_write,
           "memberships_s": memb_s,
           "results_lines_differing_on_ties": differ}
    print(f"  I/O: reader native {t_read:.2f} s, Python {py_read:.2f} s; "
          f".results writer native {t_write:.2f} s, Python {py_write:.2f} s "
          f"({differ} lines differ on ties), of which the memberships "
          f"(posteriors on the card, copied to the host) {memb_s:.2f} s; "
          f"with-I/O wall native "
          f"{rec['with_io_native_s']:.2f} s, Python "
          f"{rec['with_io_python_s']:.2f} s")
    for f in ("out.results", "py.results"):
        (workdir / f).unlink()
    return rec


def phase_diag(data):
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    k1, k2 = fs.fused_stats.launches, fs.mstep.launches
    result, model, _, secs = fit(data, K0, DIAG_TARGET, DIAG_ITERS,
                                 diag_only=True)
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
    return result, d1


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


def profile_em(data, iters: int = 5) -> dict:
    """A torch.profiler window over ``iters`` EM iterations of the main path
    at full width (``GMMModel.run_em`` from the phase-2 state, after a
    warm-up run). The profiler traces the card only (tracing host ops would
    slow the host loop it measures), so the window is the device's: from
    the start of the initial E-step's K1 to the end of the last K1. In it:
    the device's busy and idle share, device time by kernel name, and the
    mean gap between one K1 launch's end (its reduction kernel) and the
    next one's start -- the rest of the iteration, as the card sees it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    state, chunks, wts, _ = stats_inputs(data, K0, False)
    model = GMMModel(GMMConfig(min_iters=iters, max_iters=iters))
    run = functools.partial(model.run_em, state, chunks, wts,
                            convergence_epsilon(*data.shape),
                            n_events=len(data))
    run()
    torch.cuda.synchronize()
    # The profiler keeps only device activities inside its window, on its
    # own clock; the host sleeps keep the first K1 and the last reduction
    # well inside it (they add no device activity).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        run()
        torch.cuda.synchronize()
        time.sleep(0.02)
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in dev if "fused_stats_kernel" in e.name]
    ends = [e.time_range.end for e in dev if "reduce_partials" in e.name]
    check(len(starts) == iters + 1 and len(ends) == iters + 1,
          f"profiler: {len(starts)} K1 kernels, {len(ends)} reductions for "
          f"{iters} iterations + the initial E-step")
    lo, hi = starts[0], ends[-1]
    busy, end = 0.0, lo
    for e in dev:  # the union of the device intervals inside the window
        a, b = max(e.time_range.start, end), min(e.time_range.end, hi)
        if b > a:
            busy += b - a
        end = max(end, e.time_range.end)
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = [s - e for s, e in zip(starts[1:], ends[:-1])]
    rec = {"window_ms": (hi - lo) / 1e3, "iterations": iters,
           "device_busy_share": busy / (hi - lo),
           "device_idle_share": 1.0 - busy / (hi - lo),
           "k1_gap_ms": float(np.mean(gaps)) / 1e3,
           "k1_ms": float(np.mean([e - s for s, e in zip(starts, ends)])) / 1e3,
           "top_kernels_ms": {n: t / 1e3 for n, t in top}}
    print(f"  profiler window (device, captured loop): {iters} EM "
          f"iterations from the "
          f"initial E-step's K1 to the last K1, {rec['window_ms']:.3f} ms; "
          f"device busy {100 * rec['device_busy_share']:.1f}%, idle "
          f"{100 * rec['device_idle_share']:.1f}%; K1 (kernel + reduction) "
          f"{rec['k1_ms']:.3f} ms, mean gap between K1 launches "
          f"{rec['k1_gap_ms']:.3f} ms")
    print("  device time by kernel (ms, whole window): " + "; ".join(
        f"{n[:60]} {t:.3f}" for n, t in rec["top_kernels_ms"].items()))
    return rec


def restart_rows(x_np, seed: int):
    """The centred data and LANES k-means++ seed-row sets of it (seeds
    seed .. seed+LANES-1)."""
    from cuda_gmm_mpi_tpu_torch.ops.seeding import kmeanspp_indices

    x_np = x_np - x_np.mean(axis=0)
    return x_np, [x_np[kmeanspp_indices(x_np, K0, seed=seed + r)]
                  for r in range(LANES)]


def restart_lanes(x_np, rows, diag, chunk=65536):
    """Lane states from the seed rows, each after one torch-ops M-step (so
    covariances are not the identity); lane 1 with inactive clusters.
    Returns (states, chunks, wts, x, wt) with x, wt the real events."""
    import torch

    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats, apply_mstep
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_state_from_parts

    n = x_np.shape[0]
    chunks_np, wts_np = chunk_events(x_np, chunk)
    chunks = torch.as_tensor(chunks_np, device="cuda")
    wts = torch.as_tensor(wts_np, device="cuda")
    var = float(x_np.var(axis=0).mean())
    states = []
    for r in range(LANES):
        s = seed_state_from_parts(rows[r], n, var, K0, device="cuda")
        s = apply_mstep(s, accumulate_stats(s, chunks, wts, diag_only=diag),
                        diag_only=diag)
        if r == 1:
            active = s.active.clone()
            active[[7, 50]] = False
            s = s.replace(active=active)
        states.append(s)
    x, wt = fs._prep_events(chunks, wts)
    return states, chunks, wts, x[:n], wt[:n]


def phase_k3(lanes_in, diag, label, precision="highest"):
    """K3 against K1 per lane (torch.equal), its plain version and float64,
    at ``precision``."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats

    states, chunks, wts, x, wt = lanes_in
    n, d = x.shape
    params = [fs._prep_params(s, d, diag) for s in states]
    A, h, g = (torch.stack(p) for p in zip(*params))
    lanes = torch.ones(LANES, dtype=torch.float32, device="cuda")
    lanes[FROZEN] = 0.0
    live = [r for r in range(LANES) if r != FROZEN]
    args = (x, wt, lanes, A, h, g)
    kw = dict(diag=diag, precision=precision)
    out = fs.fused_stats_batched(*args, **kw)
    out2 = fs.fused_stats_batched(*args, **kw)
    ref = fs.fused_stats_batched_plain(*args, **kw)
    ref64 = fs.fused_stats_batched_plain(*(t.double() for t in args),
                                         diag=diag)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, out2)),
          f"K3 {label}: two launches differ")
    for r in live:
        one = fs.fused_stats(x, wt, *params[r], **kw)
        check(all(torch.equal(a[r], b) for a, b in zip(out, one)),
              f"K3 {label}: lane {r} differs from K1 on its operands")
    check(not any(bool(o[FROZEN].any()) for o in out),
          f"K3 {label}: frozen lane {FROZEN} is not all zeros")
    check(bool((out[1][1, 0, [7, 50]] == 0).all()),
          f"K3 {label}: inactive clusters got weight")
    worst = worst64 = worst64_plain = 0.0
    for name, a, b, c in zip(("ll", "nk", "m1", "m2"), out, ref, ref64):
        a, b, c = a[live], b[live], c[live]
        check(bool(torch.isfinite(a).all()), f"K3 {label}: non-finite {name}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        rtol, atol = TOL[name]
        check(err <= atol + rtol * scale,
              f"K3 {label}: {name} max|err| {err:.3e} > {atol} + {rtol} x "
              f"{scale:.3e}")
        e64, p64 = normwise(a, c), normwise(b, c)
        check(e64 <= 2.0 * max(p64, FP32_EPS),
              f"K3 {label}: {name} float64 error {e64:.2e} > 2 x the plain "
              f"version's {p64:.2e}")
        worst = max(worst, err)
        worst64, worst64_plain = max(worst64, e64), max(worst64_plain, p64)
        print(f"  K3 {label} {name}: max|K3 - plain| {err:.3e} (normwise "
              f"{err / max(scale, 1e-30):.2e}); normwise vs float64: K3 "
              f"{e64:.2e}, plain {p64:.2e}")
    del ref64
    f = A.shape[1]
    t = d if diag else d * (d + 1) // 2
    nbytes = 4 * (n * d + n + LANES + A.numel() + h.numel() + g.numel()
                  + LANES * (1 + K0 + K0 * d + K0 * f))
    rec = {"max_abs_err": worst, "fp64_err": worst64,
           "plain_fp64_err": worst64_plain}
    rec["ms"] = time_ms(lambda: fs.fused_stats_batched(*args, **kw))
    all_live = torch.ones_like(lanes)
    rec["all_live_ms"] = time_ms(
        lambda: fs.fused_stats_batched(x, wt, all_live, A, h, g, **kw))
    rec["k1_x4_ms"] = LANES * time_ms(
        lambda: fs.fused_stats(x, wt, *params[0], **kw))
    rec["plain_ms"] = time_ms(
        lambda: fs.fused_stats_batched_plain(*args, **kw), reps=2)
    rec["library_ms"] = time_ms(lambda: [
        accumulate_stats(states[r], chunks, wts, diag_only=diag,
                         matmul_precision=precision)
        for r in live], reps=2)
    rec.update(route_bound(nbytes, len(live) * 2.0 * n * K0 * (t + d),
                           len(live) * 2.0 * n * K0 * (t + d + 1), precision))
    print(f"  K3 {label}: every live lane torch.equal to K1, frozen lane "
          f"zeros; kernel {rec['ms']:.3f} ms ({len(live)} live lanes), "
          f"{rec['all_live_ms']:.3f} ms ({LANES} live lanes), {LANES} x K1 "
          f"{rec['k1_x4_ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
          f"torch-ops accumulate_stats over the live lanes "
          f"{rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
          f"({rec['bound_by']}; fp32 non-tensor {rec['fp32_bound_ms']:.3f} ms)")
    return rec, out


def phase_em_batched(lanes_in):
    """run_em_batched on LANES lanes against run_em per lane, K3/K4 against
    K1/K2: the same iteration counts, bit-identical loglik, means and R."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
    from cuda_gmm_mpi_tpu_torch.state import stack_states

    states, chunks, wts, x, _ = lanes_in
    n, d = x.shape
    model = GMMModel(GMMConfig(min_iters=3, max_iters=int(LANE_MAX_ITERS.max())))
    eps = convergence_epsilon(n, d)
    t0 = time.perf_counter()
    b_states, b_ll, b_iters = model.run_em_batched(
        stack_states(states), chunks, wts, eps, max_iters=LANE_MAX_ITERS,
        n_events=n)
    b_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r in range(LANES):
        s, ll, it = model.run_em(states[r], chunks, wts, eps,
                                 max_iters=int(LANE_MAX_ITERS[r]), n_events=n)
        check(it == b_iters[r] and ll == b_ll[r]
              and torch.equal(s.means, b_states.means[r])
              and torch.equal(s.R, b_states.R[r]),
              f"batched EM lane {r}: {b_iters[r]} iterations, loglik "
              f"{b_ll[r]!r} against run_em's {it}, {ll!r} (or means/R "
              "differ)")
    print(f"  batched EM: iterations per lane {b_iters.tolist()} (bounds "
          f"{LANE_MAX_ITERS.tolist()}), loglik, means and R torch.equal to "
          f"run_em per lane; batched {b_s:.2f} s, per lane "
          f"{time.perf_counter() - t0:.2f} s")


def phase_k4(states, k3_out, diag, label, seed):
    """K4 on R = 4 lanes of K3's statistics with the guard cases forced in
    every lane: each lane torch.equal to K2 on its operands and held to
    the torch-ops M-step as K2 is; then its times."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.models.gmm import lane_loop_mstep
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_mstep_fn
    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, apply_mstep
    from cuda_gmm_mpi_tpu_torch.state import lane, stack_states

    rng = np.random.default_rng(seed)
    ll, nk, m1, m2 = k3_out
    R, K, D = m1.shape
    b_states = stack_states(states)
    stats = SuffStats(ll[:, 0, 0], nk[:, 0], m1,
                      m2 if diag else m2.reshape(R, K, D, D))
    guarded = stack_states([guard_stats(lane(stats, r), diag, rng)
                            for r in range(R)])
    rec = {}
    for case, sts in (("K3 statistics", stats), ("guards", guarded)):
        ops = fs._mstep_operands(b_states, sts, diag)
        out = fs.mstep_batched(*ops, diag=diag)
        plain = fs.mstep_batched_plain(*ops, diag=diag)
        torch.cuda.synchronize()
        check(all(torch.equal(out[i], plain[i]) for i in (0, 1, 2, 6)),
              f"K4 {label} {case}: ok, N, means or R differ from plain")
        worst = {}
        for r in range(R):
            one = fs.mstep(*(o[r] for o in ops), diag=diag)
            check(all(torch.equal(a[r], b) for a, b in zip(out, one)),
                  f"K4 {label} {case}: lane {r} differs from K2")
            errs = hold_mstep(tuple(o[r] for o in out), lane(b_states, r),
                              lane(sts, r), diag, f"K4 {label} {case} lane {r}")
            worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
        if case == "guards":
            rec.update({"guards_" + k: v for k, v in worst.items()})
        else:
            rec.update(worst)
        print(f"  K4 {label} {case}: each lane torch.equal to K2, ok, N, "
              f"means, R to plain and torch ops; worst float64 error Rinv "
              f"{worst['rinv_fp64_err']:.2e} (torch ops "
              f"{worst['plain_rinv_fp64_err']:.2e}), constant "
              f"{worst['const_fp64_err']:.2e} "
              f"({worst['plain_const_fp64_err']:.2e}), pi "
              f"{worst['pi_ulps']:.1f} ulps")
    ops = fs._mstep_operands(b_states, stats, diag)
    out = fs.mstep_batched(*ops, diag=diag)
    rec["max_abs_err"] = max(
        float((a.float() - b.float()).abs().max())
        for a, b in zip(out, fs.mstep_batched_plain(*ops, diag=diag)))
    hook = make_mstep_fn(GMMConfig(diag_only=diag), batched=True)
    lanes = lane_loop_mstep(functools.partial(apply_mstep, diag_only=diag))
    rec.update(mstep_times(
        ops, lambda: hook(b_states, stats), lambda: lanes(b_states, stats),
        functools.partial(fs.mstep_batched, diag=diag),
        functools.partial(fs.mstep_batched_plain, diag=diag),
        floor_operands(diag, (R,))))
    rec["bound_ms"], rec["bound_by"] = mstep_bound(out, K, D, diag, R)
    print(f"  K4 {label}: launch {rec['ms']:.4f} ms, hook {rec['hook_ms']:.4f}"
          f" ms, torch-ops apply_mstep x {R} lanes {rec['torch_ops_ms']:.4f} "
          f"ms, plain {rec['plain_ms']:.4f} ms, launch floor (K = D = 1, "
          f"{R} lanes) {rec['launch_floor_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    return rec


def phase_restarts(data):
    """The restart path end to end through K3/K4, then the sequential
    restart path through K1/K2 on the same seeds."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    counted = (fs.fused_stats, fs.mstep, fs.fused_stats_batched,
               fs.mstep_batched)
    for fn in counted:
        fn.launches = 0
    result, model, _, fit_s = fit(data, K0, K_TARGET, ITERS, n_init=LANES,
                                  restart_batch_size=LANES)
    launches = dict(zip(("K1", "K2", "K3", "K4"),
                        (fn.launches for fn in counted)))
    check(model.estep_backend == "cuda",
          f"restart path resolved to {model.estep_backend!r}")
    iters = sum(r[3] for r in result.sweep_log)  # min = max: every lane's
    steps = len(result.sweep_log)
    em_s = sum(r[4] for r in result.sweep_log)
    print(f"  batched restarts: {LANES} inits, K {K0} -> "
          f"{result.ideal_num_clusters}, winner init {result.init_index}, "
          f"{steps} sweep steps of {iters // steps} iterations, fit "
          f"{fit_s:.2f} s, EM {em_s:.2f} s = {LANES * iters / em_s:.2f} "
          f"lane-iterations/s; launches {launches}")
    check(launches["K3"] == iters + steps,
          f"K3 launched {launches['K3']} times for {iters} batched "
          f"iterations + {steps} sweep steps")
    check(launches["K4"] == iters,
          f"K4 launched {launches['K4']} times for {iters} iterations")
    check(launches["K1"] == 0 and launches["K2"] == 0,
          f"K1/K2 launched on the batched path: {launches}")
    check(result.ideal_num_clusters == K_TARGET, "wrong final K")
    check(np.isfinite(result.means).all() and np.isfinite(result.final_loglik),
          "non-finite model")
    k1 = fs.fused_stats.launches
    seq, _, _, seq_s = fit(data, K0, K_TARGET, ITERS, n_init=LANES,
                           restart_batch_size=1)
    seq_em = sum(r[4] for r in seq.sweep_log)
    check(fs.fused_stats.launches > k1, "sequential path skipped K1")
    pairs = [m[1] for m in result.merges]
    seq_pairs = [m[1] for m in seq.merges]
    rel = abs(result.final_loglik - seq.final_loglik) / abs(seq.final_loglik)
    print(f"  sequential restarts: fit {seq_s:.2f} s, winner init "
          f"{seq.init_index}, winner's EM {seq_em:.2f} s "
          f"({iters / seq_em:.2f} iterations/s); final loglik rtol {rel:.2e}")
    check(seq.init_index == result.init_index,
          f"winner init {result.init_index} batched, {seq.init_index} "
          "sequential")
    check(seq.ideal_num_clusters == result.ideal_num_clusters,
          "batched and sequential restarts selected different K")
    check(pairs == seq_pairs,
          f"merge pairs differ: batched {pairs}, sequential {seq_pairs}")
    check(rel <= 1e-5, f"final loglik rtol {rel:.2e} > 1e-5")
    t = result.timings
    rest = fit_s - sum(t.values())
    print(f"  batched fit breakdown (host clock, in the fit): data prep "
          f"{t['prepare']:.2f} s, {LANES} seedings {t['seed']:.2f} s, EM "
          f"{t['em']:.2f} s, {steps - 1} merge scans {t['merge']:.2f} s, "
          f"rest {rest:.2f} s of {fit_s:.2f} s")
    check(rest >= 0.0, f"the fit's parts exceed its wall by {-rest:.3f} s")
    return launches


def phase_precision_path(data, precision: str, highest_rate: float) -> dict:
    """The main path (K 100 -> 96, ITERS iterations per K) at ``precision``
    through K1/K2, counted from zero; at 'high' the same fit on torch ops at
    'high' beside it: the same K and merge pairs, final loglik within rtol
    1e-4. Prints EM iterations/s of both and of phase 4's 'highest' run."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    fs.fused_stats.launches = 0
    fs.mstep.launches = 0
    result, model, _, fit_s = fit(data, K0, K_TARGET, ITERS,
                                  matmul_precision=precision)
    launches = {"K1": fs.fused_stats.launches, "K2": fs.mstep.launches}
    iters = sum(r[3] for r in result.sweep_log)
    n_k = len(result.sweep_log)
    check(model.estep_backend == "cuda",
          f"{precision} main path resolved to {model.estep_backend!r}")
    check(launches["K1"] == iters + n_k and launches["K2"] == iters,
          f"{precision} main path: launches {launches} for {iters} "
          f"iterations and {n_k} Ks")
    check(result.ideal_num_clusters == K_TARGET
          and np.isfinite(result.final_loglik)
          and np.isfinite(result.means).all(), f"{precision} main path result")
    rate = iters / sum(r[4] for r in result.sweep_log)
    rec = {"launches": launches, "em_iters_per_s": rate, "fit_s": fit_s}
    line = (f"  main path at '{precision}': K {K0} -> "
            f"{result.ideal_num_clusters}, {iters} EM iterations, fit "
            f"{fit_s:.2f} s; launches {launches}; EM iters/s: kernels "
            f"{rate:.2f}")
    if precision == "high":
        ref, ref_model, _, _ = fit(data, K0, K_TARGET, ITERS,
                                   estep_backend="torch",
                                   matmul_precision=precision)
        check(ref_model.estep_backend == "torch", "reference backend")
        pairs = [m[1] for m in result.merges]
        ref_pairs = [m[1] for m in ref.merges]
        check(ref.ideal_num_clusters == result.ideal_num_clusters
              and pairs == ref_pairs,
              f"'high': kernels K {result.ideal_num_clusters} pairs {pairs}, "
              f"torch ops K {ref.ideal_num_clusters} pairs {ref_pairs}")
        rel = abs(result.final_loglik - ref.final_loglik) / abs(ref.final_loglik)
        check(rel <= 1e-4, f"'high' final loglik rtol {rel:.2e} > 1e-4")
        rec["torch_ops_em_iters_per_s"] = (
            sum(r[3] for r in ref.sweep_log) / sum(r[4] for r in ref.sweep_log))
        rec["final_loglik_rtol"] = rel
        line += (f", torch ops at 'high' {rec['torch_ops_em_iters_per_s']:.2f}"
                 f" (same K and merge pairs, final loglik rtol {rel:.2e})")
    print(line + f"; 'highest' (phase 4) {highest_rate:.2f}")
    return rec


def phase_precision_restarts(data, precision: str) -> dict:
    """The restart path (phase 7's batch of LANES inits) at ``precision``
    through K3/K4, counted from zero."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    counted = (fs.fused_stats, fs.mstep, fs.fused_stats_batched,
               fs.mstep_batched)
    for fn in counted:
        fn.launches = 0
    result, model, _, fit_s = fit(data, K0, K_TARGET, ITERS, n_init=LANES,
                                  restart_batch_size=LANES,
                                  matmul_precision=precision)
    launches = dict(zip(("K1", "K2", "K3", "K4"),
                        (fn.launches for fn in counted)))
    iters = sum(r[3] for r in result.sweep_log)
    steps = len(result.sweep_log)
    check(model.estep_backend == "cuda" and launches["K3"] == iters + steps
          and launches["K4"] == iters and launches["K1"] == 0
          and launches["K2"] == 0,
          f"{precision} restart path: launches {launches} for {iters} "
          f"iterations and {steps} sweep steps")
    check(result.ideal_num_clusters == K_TARGET
          and np.isfinite(result.final_loglik), f"{precision} restart result")
    em_s = sum(r[4] for r in result.sweep_log)
    print(f"  restart path at '{precision}': {LANES} inits, winner init "
          f"{result.init_index}, fit {fit_s:.2f} s, EM {em_s:.2f} s = "
          f"{LANES * iters / em_s:.2f} lane-iterations/s; launches {launches}")
    return launches


def shard_cols(k: int, shards: int):
    ks = -(-k // shards)
    return [slice(i * ks, min(k, (i + 1) * ks)) for i in range(shards)]


def combine_lse(lse):
    """logZ from the shards' (m, s): torch max and sum standing in for the
    all_reduce calls of fused_stats_cuda_sharded."""
    import torch

    big_m = torch.stack([m for m, _ in lse]).max(dim=0).values
    return big_m + torch.log(sum(torch.exp(m - big_m) * s for m, s in lse))


def phase_k5_k6(x_np, shards, diag, label, k=K0, precision="highest"):
    """K5/K6 per shard of k clusters at ``precision`` against plain at that
    precision, and the shards combined against K1 at that precision and
    float64 (the float64 bar floored at the mode's unit roundoff); the last
    shard has every cluster inactive. At 'high'/'default' K5's max must
    also differ from the 'highest' launch's (the bf16 route ran)."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    floor = FP64_FLOOR[precision]
    pk = dict(diag=diag, precision=precision)
    cols = shard_cols(k, shards)
    state, _, _, args = stats_inputs(x_np, k, diag,
                                     tuple(range(cols[-1].start, k)))
    x, wt, A, h, g = args
    parts = [tuple(t[:, c].contiguous() for t in (A, h, g)) for c in cols]
    lse, lse_plain = [], []
    worst = {"m": 0.0, "s": 0.0}
    worst_abs = 0.0
    worst64 = {"m": (0.0, 0.0), "s": (0.0, 0.0)}
    for i, p in enumerate(parts):
        out = fs.local_lse(x, *p, **pk)
        again = fs.local_lse(x, *p, **pk)
        plain = fs.local_lse_plain(x, *p, **pk)
        ref64 = fs.local_lse_plain(x.double(), *(t.double() for t in p),
                                   diag=diag)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K5 {label} shard {i}: two launches differ")
        for name, a, b, c in zip(("m", "s"), out, plain, ref64):
            check(bool(torch.isfinite(a).all()),
                  f"K5 {label} shard {i}: non-finite {name}")
            e64, p64 = normwise(a, c), normwise(b, c)
            check(e64 <= 2.0 * max(p64, floor),
                  f"K5 {label} shard {i}: {name} float64 error {e64:.2e} > 2 "
                  f"x the plain version's {p64:.2e}")
            worst[name] = max(worst[name], normwise(a, b.double()))
            if name == "m":  # one of the logp values: the loglik class
                check(worst["m"] <= TOL["ll"][0],
                      f"K5 {label} shard {i}: m normwise {worst['m']:.2e} "
                      f"against its plain version")
            worst_abs = max(worst_abs, float((a - b).abs().max()))
            worst64[name] = tuple(map(max, worst64[name], (e64, p64)))
        if precision != "highest" and i == 0:
            check(not torch.equal(out[0], fs.local_lse(x, *p, diag=diag)[0]),
                  f"K5 {label}: the {precision} launch equals the 'highest' one")
        lse.append(out)
        lse_plain.append(plain)
        del ref64
    check(bool((lse[-1][0] == fs.NEG_LARGE).all())
          and bool((lse[-1][1] == cols[-1].stop - cols[-1].start).all()),
          f"K5 {label}: the all-masked shard's m/s are not NEG_LARGE/K_s")
    print(f"  K5 {label}: normwise vs plain m {worst['m']:.2e}, s "
          f"{worst['s']:.2e}; vs float64: m K5 {worst64['m'][0]:.2e}, plain "
          f"{worst64['m'][1]:.2e}; s K5 {worst64['s'][0]:.2e}, plain "
          f"{worst64['s'][1]:.2e}")
    logz, logz_plain = combine_lse(lse), combine_lse(lse_plain)
    outs, outs_plain, worst6 = [], [], 0.0
    skipped = set()
    for i, p in enumerate(parts):
        out = fs.stats_logz(x, wt, logz, *p, **pk)
        again = fs.stats_logz(x, wt, logz, *p, **pk)
        ref = fs.stats_logz_plain(x, wt, logz, *p, **pk)
        ref64 = (ref if precision == "highest" else fs.stats_logz_plain(
            x.double(), wt.double(), logz.double(), *(t.double() for t in p),
            diag=diag))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"K6 {label} shard {i}: two launches differ")
        for name, a, b, c in zip(("ll", "nk", "m1", "m2"), out, ref, ref64):
            if precision == "highest":  # the class against plain (phase 2's)
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                rtol, atol = TOL[name]
                check(bool(torch.isfinite(a).all())
                      and err <= atol + rtol * scale,
                      f"K6 {label} shard {i}: {name} max|err| {err:.3e} > "
                      f"{atol} + {rtol} x {scale:.3e}")
            elif not hold_stat(f"K6 {label} shard {i}", name, a, b, c,
                               precision):
                skipped.add(name)
            worst6 = max(worst6, float((a - b).abs().max()))
        del ref64
        outs.append(out)
        outs_plain.append(fs.stats_logz_plain(x, wt, logz_plain, *p, **pk))
    check(not outs[-1][1].any(), f"K6 {label}: the all-masked shard got weight")
    side = lambda o: (o[0][0], torch.cat([q[1] for q in o], dim=1),
                      torch.cat([q[2] for q in o]), torch.cat([q[3] for q in o]))
    k1 = fs.fused_stats(*args, **pk)
    ref64 = fs.fused_stats_plain(*(t.double() for t in args), diag=diag)
    for name, a, b, c, d in zip(("ll", "nk", "m1", "m2"), side(outs), k1,
                                ref64, side(outs_plain)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rtol, atol = TOL[name]
        p64 = normwise(d, c)
        met = err <= atol + rtol * scale
        check(met or (precision != "highest" and p64 > rtol),
              f"K5+K6 {label}: {name} against K1 max|err| {err:.3e} > "
              f"{atol} + {rtol} x {scale:.3e}")
        if not met:
            skipped.add(f"{name} vs K1")
        e64 = normwise(a, c)
        check(e64 <= 2.0 * max(p64, floor),
              f"K5+K6 {label}: {name} float64 error {e64:.2e} > 2 x the plain "
              f"combination's {p64:.2e}")
        print(f"  K5+K6 {label} {name}: max|shards - K1| {err:.3e} (normwise "
              f"{err / max(scale, 1e-30):.2e}); normwise vs float64: kernels "
              f"{e64:.2e}, plain {p64:.2e}")
    del ref64
    if skipped:
        print(f"  {label}: outside the class of the plain version (whose own "
              f"float64 error exceeds it), within the float64 bar: "
              f"{sorted(skipped)}")
    return {"k5_err": worst_abs, "k5_m_err": worst["m"],
            "k5_s_err": worst["s"], "k6_err": worst6,
            "k5_fp64_err": max(worst64["m"][0], worst64["s"][0]),
            "k5_plain_fp64_err": max(worst64["m"][1], worst64["s"][1])}


def time_k5_k6(x_np, diag, label, clocks, precision="highest"):
    """K5 and K6 times at one phase-9 rank's shape: RANK_EVENTS events (the
    first data shard of the chunk grid), the first RANK_CLUSTERS clusters,
    at ``precision``; beside them the plain versions, the torch-ops route of
    that shard at that precision and (with the ``clocks`` library) each
    kernel's phase shares."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.estep import log_densities
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats

    state, chunks, wts, args = stats_inputs(x_np, K0, diag)
    x, wt, A, h, g = args
    n, d, ks = RANK_EVENTS, x.shape[1], RANK_CLUSTERS
    x, wt = x[:n], wt[:n]
    p = tuple(t[:, :ks].contiguous() for t in (A, h, g))
    shard = state.take(torch.arange(ks, device=x.device))
    c_shard, w_shard = chunks[:n // chunks.shape[1]], wts[:n // chunks.shape[1]]
    pk = dict(diag=diag, precision=precision)
    m, s = fs.local_lse(x, *p, **pk)
    logz = m + torch.log(s)  # a single-shard logZ: K6's time does not depend on it

    def torch_ops_lse():
        for c in range(c_shard.shape[0]):
            lp = log_densities(shard, c_shard[c], diag_only=diag,
                               matmul_precision=precision)
            mx = lp.max(dim=1, keepdim=True).values
            torch.exp(lp - mx).sum(dim=1)

    f = p[0].shape[0]
    t = d if diag else d * (d + 1) // 2
    k5 = lambda: fs.local_lse(x, *p, **pk)
    k6 = lambda: fs.stats_logz(x, wt, logz, *p, **pk)
    rec5 = {"ms": time_ms(k5),
            "plain_ms": time_ms(lambda: fs.local_lse_plain(x, *p, **pk)),
            "torch_ops_ms": time_ms(torch_ops_lse)}
    rec5.update(route_bound(4 * (n * d + f * ks + d * ks + ks + 2 * n),
                            2.0 * n * ks * (t + d), precision=precision))
    rec6 = {"ms": time_ms(k6),
            "plain_ms": time_ms(
                lambda: fs.stats_logz_plain(x, wt, logz, *p, **pk)),
            "torch_ops_ms": time_ms(lambda: accumulate_stats(
                shard, c_shard, w_shard, diag_only=diag,
                matmul_precision=precision))}
    rec6.update(route_bound(
        4 * (n * d + 2 * n + f * ks + d * ks + ks + 1 + ks + ks * d + ks * f),
        2.0 * n * ks * (t + d), 2.0 * n * ks * (t + d + 1), precision))
    for name, r, stats, launch in (("K5", rec5, False, k5),
                                   ("K6", rec6, True, k6)):
        tile = fs.shard_tile(ks, d, diag, stats=stats, precision=precision)
        r.update(ctas_per_sm=tile.ctas_per_sm, grid=tile.grid, k_pad=tile.k_pad,
                 bt=tile.bt, phase_shares=(None if clocks is None else
                                           phase_shares(clocks, launch)))
        print(f"  {name} {label} at {n} events x {ks} clusters: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch-ops "
              f"route {r['torch_ops_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; fp32 non-tensor {r['fp32_bound_ms']:.4f} ms); "
              f"K_pad {tile.k_pad}, B_t {tile.bt}, grid {tile.grid}, "
              f"{tile.ctas_per_sm} CTAs per SM")
        if clocks is not None:
            print(f"  {name} {label} phases (thread-0 cycles of every CTA): "
                  + shares_line(r["phase_shares"]))
    return rec5, rec6


def _timed(fn, key: str, totals: dict):
    """``fn`` with the card synchronised before and after each call, its
    host-clock seconds added to ``totals[key]``."""
    import torch

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[key] += time.perf_counter() - t0
        return out

    return run


def _mesh_rank(rank, world, workdir):
    """One rank of phase 9: the diag fit on the mesh, then the breakdown.
    Writes rank<r>.json into ``workdir``."""
    import torch
    import torch.distributed as dist

    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.models.order_search import _prepare_fit
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, apply_mstep
    from cuda_gmm_mpi_tpu_torch.parallel import ShardedGMMModel, distributed

    workdir = Path(workdir)
    distributed.initialize("cuda", coordinator=f"file://{workdir}/store",
                           num_processes=world, process_id=rank,
                           timeout_s=MESH_TIMEOUT_S)
    try:
        data = np.load(workdir / "events.npy")
        config = GMMConfig(min_iters=DIAG_ITERS, max_iters=DIAG_ITERS,
                           diag_only=True, mesh_shape=MESH)
        model = ShardedGMMModel(config)
        group = model.mesh.cluster_group
        # The fit's own EM loop, timed at its three hooks: the statistics
        # (K5, the two cluster collectives, K6), the data-axis all_reduce
        # and the M-step (the torch-ops update that em_while_loop runs when
        # mstep_fn is None, here passed as the hook so that it is timed).
        in_fit = {k: 0.0 for k in ("stats", "data_reduce", "mstep")}
        model.stats_fn = _timed(model.stats_fn, "stats", in_fit)
        model._reduce = _timed(model._reduce, "data_reduce", in_fit)
        model.mstep_fn = _timed(functools.partial(
            apply_mstep, diag_only=True, cluster_group=group), "mstep", in_fit)
        counted = (fs.fused_stats, fs.mstep, fs.local_lse, fs.stats_logz)
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        result = fit_gmm(data, K0, DIAG_TARGET, config=config, model=model)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(zip(("K1", "K2", "K5", "K6"),
                            (fn.launches for fn in counted)))
        iters = sum(r[3] for r in result.sweep_log)
        em_s = sum(r[4] for r in result.sweep_log)
        # Per EM iteration, as the iteration time is (initial E-steps
        # included); "loop" is the rest of run_em: the host loop and its
        # one loglik read per iteration.
        fit_ms = {k: v * 1e3 / iters for k, v in in_fit.items()}
        fit_ms["loop"] = em_s * 1e3 / iters - sum(fit_ms.values())

        # Breakdown of the statistics piece at K0, outside the fit: each
        # piece synchronised, the ranks aligned by a barrier per repeat.
        state, chunks, wts, n_events, d, _ = _prepare_fit(data, K0, config,
                                                          model)
        n = model.local_events(n_events, chunks)
        x, wt = fs._prep_events(chunks, wts)
        x, wt = x[:n], wt[:n]
        parts = {k: 0.0 for k in ("K5", "collectives", "K6", "data_reduce",
                                  "mstep")}
        reps = 5
        for rep in range(reps + 1):  # the first is a warm-up
            torch.cuda.synchronize()
            dist.barrier()
            marks = [time.perf_counter()]
            A, h, g = fs._prep_params(state, d, True)
            m, s = fs.local_lse(x, A, h, g, diag=True)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            big_m = m.clone()
            dist.all_reduce(big_m, op=dist.ReduceOp.MAX, group=group)
            big_s = torch.exp(m - big_m) * s
            dist.all_reduce(big_s, op=dist.ReduceOp.SUM, group=group)
            logz = big_m + torch.log(big_s)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            ll, nk, m1, m2 = fs.stats_logz(x, wt, logz, A, h, g, diag=True)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            stats = model._reduce(SuffStats(ll[0, 0], nk[0], m1, m2))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            state = apply_mstep(state, stats, diag_only=True,
                                cluster_group=group)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if rep:
                for key, a, b in zip(parts, marks, marks[1:]):
                    parts[key] += (b - a) * 1e3 / reps
        report = dict(
            rank=rank, k=result.ideal_num_clusters,
            merges=[list(m[1]) for m in result.merges],
            final_loglik=result.final_loglik, launches=launches,
            iters=iters, steps=len(result.sweep_log), fit_s=fit_s,
            em_s=em_s, backend=model.estep_backend,
            collective=model.collective_backend, fit_breakdown_ms=fit_ms,
            breakdown_ms=parts, local_events=n, bf16={})
        # The bf16 fits: K5/K6's 'high'/'default' instances, counted from 0.
        for family, prec in BF16_MESH_FITS:
            cfg = GMMConfig(min_iters=DIAG_ITERS, max_iters=DIAG_ITERS,
                            covariance_type=family, matmul_precision=prec,
                            mesh_shape=MESH)
            for fn in counted:
                fn.launches = 0
            fs.local_lse.precision_launches.clear()
            fs.stats_logz.precision_launches.clear()
            t0 = time.perf_counter()
            res = fit_gmm(data, K0, BF16_MESH_TARGET, config=cfg,
                          model=ShardedGMMModel(cfg))
            torch.cuda.synchronize()
            report["bf16"][prec] = dict(
                family=family, k=res.ideal_num_clusters,
                merges=[list(m[1]) for m in res.merges],
                sweep=[list(row[:2]) for row in res.sweep_log],
                final_loglik=res.final_loglik,
                iters=sum(r[3] for r in res.sweep_log),
                em_s=sum(r[4] for r in res.sweep_log),
                fit_s=time.perf_counter() - t0,
                launches=dict(zip(("K1", "K2", "K5", "K6"),
                                  (fn.launches for fn in counted))),
                precision_launches={
                    "K5": dict(fs.local_lse.precision_launches),
                    "K6": dict(fs.stats_logz.precision_launches)})
        (workdir / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        distributed.shutdown()


def stop_resource_tracker() -> None:
    """Stops the multiprocessing resource tracker that starting the ranks
    with ``spawn`` left running, and reaps it: it would otherwise outlive
    the ranks until this process exits."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _descendants(pid: int) -> list:
    """The pids of the processes below ``pid``, parents before children."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:
            continue
        ppid = int(stat.rsplit(")", 1)[1].split()[1])
        children.setdefault(ppid, []).append(int(entry))
    found, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        found += kids
        todo += kids
    return found


def stop_children(grace_s: float = 10.0) -> list:
    """Stops every process below this one that still runs (SIGTERM, then
    SIGKILL after ``grace_s``) and reaps this one's own children. Returns
    their command lines."""
    pids = _descendants(os.getpid())
    names = []
    for pid in pids:
        try:
            names.append(Path(f"/proc/{pid}/cmdline").read_bytes()
                         .replace(b"\0", b" ").decode(errors="replace").strip())
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    while pids and time.monotonic() < deadline:
        _reap(pids)
        pids = [pid for pid in pids if _alive(pid)]
        time.sleep(0.05)
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    _reap(pids, 0)
    return names


def _reap(pids, flags: int = os.WNOHANG) -> None:
    """Collects the exit status of those of ``pids`` that are this
    process's children (with ``flags`` 0, waiting for each to end)."""
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, flags)


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, ended but not reaped, does not)."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def phase_mesh(data, diag_ref, workdir: Path):
    """Phase 9: the (2, 2) mesh fit on the one card, 4 ranks; then the bf16
    fits on the same ranks (BF16_MESH_FITS), the 'high' one held to a
    single-device fit of the same family and precision through K1."""
    import torch.multiprocessing as mp

    ref, ref_k1 = diag_ref
    family, prec = BF16_MESH_FITS[0]
    high_ref, high_model, _, _ = fit(data, K0, BF16_MESH_TARGET, DIAG_ITERS,
                                     covariance_type=family,
                                     matmul_precision=prec)
    check(high_model.estep_backend == "cuda", "single-device bf16 fit backend")
    world = MESH[0] * MESH[1]
    np.save(workdir / "events.npy", data)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_mesh_rank, args=(world, str(workdir)),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                raise PhaseError(f"mesh ranks still running after "
                                 f"{MESH_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise PhaseError(f"a mesh rank failed: {e}") from None
    except mp.ProcessExitedException as e:
        raise PhaseError(f"a mesh rank died: {e}") from None
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        stop_resource_tracker()
    wall = time.perf_counter() - t0
    reports = []
    for r in range(world):
        path = workdir / f"rank{r}.json"
        check(path.exists(), f"mesh rank {r} did not report")
        reports.append(json.loads(path.read_text()))
    ref_pairs = [list(m[1]) for m in ref.merges]
    for rep in reports:
        r, lc = rep["rank"], rep["launches"]
        check(rep["backend"] == "cuda" and rep["collective"] == "gloo",
              f"rank {r}: backend {rep['backend']}, collectives "
              f"{rep['collective']}")
        check(lc["K5"] == ref_k1 and lc["K6"] == ref_k1,
              f"rank {r}: K5 {lc['K5']}, K6 {lc['K6']} launches against the "
              f"single-device diag fit's {ref_k1} K1 launches")
        check(lc["K1"] == 0 and lc["K2"] == 0,
              f"rank {r}: K1/K2 launched on the mesh path: {lc}")
        check(rep["k"] == ref.ideal_num_clusters,
              f"rank {r}: K {rep['k']} against {ref.ideal_num_clusters}")
        check(rep["merges"] == ref_pairs,
              f"rank {r}: merge pairs {rep['merges']} against {ref_pairs}")
        rel = abs(rep["final_loglik"] - ref.final_loglik) / abs(ref.final_loglik)
        check(rel <= 1e-4, f"rank {r}: final loglik rtol {rel:.2e} > 1e-4")
    high_pairs = [list(m[1]) for m in high_ref.merges]
    for rep in reports:
        r = rep["rank"]
        for p, b in rep["bf16"].items():
            lc, pl = b["launches"], b["precision_launches"]
            check(pl["K5"].get(p, 0) > 0 and pl["K6"].get(p, 0) > 0
                  and pl["K5"].get(p) == lc["K5"] and pl["K6"].get(p) == lc["K6"]
                  and lc["K1"] == 0 and lc["K2"] == 0,
                  f"rank {r} {b['family']} {p}: launches {lc}, by precision "
                  f"{pl}")
            ks = [row[0] for row in b["sweep"]]
            check(b["k"] in ks and min(ks) <= BF16_MESH_TARGET
                  and np.isfinite(b["final_loglik"]),
                  f"rank {r} {b['family']} {p}: K {b['k']}, loglik "
                  f"{b['final_loglik']}, sweep (K, loglik) {b['sweep']}")
        h = rep["bf16"][prec]
        check(h["k"] == high_ref.ideal_num_clusters and h["merges"] == high_pairs,
              f"rank {r} {family} {prec}: K {h['k']}, merge pairs "
              f"{h['merges']} against the single-device fit's "
              f"{high_ref.ideal_num_clusters}, {high_pairs}")
        rel = abs(h["final_loglik"] - high_ref.final_loglik) / abs(
            high_ref.final_loglik)
        check(rel <= 1e-4, f"rank {r} {family} {prec}: final loglik rtol "
              f"{rel:.2e} > 1e-4")
    r0 = reports[0]
    for p, b in r0["bf16"].items():
        rel = abs(b["final_loglik"] - high_ref.final_loglik) / abs(
            high_ref.final_loglik) if p == prec else None
        print(f"  mesh {MESH} {b['family']} at '{p}': K {K0} -> {b['k']}, "
              f"{b['iters']} EM iterations, {b['em_s'] / b['iters'] * 1e3:.1f} "
              f"ms per iteration; launches per rank {b['launches']}"
              + ("" if rel is None else
                 f"; the single-device fit's K and merge pairs, final loglik "
                 f"rtol {rel:.2e}"))
    em_single = sum(row[4] for row in ref.sweep_log)
    print(f"  mesh {MESH} on one card, {world} ranks (gloo): K {K0} -> "
          f"{r0['k']}, {r0['iters']} EM iterations, launches per rank "
          f"{r0['launches']}, same K and merge pairs as the single-device diag "
          f"fit; final loglik rtol "
          f"{abs(r0['final_loglik'] - ref.final_loglik) / abs(ref.final_loglik):.2e}")
    print(f"  rank 0: fit {r0['fit_s']:.2f} s, EM {r0['em_s']:.2f} s = "
          f"{r0['em_s'] / r0['iters'] * 1e3:.1f} ms per iteration (single "
          f"device through K1/K2: {em_single / r0['iters'] * 1e3:.1f} ms); "
          f"world wall {wall:.1f} s")
    for rep in reports:
        f, b = rep["fit_breakdown_ms"], rep["breakdown_ms"]
        print(f"  rank {rep['rank']} ({rep['local_events']} events) in the fit, "
              f"per iteration (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in f.items())
              + f"; sum {sum(f.values()):.3f} = "
              f"{rep['em_s'] / rep['iters'] * 1e3:.3f} per iteration")
        print(f"  rank {rep['rank']} outside the fit, one iteration at K {K0} "
              f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in b.items())
              + f"; sum {sum(b.values()):.3f}")
    return r0


FAMILIES = ("full", "diag", "spherical", "tied")
CLI_EVENTS = 65_536  # phase 11's CLI slice (formatting 1M rows takes ~18 s)


def _gm_fit(data, family, sample_weight=None, **cfg):
    """``GaussianMixture(K0, K_TARGET)`` fit of ``family`` (ITERS per K),
    its K1/K2 launches counted from 0, and its host-clock wall."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GaussianMixture
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    gm = GaussianMixture(K0, K_TARGET, covariance_type=family,
                         min_iters=ITERS, max_iters=ITERS, **cfg)
    fs.fused_stats.launches = fs.mstep.launches = 0
    t0 = time.perf_counter()
    gm.fit(data, sample_weight=sample_weight)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return gm, {"K1": fs.fused_stats.launches, "K2": fs.mstep.launches}, wall


def _same_fit(gm, ref, label, rtol=1e-4, pairs=True) -> float:
    """``gm`` selected ``ref``'s K (and with ``pairs`` its merge pairs),
    final loglik within ``rtol``; returns the loglik's relative
    difference. A step may pick another pair only where both runs' smallest
    merge distances are the same float32 value: a tie among pairs whose
    distances differ below float32's resolution, which the scan breaks by
    index order (tied covariance: the merge cost of a near-empty cluster
    rounds to 0.0 for several pairs at once). Such steps are printed."""
    check(gm.n_components_ == ref.n_components_,
          f"{label}: K {gm.n_components_} against {ref.n_components_}")
    mine, theirs = gm.result_.merges, ref.result_.merges
    check(not pairs or len(mine) == len(theirs),
          f"{label}: {len(mine)} merges against {len(theirs)}")
    for a, b in zip(mine if pairs else (), theirs):
        if a[1] == b[1]:
            continue
        check(a[0] == b[0] and a[2] == b[2],
              f"{label}: merge pairs {[m[1] for m in mine]} against "
              f"{[m[1] for m in theirs]} (at K {a[0]}: distance {a[2]} "
              f"against {b[2]})")
        print(f"  {label}: at K {a[0]} a tie broken apart: pair {a[1]} against "
              f"{b[1]}, both at the float32 distance {a[2]}")
    rel = abs(gm.loglik_ - ref.loglik_) / abs(ref.loglik_)
    check(rel <= rtol, f"{label}: final loglik rtol {rel:.2e} > {rtol}")
    return rel


def _mstep_ms(gm, family, data) -> float:
    """One M-step of the fitted model as its EM loop runs it: K2's hook for
    full/diag, the torch-ops ``apply_mstep`` for spherical/tied; on the
    fitted state and its statistics (through K1) on ``data``."""
    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.ops.mstep import apply_mstep

    model, cfg = gm._model, gm.config
    chunks, wts = chunk_events(data - gm.result_.data_shift[None, :].astype(
        np.float32), cfg.chunk_size)
    chunks, wts = model.place(chunks), model.place(wts)
    state = gm.result_.state.to(model.device)
    stats = model.stats_fn(state, chunks, wts, n_events=len(data))
    hook = model.mstep_fn or functools.partial(
        apply_mstep, diag_only=cfg.diag_only, covariance_type=family)
    return time_ms(lambda: hook(state, stats))


def phase_estimator(data, workdir: Path, seed: int) -> dict:
    """Phase 11: ``GaussianMixture`` at the north-star shape (phase 4's
    1M x 24 events, K 100 -> 96, ITERS iterations per K), every family on
    the kernel path against the same fit on torch ops; a BIC search; integer
    sample weights against replicated rows; inference, the summary round
    trip and the CLI's --init-from / --predict-from on a CLI_EVENTS slice."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GaussianMixture
    from cuda_gmm_mpi_tpu_torch.cli import main as cli_main
    from cuda_gmm_mpi_tpu_torch.io import stream_results, write_bin, write_summary
    from cuda_gmm_mpi_tpu_torch.models import iter_memberships
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    out = {"families": {}}
    fits = {}
    for family in FAMILIES:
        gm, lc, wall = _gm_fit(data, family)
        check(gm._model.estep_backend == "cuda",
              f"{family}: backend {gm._model.estep_backend}")
        iters = sum(r[3] for r in gm.result_.sweep_log)
        em_s = sum(r[4] for r in gm.result_.sweep_log)
        n_k = len(gm.result_.sweep_log)
        check(lc["K1"] == iters + n_k,
              f"{family}: K1 launched {lc['K1']} times for {iters} iterations "
              f"+ {n_k} initial E-steps")
        want_k2 = iters if family in ("full", "diag") else 0
        check(lc["K2"] == want_k2, f"{family}: K2 launched {lc['K2']} times, "
              f"not {want_k2}")
        ref, _, ref_wall = _gm_fit(data, family, estep_backend="torch")
        rel = _same_fit(gm, ref, f"{family} kernels vs torch ops")
        mstep = _mstep_ms(gm, family, data)
        rec = dict(launches=lc, iters=iters, em_iters_per_s=iters / em_s,
                   fit_s=wall, torch_ops_fit_s=ref_wall,
                   torch_ops_em_iters_per_s=iters / sum(
                       r[4] for r in ref.result_.sweep_log),
                   loglik_rtol=rel, mstep_ms=mstep,
                   mstep_share=mstep / (em_s * 1e3 / iters))
        out["families"][family] = rec
        fits[family] = gm
        print(f"  {family}: K {K0} -> {gm.n_components_}, {iters} EM "
              f"iterations, {rec['em_iters_per_s']:.2f} EM iters/s (torch ops "
              f"{rec['torch_ops_em_iters_per_s']:.2f}), fit {wall:.2f} s "
              f"(torch ops {ref_wall:.2f} s); launches {lc}; the torch-ops "
              f"fit's K and merge pairs, loglik rtol {rel:.2e}; M-step "
              f"({'K2' if lc['K2'] else 'torch ops'}) {mstep:.3f} ms = "
              f"{100 * rec['mstep_share']:.1f}% of an iteration")

    # --- the criterion: a BIC search down to K = 1 on 8 seeded blobs
    small = make_blobs(seed + 2, 200_000, DIMS, 8)
    picks = []
    for backend in ("auto", "torch"):
        gm = GaussianMixture(16, criterion="bic", min_iters=10, max_iters=10,
                             estep_backend=backend).fit(small)
        picks.append(gm)
    _same_fit(picks[0], picks[1], "bic search kernels vs torch ops",
              pairs=False)
    out["bic_k"] = picks[0].n_components_
    print(f"  criterion bic, K 16 -> 1 on 200,000 events of 8 blobs: K "
          f"{picks[0].n_components_} on the kernels and on torch ops")
    del small, picks

    # --- sample weights: integers in {1, 2} against replicated rows
    w = np.random.default_rng(seed + 3).integers(1, 3, size=len(data))
    from cuda_gmm_mpi_tpu_torch.ops.seeding import seed_means_indices

    init = data[seed_means_indices(len(data), K0)]
    exact = dict(means_init=init, covariance_dynamic_range=1e30)
    gw, _, w_wall = _gm_fit(data, "full", sample_weight=w.astype(np.float32),
                            **exact)
    rows = np.repeat(data, w, axis=0)
    gr, _, r_wall = _gm_fit(rows, "full", **exact)
    rel = _same_fit(gw, gr, "weighted fit vs replicated rows")
    out["sample_weight"] = dict(rows=len(rows), loglik_rtol=rel,
                                fit_s=w_wall, replicated_fit_s=r_wall)
    print(f"  sample weights in {{1, 2}}: the fit of the {len(rows)} "
          f"replicated rows' K and merge pairs, loglik rtol {rel:.2e} (fit "
          f"{w_wall:.2f} s against {r_wall:.2f} s)")
    del rows, gw, gr

    # --- inference on the 1M events, through the full fit
    gm = fits["full"]
    t0 = time.perf_counter()
    proba = gm.predict_proba(data)
    proba_s = time.perf_counter() - t0
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    check(proba.shape == (len(data), K_TARGET) and row_err <= 1e-5,
          f"predict_proba rows sum to 1 within {row_err:.2e}")
    labels = proba.argmax(axis=1)
    del proba
    total = float(np.sum(gm.score_samples(data), dtype=np.float64))
    rel = abs(total - gm.loglik_) / abs(gm.loglik_)
    check(rel <= 1e-4, f"sum of score_samples rtol {rel:.2e} > 1e-4")
    out["inference"] = dict(predict_proba_s=proba_s, row_sum_err=row_err,
                            score_samples_rtol=rel)
    print(f"  inference: predict_proba on {len(data)} events {proba_s:.2f} s, "
          f"rows sum to 1 within {row_err:.1e}; sum of score_samples against "
          f"loglik_ rtol {rel:.2e}")

    # --- the summary round trip
    model_path = workdir / "model.summary"
    write_summary(str(model_path), gm.result_)
    back = GaussianMixture.from_summary(str(model_path))
    mean_err = float(np.abs(back.means_ - gm.means_).max())
    pi_err = float(np.abs(back.weights_ - gm.weights_).max())
    same = float(np.mean(back.predict(data[:CLI_EVENTS]) == labels[:CLI_EVENTS]))
    check(back.n_components_ == gm.n_components_ and mean_err <= 5e-4
          and pi_err <= 1e-5 and same >= 0.999,
          f"from_summary: K {back.n_components_}, means {mean_err:.1e}, "
          f"weights {pi_err:.1e}, labels agree on {same:.5f}")
    print(f"  from_summary: K {back.n_components_}, means within "
          f"{mean_err:.1e}, weights within {pi_err:.1e}, hard labels agree on "
          f"{100 * same:.3f}% of {CLI_EVENTS} events")

    # --- the CLI on a slice: --init-from, then --predict-from
    slice_bin = workdir / "slice.bin"
    write_bin(str(slice_bin), data[:CLI_EVENTS])
    t0 = time.perf_counter()
    rc = cli_main([str(K_TARGET), str(slice_bin), str(workdir / "init"),
                   str(K_TARGET), f"--init-from={model_path}",
                   "--min-iters=5", "--max-iters=5"])
    init_s = time.perf_counter() - t0
    check(rc == 0, f"--init-from exited {rc}")
    t0 = time.perf_counter()
    rc = cli_main(["1", str(slice_bin), str(workdir / "pred"),
                   f"--predict-from={model_path}"])
    pred_s = time.perf_counter() - t0
    check(rc == 0, f"--predict-from exited {rc}")
    stream_results(str(workdir / "ref.results"), iter_memberships(
        back.result_, data[:CLI_EVENTS], back.config, back._model))
    differ = _results_tie_rule(workdir / "pred.results", workdir / "ref.results")
    out["cli"] = dict(events=CLI_EVENTS, init_from_s=init_s,
                      predict_from_s=pred_s, lines_differing_on_ties=differ)
    print(f"  CLI on {CLI_EVENTS} events: --init-from {init_s:.2f} s, "
          f"--predict-from {pred_s:.2f} s; its memberships against "
          f"from_summary's: {differ} lines differ, on ties only")
    return out


def mstep_record(full: dict, diag: dict) -> dict:
    """K2's or K4's line: the full-covariance record, and the diag one's
    times, bound and errors under ``diag_`` keys."""
    return dict(full, **{"diag_" + k: v for k, v in diag.items()
                         if k not in ("cond", "bound_by")})


def shard_record(diag, full, instances, mode: str) -> dict:
    """The K5 or K6 entries of the kernels line beyond the common keys:
    tile, phase shares and the shard kernel's build."""
    keys = ("ctas_per_sm", "grid", "k_pad", "bt", "phase_shares")
    rec = {k: diag[k] for k in keys}
    rec.update({f"full_{k}": full[k] for k in keys})
    rec["build"] = [r for r in instances
                    if r["instance"].startswith(mode) and "shard" in r["instance"]]
    return rec


def shard_precision_records(prec, pallas, mesh_fit, checks, times) -> list:
    """The kernels-line entries of K5 and K6 at ``prec``: launches from
    phase 9's fit at that precision (rank 0), errors from phase 8's checks
    at K_s = 50 and 130, times at one rank's shape (diag; full under
    ``full_`` keys)."""
    out = []
    for name, key, pallas_line, i in (("K5 local_lse", "K5", "218", 0),
                                      ("K6 stats_logz", "K6", "235", 1)):
        errs = [v for (p, _, _), v in checks.items() if p == prec]
        diag, full = times[prec, True][i], times[prec, False][i]
        rec = dict(
            name=f"{name} {prec}", route="cuda",
            source="cuda_gmm_mpi_tpu_torch/csrc/fused_stats.cu",
            replaces=pallas + pallas_line,
            launches=mesh_fit["precision_launches"][key].get(prec, 0),
            max_abs_err=max(v["k5_err" if i == 0 else "k6_err"] for v in errs),
            ms=diag["ms"], plain_ms=diag["plain_ms"],
            bound_ms=diag["bound_ms"], bound_by=diag["bound_by"],
            fp32_bound_ms=diag["fp32_bound_ms"], library_ms=None,
            torch_ops_ms=diag["torch_ops_ms"], full_ms=full["ms"],
            full_plain_ms=full["plain_ms"], full_bound_ms=full["bound_ms"],
            full_torch_ops_ms=full["torch_ops_ms"], k_pad=diag["k_pad"],
            bt=diag["bt"], grid=diag["grid"],
            mesh_fit=dict(family=mesh_fit["family"], k=mesh_fit["k"],
                          iters=mesh_fit["iters"], em_s=mesh_fit["em_s"]))
        if i == 0:
            rec.update(fp64_err=max(v["k5_fp64_err"] for v in errs),
                       plain_fp64_err=max(v["k5_plain_fp64_err"]
                                          for v in errs))
        out.append(rec)
    return out


def precision_record(name, replaces, launches, full, diag, **extra) -> dict:
    """A 'high' or 'default' entry of the kernels line: K1's or K3's full
    record at that precision, the diag one's under ``diag_`` keys."""
    rec = dict(name=name, route="cuda",
               source="cuda_gmm_mpi_tpu_torch/csrc/fused_stats.cu",
               replaces=replaces, launches=launches)
    rec.update(full)
    rec.update({"diag_" + k: v for k, v in diag.items() if k != "bound_by"})
    rec.update(extra)
    return rec


# ------------------------------------------------- phase 12: containment

def main_path_rate(data, **cfg):
    """(EM iterations/s, result, model) of the main path (K0 -> K_TARGET,
    ITERS per K): the sweep log's iterations over its EM seconds."""
    result, model, _, _ = fit(data, K0, K_TARGET, ITERS, **cfg)
    iters = sum(r[3] for r in result.sweep_log)
    return iters / sum(r[4] for r in result.sweep_log), result, model


@contextlib.contextmanager
def timed_checkpoints():
    """Times every ``SweepCheckpointer`` save, sub-step save and restore
    made inside the block: {"save": [s, ...], "save_substep": [...], ...}."""
    from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

    times = {"save": [], "save_substep": [], "save_local": [], "restore": [],
             "restore_substep": []}
    originals = {name: getattr(SweepCheckpointer, name) for name in times}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                times[name].append(time.perf_counter() - t0)
        return timed

    for name, fn in originals.items():
        setattr(SweepCheckpointer, name, wrap(name, fn))
    try:
        yield times
    finally:
        for name, fn in originals.items():
            setattr(SweepCheckpointer, name, fn)


def rate_of(root: str, seed: int) -> dict:
    """``--rate-of ROOT``: the main path's EM iterations/s of the package
    under ROOT (its kernels built from ROOT's sources), after a warm-up
    fit; and, where that package has the telemetry and checkpoint fields,
    the instrumented rate too. Run in a subprocess, one per commit."""
    import torch

    sys.path.insert(0, root)
    import cuda_gmm_mpi_tpu_torch as pkg
    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build

    check(Path(pkg.__file__).resolve().is_relative_to(Path(root).resolve()),
          f"--rate-of imported {pkg.__file__}, not the package under {root}")
    _build.build_all()
    data = make_blobs(seed, N_EVENTS, DIMS, K_TARGET)
    fit(data, K0, K0 - 1, 2)  # warm-up: kernels loaded, allocator primed
    out = {"root": root, "bare": main_path_rate(data)[0]}
    fields = {f.name for f in dataclasses.fields(pkg.GMMConfig)}
    if {"metrics_file", "checkpoint_dir"} <= fields:
        from cuda_gmm_mpi_tpu_torch import supervisor

        with tempfile.TemporaryDirectory() as tmp, supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            out["instrumented"] = main_path_rate(
                data, metrics_file=os.path.join(tmp, "m.jsonl"),
                checkpoint_dir=os.path.join(tmp, "ck"))[0]
    torch.cuda.synchronize()
    return out


def _rate_subprocess(root: str, seed: int) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--rate-of", root,
         "--seed", str(seed)], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0,
          f"--rate-of {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_containment(data, main_result, main_rate, workdir: Path,
                      parent, seed: int) -> dict:
    """Phase 12 (see the module docstring)."""
    import torch

    from cuda_gmm_mpi_tpu_torch import health, supervisor
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats
    from cuda_gmm_mpi_tpu_torch.state import stack_states
    from cuda_gmm_mpi_tpu_torch.telemetry import read_stream, validate_stream
    from cuda_gmm_mpi_tpu_torch.testing import faults

    rec = {}
    # --- (a) the instrumented main path against the bare one (and parent)
    metrics = workdir / "a.jsonl"
    rates = {"bare": [], "instrumented": []}
    with timed_checkpoints() as ck_times:
        for turn in ("bare", "instrumented", "instrumented", "bare"):
            cfg = {} if turn == "bare" else dict(
                metrics_file=str(metrics),
                checkpoint_dir=str(workdir / f"ck{len(rates[turn])}"))
            with contextlib.ExitStack() as stack:
                if turn != "bare":  # supervised, as the CLI runs it
                    stack.enter_context(supervisor.use(
                        supervisor.RunSupervisor(install_signals=False)))
                rate, res, model = main_path_rate(data, **cfg)
            check(model.estep_backend == "cuda", f"(a) {turn} route")
            check(res.final_loglik == main_result.final_loglik
                  and [m[1] for m in res.merges]
                  == [m[1] for m in main_result.merges],
                  f"(a) the {turn} fit differs from phase 4's")
            rates[turn].append(rate)
    ck_files = sorted((workdir / "ck0" / "sweep").glob("*.npz"))
    ck_bytes = ck_files[-1].stat().st_size if ck_files else 0
    bare, inst = (float(np.mean(rates[k])) for k in ("bare", "instrumented"))
    rec["a"] = {"bare_em_iters_per_s": rates["bare"],
                "instrumented_em_iters_per_s": rates["instrumented"],
                "instrumented_cost": 1.0 - inst / bare,
                "checkpoint_save_ms": [1e3 * t for t in ck_times["save"]],
                "checkpoint_bytes": ck_bytes}
    print(f"  (a) main path EM iters/s: bare {rates['bare']}, with "
          f"metrics_file + checkpoint_dir {rates['instrumented']} "
          f"({100 * (1 - inst / bare):+.2f}% cost); checkpoint write per K "
          f"{1e3 * np.mean(ck_times['save']):.2f} ms "
          f"({len(ck_times['save'])} writes of {ck_bytes} bytes); "
          f"phase 4's rate {main_rate:.2f}")
    if parent:
        turns = [("parent", parent), ("this", str(Path(__file__).parent)),
                 ("this", str(Path(__file__).parent)), ("parent", parent)]
        runs = [(who, _rate_subprocess(root, seed)) for who, root in turns]
        par = [r["bare"] for who, r in runs if who == "parent"]
        this = [r["bare"] for who, r in runs if who == "this"]
        this_inst = [r["instrumented"] for who, r in runs if who == "this"]
        rec["a"]["parent"] = {"parent_em_iters_per_s": par,
                              "this_em_iters_per_s": this,
                              "this_instrumented_em_iters_per_s": this_inst,
                              "cost_vs_parent": 1 - np.mean(this)
                              / np.mean(par),
                              "instrumented_cost_vs_parent":
                              1 - np.mean(this_inst) / np.mean(par)}
        print(f"  (a) against {parent} in subprocesses (parent, this, this, "
              f"parent): parent {par}, this {this}, this instrumented "
              f"{this_inst}: health counts "
              f"{100 * rec['a']['parent']['cost_vs_parent']:+.2f}%, with "
              f"the recorder and checkpoints "
              f"{100 * rec['a']['parent']['instrumented_cost_vs_parent']:+.2f}%")

    # --- (f) the stream of (a) under the port's schema
    stream = read_stream(str(metrics))
    errors = validate_stream(stream)
    check(not errors, f"(f) stream errors: {errors[:5]}")
    counts = {}
    for r in stream:
        counts[r["event"]] = counts.get(r["event"], 0) + 1
    check(stream[0]["event"] == "run_start"
          and stream[0]["platform"] == "gpu"
          and stream[-1]["event"] == "run_summary",
          "(f) stream head and tail")
    rec["f"] = counts
    print(f"  (f) stream of (a): {len(stream)} records valid; {counts}")

    # --- (b) nan_loglik at iteration 3 of K = 100, armed twice
    spec = {"nan_loglik": {"iter": 3, "times": 2}}
    out = {}
    for backend in ("auto", "torch"):
        path = workdir / f"b_{backend}.jsonl"
        with faults.use(spec):
            res, model, _, secs = fit(data, K0, K_TARGET, ITERS,
                                      estep_backend=backend,
                                      metrics_file=str(path))
        out[backend] = (res, model, read_stream(str(path)), secs)
    res, primary, stream, secs = out["auto"]
    ref = out["torch"][0]
    rungs = [r for r in stream if r["event"] == "recovery"]
    routes = {"regularize": (primary.estep_backend,
                             primary.estep_backend_reason),
              "centered": (res.model.estep_backend,
                           res.model.estep_backend_reason)}
    for r in rungs:
        backend, why = routes[r["action"]]
        print(f"  (b) K={r['k']} rung {r['attempt']} ({r['action']}): "
              f"{r['outcome']}; route {backend} ({why})")
    check([(r["action"], r["outcome"]) for r in rungs]
          == [("regularize", "fatal"), ("centered", "recovered")],
          f"(b) rungs {[(r['action'], r['outcome']) for r in rungs]}")
    check(primary.estep_backend == "cuda" and res.model.estep_backend == "torch",
          "(b) routes: rung 1 on K1/K2, 'centered' on torch ops")
    pairs, ref_pairs = ([m[1] for m in r.merges] for r in (res, ref))
    rel = abs(res.final_loglik - ref.final_loglik) / abs(ref.final_loglik)
    check(res.ideal_num_clusters == ref.ideal_num_clusters
          and pairs == ref_pairs and rel <= 1e-4,
          f"(b) K {res.ideal_num_clusters}/{ref.ideal_num_clusters}, pairs "
          f"{pairs}/{ref_pairs}, loglik rtol {rel:.2e}")
    after = res.sweep_log[1:]  # the Ks after the escalation, all 'centered'
    centered_rate = sum(r[3] for r in after) / sum(r[4] for r in after)
    rec["b"] = {"rungs": [(r["action"], r["outcome"]) for r in rungs],
                "centered_em_iters_per_s": centered_rate,
                "k1_em_iters_per_s": main_rate, "loglik_rtol": rel,
                "first_k_s": res.sweep_log[0][4]}
    print(f"  (b) same K ({res.ideal_num_clusters}) and merge pairs {pairs} "
          f"as torch ops under the injection, loglik rtol {rel:.2e}; the "
          f"sticky 'centered' rung runs {centered_rate:.2f} EM iters/s on "
          f"torch ops against K1/K2's {main_rate:.2f} (phase 4); K = {K0} "
          f"with its two rungs {res.sweep_log[0][4]:.2f} s")

    # --- (c) a NaN mean through K1 and K3
    rec["c"] = {}
    for diag in (False, True):
        state, chunks, wts, _ = stats_inputs(data, K0, diag)
        means = state.means.clone()
        means[5] = float("nan")
        bad = state.replace(means=means)
        k1 = fs.fused_stats_cuda(bad, chunks, wts, diag_only=diag,
                                 n_events=len(data))
        plain = accumulate_stats(bad, chunks, wts, diag_only=diag)
        lanes = {}
        for name, st in (("K1", k1), ("plain", plain)):
            c = health.iteration_counts(bad, st, st.loglik).cpu().numpy()
            lanes[name] = (float(st.loglik), int(c[health.NONFINITE_LOGLIK]))
            check(not np.isfinite(lanes[name][0])
                  and lanes[name][1] == 1,
                  f"(c) {name} diag={diag}: loglik {lanes[name][0]}, "
                  f"nonfinite_loglik {lanes[name][1]}")
        k3 = fs.fused_stats_cuda_batched(
            stack_states([state, state, bad, state]), chunks, wts,
            diag_only=diag, n_events=len(data))
        ll3 = k3.loglik.cpu().numpy()
        check(not np.isfinite(ll3[2]) and np.isfinite(ll3[[0, 1, 3]]).all(),
              f"(c) K3 diag={diag}: lane logliks {ll3}")
        rec["c"]["diag" if diag else "full"] = {
            "k1_loglik": lanes["K1"][0], "plain_loglik": lanes["plain"][0],
            "k3_lane_logliks": ll3.tolist()}
        print(f"  (c) {'diag' if diag else 'full'}: a NaN in cluster 5's "
              f"mean gives K1 loglik {lanes['K1'][0]}, the plain version "
              f"{lanes['plain'][0]}, K3 lanes {ll3.tolist()}; "
              f"nonfinite_loglik set on both")
        del state, chunks, wts, bad, k1, plain, k3

    # --- (d) preempt in the sweep's second K, then resume
    ckdir = workdir / "d_ck"
    with timed_checkpoints() as ck_times:
        stops = []
        for _ in range(2):  # K = 100 at iteration 10, then K = 99 at 10
            with faults.use({"preempt": {"iter": 10}}), supervisor.use(
                    supervisor.RunSupervisor(install_signals=False)):
                try:
                    fit(data, K0, K_TARGET, ITERS, checkpoint_dir=str(ckdir))
                    check(False, "(d) the injected preempt did not stop")
                except supervisor.PreemptedError as e:
                    stops.append((e.step, e.em_iter, e.checkpointed))
        check(stops == [(0, 10, True), (1, 10, True)], f"(d) stops {stops}")
        with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
            res, _, _, secs = fit(data, K0, K_TARGET, ITERS,
                                  checkpoint_dir=str(ckdir))
    check(res.final_loglik == main_result.final_loglik
          and res.ideal_num_clusters == main_result.ideal_num_clusters
          and [r[:4] for r in res.sweep_log]
          == [r[:4] for r in main_result.sweep_log]
          and [m[1] for m in res.merges]
          == [m[1] for m in main_result.merges[1:]],
          "(d) the resumed fit differs from phase 4's uninterrupted one")
    rec["d"] = {"stops": stops, "resumed_fit_s": secs,
                "emergency_save_ms": [1e3 * t for t in
                                      ck_times["save_substep"]],
                "save_ms": [1e3 * t for t in ck_times["save"]],
                "restore_substep_ms": [1e3 * t for t in
                                       ck_times["restore_substep"]]}
    print(f"  (d) stopped at (step, iteration) {[s[:2] for s in stops]}, "
          f"resumed: final loglik, K, sweep log and merge pairs == phase "
          f"4's; emergency checkpoint {rec['d']['emergency_save_ms']} ms, "
          f"per-K checkpoint {np.mean(rec['d']['save_ms']):.2f} ms, "
          f"sub-step restore {rec['d']['restore_substep_ms']} ms")

    # --- (e) batched restarts with nan_loglik on restart 2
    sel = {}
    for backend in ("auto", "torch"):
        path = workdir / f"e_{backend}.jsonl"
        with faults.use({"nan_loglik": {"iter": 3, "restart": 2}}):
            res, model, _, _ = fit(data, K0, K_TARGET, ITERS, n_init=LANES,
                                   restart_batch_size=LANES,
                                   estep_backend=backend,
                                   metrics_file=str(path))
        pick = next(r for r in read_stream(str(path))
                    if r["event"] == "restart_select")
        sel[backend] = (pick["dropped"], pick["winner"],
                        res.ideal_num_clusters, model.estep_backend)
    check(sel["auto"][3] == "cuda", "(e) the batched path left K3/K4")
    check(sel["auto"][:3] == sel["torch"][:3] and sel["auto"][0] == [2],
          f"(e) kernels {sel['auto'][:3]}, torch ops {sel['torch'][:3]}")
    rec["e"] = {"dropped": sel["auto"][0], "winner": sel["auto"][1]}
    print(f"  (e) {LANES} batched restarts, nan_loglik on restart 2: "
          f"dropped {sel['auto'][0]}, winner init {sel['auto'][1]}, K "
          f"{sel['auto'][2]}, as on the torch-ops batched path")
    torch.cuda.synchronize()
    return rec


# ------------------------------------------------- phase 13: capture

def _equal_states(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("N", "pi", "constant", "avgvar", "means", "R",
                         "Rinv", "active"))


def _equal_fits(a, b, pairs: bool = True) -> bool:
    """K, sweep log (K, loglik, score, iterations), final loglik, the best
    state and (``pairs``) the merge pairs, all exactly equal."""
    return (a.ideal_num_clusters == b.ideal_num_clusters
            and (not pairs
                 or [m[1] for m in a.merges] == [m[1] for m in b.merges])
            and [r[:4] for r in a.sweep_log] == [r[:4] for r in b.sweep_log]
            and a.final_loglik == b.final_loglik
            and _equal_states(a.state, b.state))


def _rate(result) -> float:
    return (sum(r[3] for r in result.sweep_log)
            / sum(r[4] for r in result.sweep_log))


def replay_read_cost(data, n: int = 50) -> dict:
    """Milliseconds per EM iteration of the captured loop at full width
    (phase 2's state, an iteration bound it never reaches), replayed ``n``
    times without a read and ``n`` times reading its status scalar after
    each replay, in turns (no read, read, read, no read); and the bytes of
    the graph pool of that width."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    state, chunks, wts, _ = stats_inputs(data, K0, False)
    model = GMMModel(GMMConfig(min_iters=ITERS, max_iters=ITERS))
    prog = model.em_program(state, chunks, wts, len(data), ITERS + 1)
    prog.ctrl.set(convergence_epsilon(*data.shape), 10 * n, 10 * n, None,
                  10.0, None)
    prog.start(state)
    out = {"no_read": [], "read": []}
    for turn in ("no_read", "read", "read", "no_read"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            prog.advance(1)
            if turn == "read":
                prog.status()
        torch.cuda.synchronize()
        out[turn].append(1e3 * (time.perf_counter() - t0) / n)
    pool = model.graph_pool_bytes()
    print(f"  (a) captured iteration, host clock over {n} replays: "
          f"{out['no_read']} ms without a read, {out['read']} ms reading the "
          f"status scalar after each; the graph pool of this width "
          f"{pool} bytes")
    return out, pool


def phase_capture(data, main_result, workdir: Path) -> dict:
    """Phase 13 (see the module docstring)."""
    import torch

    from cuda_gmm_mpi_tpu_torch import supervisor
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.telemetry import read_stream
    from cuda_gmm_mpi_tpu_torch.testing import faults
    from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

    rec = {}
    # --- (a) the captured loop against the eager one, in turns
    fits, rates, launches = {}, {"eager": [], "captured": []}, []
    for turn in ("eager", "captured", "captured", "eager"):
        fs.fused_stats.launches = fs.mstep.launches = 0
        res, model, _, wall = fit(data, K0, K_TARGET, ITERS,
                                  eager=turn == "eager")
        iters = sum(r[3] for r in res.sweep_log)
        launches.append((turn, fs.fused_stats.launches, fs.mstep.launches,
                         iters, len(res.sweep_log)))
        rates[turn].append(_rate(res))
        fits.setdefault(turn, res)
        if turn == "captured" and "capture_s" not in rec:
            rec["capture_s"] = model.capture_log  # [(width, seconds)]
        check(model.captures is (turn == "captured"), f"(a) {turn} route")
        del model
    check(_equal_fits(fits["eager"], fits["captured"])
          and _equal_fits(fits["captured"], main_result),
          "(a) the captured fit differs from the eager one (or phase 4's)")
    rec["em_iters_per_s"] = rates
    print(f"  (a) main path EM iters/s, eager {rates['eager']}, captured "
          f"{rates['captured']} (turns eager, captured, captured, eager): "
          f"K, merge pairs, sweep log, final loglik and best state =="
          f"; capture (warm-up + 2 graphs), (width, s): "
          f"{rec['capture_s']}")
    rec["profile_captured"] = profile_em(data)
    rec["replay_ms"], rec["pool_bytes"] = replay_read_cost(data)

    # --- (b) the fused sweep on the same fit
    walls = {"off": [], "fused": [], "pow2": []}
    for turn in ("off", "fused", "pow2", "pow2", "fused", "off"):
        cfg = ({"fused_sweep": True} if turn == "fused"
               else {"sweep_k_buckets": turn})
        res, model, _, wall = fit(data, K0, K_TARGET, ITERS, **cfg)
        walls[turn].append(wall)
        fits.setdefault(turn, res)
        del model
    off, fused = fits["off"], fits["fused"]
    # The fused sweep reports no merge pairs (its reductions stay on the
    # device), as in the JAX package.
    check(_equal_fits(fused, off, pairs=False),
          "(b) the fused sweep differs from the host sweep at 'off'")
    rec["walls_s"] = walls
    print(f"  (b) fused sweep == host sweep at 'off' (K, sweep log, final "
          f"loglik, best state); fit walls s: fused {walls['fused']}, "
          f"'off' {walls['off']}, 'pow2' {walls['pow2']}")
    ckdir = workdir / "fused_ck"
    with timed_checkpoints() as ck_times:
        res, _, _, wall = fit(data, K0, K_TARGET, ITERS, fused_sweep=True,
                              checkpoint_dir=str(ckdir / "whole"))
    check([r[:4] for r in res.sweep_log]
          == [r[:4] for r in fused.sweep_log], "(b) checkpointed fused fit")
    rec["emit_save_ms"] = [1e3 * t for t in ck_times["save_local"]]
    rec["fused_checkpointed_wall_s"] = wall
    print(f"  (b) with checkpoint_dir: fit {wall:.3f} s, per-K emission "
          f"(npz save) {rec['emit_save_ms']} ms")
    # A stop requested during K = 99 lands at its emission, after its
    # checkpoint (the fused sweep's only intervention point).
    orig = SweepCheckpointer.save_local

    def save_then_stop(self, step, payload):
        orig(self, step, payload)
        if step == 1:
            supervisor.current().request_stop("preempt_injected")

    SweepCheckpointer.save_local = save_then_stop
    try:
        with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
            try:
                fit(data, K0, K_TARGET, ITERS, fused_sweep=True,
                    checkpoint_dir=str(ckdir / "stop"))
                check(False, "(b) the requested stop did not stop the sweep")
            except supervisor.PreemptedError as e:
                stop = (e.step, e.checkpointed)
    finally:
        SweepCheckpointer.save_local = orig
    check(stop == (1, True), f"(b) stopped at {stop}")
    with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
        res, _, _, _ = fit(data, K0, K_TARGET, ITERS, fused_sweep=True,
                           checkpoint_dir=str(ckdir / "stop"))
    check(_equal_fits(res, fused, pairs=False),
          "(b) the resumed fused fit differs from the uninterrupted one")
    print(f"  (b) stop requested in K = 99: exit at its emission (step, "
          f"checkpointed) {stop}; resumed == the uninterrupted fused fit")

    # --- (c) nan_loglik at iteration 3 of K = 100 in the fused sweep
    path = workdir / "c.jsonl"
    with faults.use({"nan_loglik": {"iter": 3}}):
        res, model, _, _ = fit(data, K0, K_TARGET, ITERS, fused_sweep=True,
                               metrics_file=str(path))
    acts = [(r.get("where"), r.get("action"), r["k"])
            for r in read_stream(str(path))
            if r["event"] in ("health", "recovery")]
    check(acts[:2] == [("fused_sweep", None, K0), (None, "host_fallback", K0)],
          f"(c) records {acts}")
    # The fused program consumed the plan, so the fallback runs clean.
    check(_equal_fits(res, main_result),
          "(c) the host fallback differs from phase 4's fit")
    rec["c"] = {"records": acts, "k": res.ideal_num_clusters}
    print(f"  (c) fused sweep, nan_loglik at iteration 3 of K = {K0}: "
          f"records {acts[:2]}; the host-driven fallback == phase 4's fit "
          f"(K {res.ideal_num_clusters}, pairs {[m[1] for m in res.merges]})")

    # --- (d) the counters of (a)
    for turn, k1, k2, iters, n_k in launches:
        check(k2 == iters and k1 == iters + n_k,
              f"(d) {turn}: K1 {k1}, K2 {k2} for {iters} iterations, {n_k} Ks")
    rec["launches"] = launches
    print(f"  (d) launches (turn, K1, K2, iterations, Ks): {launches}")
    torch.cuda.synchronize()
    return rec



def _scrape_loop(stop, scrapes: list, errors: list, hz: float = 10.0):
    """Scrape the live exporter's /metrics about ``hz`` times a second
    until ``stop`` is set. A failed scrape is an error unless the exporter
    stopped meanwhile (the fit ended between the lookup and the request)."""
    import urllib.request

    from cuda_gmm_mpi_tpu_torch.telemetry import exporter

    while not stop.is_set():
        exp = exporter.current_exporter()
        if exp is not None and exp.port:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{exp.port}/metrics",
                        timeout=10) as r:
                    scrapes.append((time.perf_counter(), r.status,
                                    r.headers["Content-Type"],
                                    r.read().decode()))
            except Exception as e:  # noqa: BLE001 -- judged below
                if exporter.current_exporter() is exp:
                    errors.append(repr(e))
        stop.wait(1.0 / hz)


def _gauge(body: str, name: str):
    import re

    m = re.search(rf"^{name} (\S+)$", body, re.M)
    return None if m is None else float(m.group(1))


def phase_observability(data, main_result, workdir: Path) -> dict:
    """Phase 14 (see the module docstring)."""
    import contextlib
    import io
    import threading

    import torch

    from cuda_gmm_mpi_tpu_torch.cli import main as cli_main
    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.models.order_search import compute_envelope
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.telemetry import (
        build_span_tree, exporter, read_stream, validate_stream,
    )
    from cuda_gmm_mpi_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    rec = {}
    total_mem = torch.cuda.get_device_properties(0).total_memory
    # --- (a) the observed fit, scraped at ~10 Hz
    path = workdir / "observed.jsonl"
    scrapes, errors = [], []
    stop = threading.Event()
    scraper = threading.Thread(target=_scrape_loop,
                               args=(stop, scrapes, errors), daemon=True)
    fs.fused_stats.launches = fs.mstep.launches = 0
    scraper.start()
    try:
        res, model, _, wall = fit(data, K0, K_TARGET, ITERS,
                                  metrics_file=str(path), metrics_port=0,
                                  profile=True)
    finally:
        stop.set()
        scraper.join()
    launches = {"K1": fs.fused_stats.launches, "K2": fs.mstep.launches}
    iters = sum(r[3] for r in res.sweep_log)
    check(launches == {"K1": iters + len(res.sweep_log), "K2": iters},
          f"(a) launches {launches} for {iters} iterations")
    check(exporter.current_exporter() is None, "(a) the exporter outlived "
          "the fit")
    check(_equal_fits(res, main_result),
          "(a) the observed fit differs from phase 4's (K, merge pairs, "
          "sweep log, final loglik, best state)")
    records = read_stream(str(path))
    problems = validate_stream(records)
    check(not problems, f"(a) stream: {problems[:3]}")
    roots = build_span_tree(records)
    check([r["span"]["name"] for r in roots] == ["fit"], "(a) span roots")
    sweeps = roots[0]["children"]
    check([c["span"]["name"] for c in sweeps] == ["sweep"], "(a) fit > sweep")
    em_ks = [(c["span"]["name"], c["span"].get("k"))
             for c in sweeps[0]["children"]]
    check(em_ks == [("em_k", r[0]) for r in res.sweep_log],
          f"(a) sweep > one em_k per K: {em_ks}")
    compiles = [r for r in records if r["event"] == "compile"]
    em_compiles = [r for r in compiles if r["site"] == "em_program"]
    check([(r["width"]) for r in em_compiles]
          == [w for w, _ in model.capture_log] and em_compiles,
          f"(a) em_program compile events {len(em_compiles)} against "
          f"{len(model.capture_log)} captures")
    summary = [r for r in records if r["event"] == "run_summary"][-1]
    prof = summary["profile"]
    marks = prof.get("watermarks", {})
    for name in ("em_k", "sweep"):
        peak = marks.get(name, {}).get("peak_bytes", 0)
        check(0 < peak < total_mem, f"(a) watermark {name}: {marks}")
    check(0 < prof.get("hbm_peak_bytes", 0) < total_mem,
          "(a) hbm_peak_bytes")
    check(not errors, f"(a) scrape errors: {errors[:3]}")
    iters_seen = [_gauge(b, "gmm_em_iters_total") for _, _, _, b in scrapes]
    iters_seen = [v for v in iters_seen if v is not None]
    hbm_seen = [_gauge(b, "gmm_hbm_peak_bytes") for _, _, _, b in scrapes]
    hbm_seen = [v for v in hbm_seen if v is not None]
    check(all(st == 200 and ct == exporter.CONTENT_TYPE
              and b.endswith("# EOF\n") for _, st, ct, b in scrapes),
          "(a) a scrape's status, type or terminator")
    check(len(iters_seen) >= 2 and max(iters_seen) > min(iters_seen),
          f"(a) the scrapes saw gmm_em_iters_total {iters_seen}")
    check(hbm_seen and 0 < max(hbm_seen) < total_mem,
          f"(a) the scrapes saw gmm_hbm_peak_bytes {hbm_seen}")
    env = res.envelope
    check(env is not None and env["num_events"] == N_EVENTS
          and sum(env["occupancy"]) == N_EVENTS
          and env["score"]["count"] == N_EVENTS
          and summary.get("envelope") == env,
          "(a) the envelope (num_events, occupancy, run_summary)")
    rec["a"] = dict(
        wall_s=wall, records=len(records), spans=sum(
            r["event"] == "span" for r in records),
        compiles=[(r["site"], r.get("width"), r["seconds"],
                   r.get("graph_pool_bytes")) for r in compiles],
        captures=model.capture_log, watermarks=marks,
        hbm_peak_bytes=prof["hbm_peak_bytes"], scrapes=len(scrapes),
        em_iters_seen=sorted(set(iters_seen)), launches=launches,
        phase_profile=summary["phase_profile"],
        envelope_mean=env["score"]["mean"])
    print(f"  (a) observed fit (recorder, live plane, profile, envelope): "
          f"== phase 4's fit; {len(records)} records valid, span tree fit > "
          f"sweep > {len(em_ks)} em_k; compile events (site, width, s, pool "
          f"bytes) {rec['a']['compiles']} for captures {model.capture_log}; "
          f"watermarks {marks}; {len(scrapes)} scrapes, no error, "
          f"gmm_em_iters_total seen {rec['a']['em_iters_seen']}, "
          f"gmm_hbm_peak_bytes {max(hbm_seen):.0f}; envelope over "
          f"{env['num_events']} events, occupancy sums to "
          f"{sum(env['occupancy'])}; launches {launches}")
    print("  (a) --profile table:\n    " + res.profile_report.replace(
        "\n", "\n    "))
    # --- (b) costs: bare and observed fits in turns; the envelope pass
    # Whole-fit EM iters/s, and over the Ks after the first: the first K
    # carries the width's capture, whose time spreads between fits
    # (0.21-0.58 s on the card, observed or not).
    rates = {"bare": [], "observed": []}
    steady = {"bare": [], "observed": []}
    for turn in ("bare", "observed", "observed", "bare"):
        cfg = ({} if turn == "bare" else dict(
            metrics_file=str(workdir / f"{turn}.jsonl"), metrics_port=0,
            profile=True))
        r_, m_, _, _ = fit(data, K0, K_TARGET, ITERS, **cfg)
        check(_equal_fits(r_, main_result), f"(b) {turn} fit differs")
        rates[turn].append(_rate(r_))
        steady[turn].append(sum(r[3] for r in r_.sweep_log[1:])
                            / sum(r[4] for r in r_.sweep_log[1:]))
        del m_
    chunks_np, _ = chunk_events(
        data.astype(np.float32) - np.asarray(res.data_shift)[None, :], 65536)
    chunks = model.place(chunks_np)
    env_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = compute_envelope(model, res.state, chunks, N_EVENTS,
                                 res.ideal_num_clusters)
        torch.cuda.synchronize()
        env_s.append(time.perf_counter() - t0)
        check(again is not None and again["occupancy"] == env["occupancy"]
              and again["score"]["buckets"] == env["score"]["buckets"],
              "(b) the envelope pass on its own differs from the fit's")
    del chunks
    rec["b"] = dict(em_iters_per_s=rates, after_first_k=steady,
                    envelope_s=env_s)
    print(f"  (b) EM iters/s (turns bare, observed, observed, bare): bare "
          f"{rates['bare']}, observed {rates['observed']}; over the Ks after "
          f"the first: bare {steady['bare']}, observed {steady['observed']}; "
          f"the envelope pass over {N_EVENTS} events at "
          f"K={res.ideal_num_clusters}: {env_s} s")
    # --- (c) a fit under --trace-dir: K1 kernel events against the counter
    tdir = workdir / "trace"
    fs.fused_stats.launches = 0
    with trace(str(tdir), device="cuda"):
        r_, m_, _, _ = fit(data, K0, K_TARGET, ITERS)
        torch.cuda.synchronize()
    k1_counter = fs.fused_stats.launches
    # Each captured width's warm-up runs the initial E-step and one
    # iteration eagerly once: two K1 launches on the card that the counter
    # sets back (models/em_program.py::warm_up).
    k1_warm = 2 * len(m_.capture_log)
    del m_
    (tfile,) = tdir.glob("gmm_trace.*.json")
    events = json.loads(tfile.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = sum("fused_stats_kernel" in e.get("name", "")
                    for e in kernels)
    check(kernels, "(c) the trace holds no CUDA kernel event")
    check(_equal_fits(r_, main_result), "(c) the traced fit differs")
    rec["c"] = dict(trace_bytes=tfile.stat().st_size,
                    kernel_events=len(kernels), k1_events=k1_events,
                    k1_launches=k1_counter, k1_warm_up=k1_warm)
    print(f"  (c) --trace-dir fit: {tfile.stat().st_size} bytes of Chrome "
          f"trace, {len(kernels)} kernel events, K1 kernel events "
          f"{k1_events} against the launch counter's {k1_counter} + "
          f"{k1_warm} warm-up launches of the captured widths"
          + ("" if k1_events == k1_counter + k1_warm else
             " (MISMATCH: the profiler lost or added K1 records)"))
    # --- (d) the port's CLI on (a)'s stream
    rundir = workdir / "runs"
    rundir.mkdir()
    shutil.copy(path, rundir / "observed.jsonl")
    cli = {}
    for name, argv in (
            ("report", ["report", str(path), "--validate"]),
            ("diff", ["diff", str(path), str(path)]),
            ("runs", ["runs", str(rundir)]),
            ("timeline", ["timeline", str(path), "--validate", "-o",
                          str(workdir / "timeline.json")])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        cli[name] = (rc, len(out.getvalue().splitlines()))
        check(rc == 0, f"(d) cli {name} exited {rc}")
    report = subprocess.run(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "report",
         str(path)], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent)
    check(report.returncode == 0 and "Trace spans" in report.stdout
          and "Compile activity" in report.stdout,
          f"(d) report in a fresh process: {report.stderr[-300:]}")
    rec["d"] = cli
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"  (d) the port's CLI on (a)'s stream (exit code, stdout lines): "
          f"{cli}; report in a fresh process renders its Trace spans and "
          f"Compile activity")
    print(f"  phase 14: {rec['seconds']:.1f} s; card: {card_line()}")
    print("  phase 14 record: " + json.dumps(rec, default=str))
    return rec


# --- phase 15: the mesh made whole (restarts, resume, liveness, per-rank I/O)

P15_MESH, P15_ITERS, P15_TARGET = (2, 1), 10, K0 - 2  # K 100 -> 98
P15_LANES, P15_PEER_TIMEOUT_S = 4, 5.0
P15_TIMEOUT_S = 420


def _p15_cfg(**kw):
    from cuda_gmm_mpi_tpu_torch import GMMConfig

    return GMMConfig(min_iters=P15_ITERS, max_iters=P15_ITERS, **kw)


def _p15_summary(r) -> dict:
    return dict(k=r.ideal_num_clusters, merges=[list(m[1]) for m in r.merges],
                final_loglik=r.final_loglik, init_index=r.init_index,
                sweep=[list(row[:4]) for row in r.sweep_log],
                host_range=list(r.host_range) if r.host_range else None)


def _p15_rank(rank, world, workdir):
    """One rank of phase 15 (a)-(c), in this order (the elastic shrink of
    (c), which leaves this world, comes last). Writes rank<r>.json."""
    import torch

    from cuda_gmm_mpi_tpu_torch import fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.parallel import distributed
    from cuda_gmm_mpi_tpu_torch.testing import faults

    workdir = Path(workdir)
    distributed.initialize("cuda", coordinator=f"file://{workdir}/store",
                           num_processes=world, process_id=rank,
                           timeout_s=P15_TIMEOUT_S)
    report = {"rank": rank}
    counters = dict(K1=fs.fused_stats, K2=fs.mstep, K3=fs.fused_stats_batched,
                    K4=fs.mstep_batched, K5=fs.local_lse, K6=fs.stats_logz)

    def supervised(spec, **cfg):
        """fit_gmm under a supervisor with ``spec`` armed: (summary or
        None, exit code the CLI maps the outcome to, stop fields)."""
        with faults.use(spec or {}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)) as sup:
            t0 = time.perf_counter()
            try:
                r = fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(**cfg))
                return _p15_summary(r), 0, {"s": time.perf_counter() - t0}
            except (supervisor.PreemptedError,
                    supervisor.PeerLostError) as e:
                lost = sup.lost_peer
                return None, supervisor.EX_TEMPFAIL, dict(
                    error=type(e).__name__, step=getattr(e, "step", None),
                    em_iter=getattr(e, "em_iter", None),
                    reason=getattr(e, "reason", None),
                    s=time.perf_counter() - t0,
                    stop_to_raise_s=(time.monotonic() - lost["at"]
                                     if lost and "at" in lost else None))
    try:
        data = np.load(workdir / "events.npy")
        # (a) n_init = 4 on the (2, 1) mesh: K3 + one all_reduce + K4 per
        # batched iteration on each rank's half of the events.
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(
            mesh_shape=P15_MESH, n_init=P15_LANES,
            restart_batch_size=P15_LANES))
        torch.cuda.synchronize()
        report["a"] = dict(_p15_summary(r), fit_s=time.perf_counter() - t0,
                           launches={k: c.launches
                                     for k, c in counters.items()},
                           timings=r.timings, backend=r.model.estep_backend)
        # (e) diag restarts on a (1, 2) mesh: the lanes of the
        # cluster-sharded loop, K5/K6 per lane (2 inits: the 'even' seed
        # and one k-means++).
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(
            mesh_shape=(1, 2), n_init=2, restart_batch_size=2,
            diag_only=True))
        torch.cuda.synchronize()
        report["e"] = dict(_p15_summary(r), fit_s=time.perf_counter() - t0,
                           launches={k: c.launches
                                     for k, c in counters.items()},
                           timings=r.timings, backend=r.model.estep_backend)
        # (b) preempt in K = 99 on both ranks (a stop in K = 100 first,
        # resumed into K = 99), then resume: == the uninterrupted mesh fit.
        report["b"] = {"ref": supervised(None, mesh_shape=P15_MESH)[0]}
        ck = str(workdir / "ck_b")
        with timed_checkpoints() as ck_times:
            stops = []
            for _ in range(2):
                _, rc, info = supervised(
                    {"preempt": {"iter": 4}}, mesh_shape=P15_MESH,
                    checkpoint_dir=ck, preempt_poll_iters=1)
                stops.append(dict(info, rc=rc))
            resumed, rc, _ = supervised(None, mesh_shape=P15_MESH,
                                        checkpoint_dir=ck,
                                        preempt_poll_iters=1)
        report["b"].update(stops=stops, resumed=resumed, resumed_rc=rc,
                           save_ms=[1e3 * t for t in ck_times["save"]],
                           substep_ms=[1e3 * t for t in
                                       ck_times["save_substep"]])
        # (c) rank_lost on rank 1 at iteration 3 of K = 100, without and
        # with elastic recovery (the shrink leaves this world: last).
        common = dict(mesh_shape=P15_MESH, preempt_poll_iters=1,
                      peer_timeout_s=P15_PEER_TIMEOUT_S, sweep_k_buckets="off")
        lost = {"rank_lost": {"iter": 3, "rank": 1}}
        _, rc, info = supervised(lost, checkpoint_dir=str(workdir / "ck_c1"),
                                 **common)
        report["c"] = {"plain": dict(info, rc=rc)}
        res, rc, info = supervised(lost, checkpoint_dir=str(workdir / "ck_c2"),
                                   elastic=True, elastic_backoff_s=0.0,
                                   **common)
        from cuda_gmm_mpi_tpu_torch.parallel import elastic

        report["c"]["elastic"] = dict(info, rc=rc, result=res,
                                      world=list(elastic.world()),
                                      generation=elastic.generation())
        (workdir / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        distributed.shutdown()


def _stamp_peer_loss():
    """Stamps the monotonic instant a peer is declared lost onto the
    supervisor's ``lost_peer`` (phase 15 (c) times the exit from it)."""
    from cuda_gmm_mpi_tpu_torch import supervisor

    orig = supervisor.RunSupervisor._synthesize_peer_loss

    def stamped(self, **kw):
        orig(self, **kw)
        self._lost_peer["at"] = time.monotonic()
    supervisor.RunSupervisor._synthesize_peer_loss = stamped


def _p15_rank_main(rank, world, workdir):
    _stamp_peer_loss()
    _p15_rank(rank, world, workdir)


_P15_CLI = r"""
import json, resource, sys, threading
import torch
from cuda_gmm_mpi_tpu_torch.io import readers
from cuda_gmm_mpi_tpu_torch.cli import main

def rss_mib():
    for line in open("/proc/self/status"):
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024
# The host memory of the run above the process's CUDA baseline: the peak
# of VmRSS sampled every 10 ms after the context is up (the CUDA start-up
# spike sets ru_maxrss alike in every process).
torch.zeros(1, device="cuda")
base, peak, done = rss_mib(), [0.0], threading.Event()
def sample():
    while not done.wait(0.01):
        peak[0] = max(peak[0], rss_mib())
threading.Thread(target=sample, daemon=True).start()
ranges, rows = [], [0]
orig_range, orig_rows = readers.FileSource.read_range, readers.FileSource.read_rows
def read_range(self, a, b):
    ranges.append([int(a), int(b)]); return orig_range(self, a, b)
def read_rows(self, idx):
    rows[0] += len(idx); return orig_rows(self, idx)
readers.FileSource.read_range, readers.FileSource.read_rows = read_range, read_rows
rc = main(sys.argv[1:])
done.set()
print("P15 " + json.dumps({"rc": rc, "ranges": ranges, "seed_rows": rows[0],
      "maxrss_kib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
      "rss_base_mib": base, "rss_peak_mib": max(peak[0], rss_mib())}),
      file=sys.stderr)
sys.exit(rc)
"""


def _p15_cli(workdir: Path, infile: str, out: str, world: int) -> list:
    """The port's CLI on ``world`` ranks (their own processes, one
    ``file://`` store), each wrapped to log its range reads and peak RSS.
    Returns the processes; the caller collects them."""
    # float64: a float32 mesh sums the data axis's statistics in another
    # order than one process, and a last-bit difference can flip a printed
    # digit; the bytes are the same only where the sums are exact enough.
    args = [str(K0), infile, str(workdir / out), str(P15_TARGET),
            f"--min-iters={P15_ITERS}", f"--max-iters={P15_ITERS}",
            "--dtype=float64"]
    if world > 1:
        args += [f"--mesh={P15_MESH[0]},{P15_MESH[1]}",
                 f"--part-dir={workdir / 'parts'}",
                 f"--coordinator=file://{workdir / ('store_' + out)}",
                 f"--num-processes={world}"]
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-c", _P15_CLI, *args]
        + ([f"--process-id={r}"] if world > 1 else []),
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _p15_collect(procs, label) -> list:
    out = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=P15_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise PhaseError(f"(d) {label} rank {r} still running after "
                             f"{P15_TIMEOUT_S} s") from None
        lines = [ln for ln in err.splitlines() if ln.startswith("P15 ")]
        check(p.returncode == 0 and lines,
              f"(d) {label} rank {r}: exit {p.returncode}: {err[-2000:]}")
        out.append(json.loads(lines[-1][4:]))
    return out


def _same_bytes(a: Path, b: Path, block: int = 1 << 24) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(block), fb.read(block)
            if x != y:
                return False
            if not x:
                return True


def phase_mesh_whole(data, workdir: Path, card: str) -> dict:
    """Phase 15: restarts on a mesh, preempt and resume, peer loss and
    per-rank I/O, on 2 ranks sharing the one card over gloo."""
    import torch
    import torch.multiprocessing as mp

    from cuda_gmm_mpi_tpu_torch import fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.io import write_bin
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    world = P15_MESH[0] * P15_MESH[1]
    np.save(workdir / "events.npy", data)
    infile = str(workdir / "events.bin")
    write_bin(infile, data)
    t_phase = time.perf_counter()
    # The one-card references: the batched restart fit of (a), then the
    # ranks of (a)-(c); (d)'s CLI runs last (2 ranks beside 1 process).
    t0 = time.perf_counter()
    ref_a = fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(
        n_init=P15_LANES, restart_batch_size=P15_LANES))
    torch.cuda.synchronize()
    ref_a_s = time.perf_counter() - t0
    ref_e = fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(
        n_init=2, restart_batch_size=2, diag_only=True))
    ctx = mp.start_processes(_p15_rank_main, args=(world, str(workdir)),
                             nprocs=world, join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > P15_TIMEOUT_S:
                raise PhaseError(f"phase 15 ranks still running after "
                                 f"{P15_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise PhaseError(f"a phase 15 rank failed: {e}") from None
    except mp.ProcessExitedException as e:
        raise PhaseError(f"a phase 15 rank died: {e}") from None
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        stop_resource_tracker()
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(world)]
    out = {}

    # (a)
    a = [rk["a"] for rk in ranks]
    ref_pairs = [list(m[1]) for m in ref_a.merges]
    rec_a = {"card": card, "ref_fit_s": ref_a_s, "ranks": []}
    for rk, x in zip(ranks, a):
        lc = x["launches"]
        check(x["backend"] == "cuda", f"(a) rank {rk['rank']} backend")
        check(lc["K3"] > 0 and lc["K4"] > 0 and lc["K1"] == lc["K2"] == 0,
              f"(a) rank {rk['rank']} launches {lc}")
        check(x["init_index"] == ref_a.init_index
              and x["k"] == ref_a.ideal_num_clusters
              and x["merges"] == ref_pairs,
              f"(a) rank {rk['rank']}: init {x['init_index']}, K {x['k']}, "
              f"pairs {x['merges']} against the one-card fit's "
              f"{ref_a.init_index}, {ref_a.ideal_num_clusters}, {ref_pairs}")
        rel = abs(x["final_loglik"] - ref_a.final_loglik) / abs(
            ref_a.final_loglik)
        check(rel <= 1e-5, f"(a) rank {rk['rank']}: loglik rtol {rel:.2e}")
        lane_iters = lc["K4"] * P15_LANES
        em_s = x["timings"]["em"]
        rec_a["ranks"].append(dict(
            rank=rk["rank"], launches=lc, loglik_rtol=rel,
            lane_iterations=lane_iters, em_s=em_s,
            lane_iterations_per_s=lane_iters / em_s, fit_s=x["fit_s"],
            seed_s=x["timings"]["seed"], host_range=x["host_range"],
            ms_per_batched_iteration=1e3 * em_s / lc["K4"]))
    rec_a["ref"] = dict(timings=ref_a.timings,
                        init_index=ref_a.init_index, k=ref_a.ideal_num_clusters)
    out["a"] = rec_a
    print(json.dumps({"phase15": "a", **rec_a}))

    # (e)
    rec_e = {"card": card, "ranks": []}
    e_pairs = [list(m[1]) for m in ref_e.merges]
    for rk in ranks:
        x, lc = rk["e"], rk["e"]["launches"]
        check(x["backend"] == "cuda" and lc["K5"] > 0 and lc["K5"] == lc["K6"]
              and lc["K1"] == lc["K2"] == lc["K3"] == lc["K4"] == 0,
              f"(e) rank {rk['rank']}: backend {x['backend']}, launches {lc}")
        check(x["init_index"] == ref_e.init_index
              and x["k"] == ref_e.ideal_num_clusters and x["merges"] == e_pairs,
              f"(e) rank {rk['rank']}: init {x['init_index']}, K {x['k']}, "
              f"pairs {x['merges']} against {ref_e.init_index}, "
              f"{ref_e.ideal_num_clusters}, {e_pairs}")
        rel = abs(x["final_loglik"] - ref_e.final_loglik) / abs(
            ref_e.final_loglik)
        check(rel <= 1e-5, f"(e) rank {rk['rank']}: loglik rtol {rel:.2e}")
        rec_e["ranks"].append(dict(
            rank=rk["rank"], launches=lc, loglik_rtol=rel,
            em_s=x["timings"]["em"],
            ms_per_lane_estep=1e3 * x["timings"]["em"] / lc["K5"]))
    out["e"] = rec_e
    print(json.dumps({"phase15": "e", **rec_e}))

    # (b)
    b = [rk["b"] for rk in ranks]
    for rk, x in zip(ranks, b):
        st = [(s["rc"], s["step"], s["em_iter"]) for s in x["stops"]]
        check(st == [(75, 0, 4), (75, 1, 4)],
              f"(b) rank {rk['rank']}: stops (exit, step, iteration) {st}")
        # The merge of K = 100 was made before the stop in K = 99: the
        # resumed fit's own merges are the rest.
        ref = dict(x["ref"], merges=x["ref"]["merges"][1:])
        check(x["resumed_rc"] == 0 and x["resumed"] == ref,
              f"(b) rank {rk['rank']}: the resumed fit differs from the "
              f"uninterrupted mesh fit")
    check(b[0]["save_ms"] and b[0]["substep_ms"], "(b) rank 0 wrote nothing")
    rec_b = {"card": card, "stops": b[0]["stops"],
             "save_ms_per_k": b[0]["save_ms"],
             "emergency_substep_ms": b[0]["substep_ms"],
             "rank1_save_calls": len(b[1]["save_ms"])}
    out["b"] = rec_b
    print(json.dumps({"phase15": "b", **rec_b}))

    # (c)
    plain = [rk["c"]["plain"] for rk in ranks]
    check([p["rc"] for p in plain] == [75, 75]
          and [p["error"] for p in plain] == ["PeerLostError"] * 2,
          f"(c) without elastic: {plain}")
    grace = min(P15_PEER_TIMEOUT_S, 30.0)
    check(plain[0]["stop_to_raise_s"] is not None
          and plain[0]["stop_to_raise_s"] <= P15_PEER_TIMEOUT_S + grace,
          f"(c) rank 0 took {plain[0]['stop_to_raise_s']} s to exit")
    el = [rk["c"]["elastic"] for rk in ranks]
    check(el[0]["rc"] == 0 and el[0]["world"] == [0, 1]
          and el[0]["generation"] == 1 and el[1]["rc"] == 75,
          f"(c) elastic: rank 0 exit {el[0]['rc']} world {el[0]['world']}, "
          f"rank 1 exit {el[1]['rc']}")
    with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
        one = _p15_summary(fit_gmm(data, K0, P15_TARGET, config=_p15_cfg(
            checkpoint_dir=str(workdir / "ck_c1"), elastic=True,
            preempt_poll_iters=1, sweep_k_buckets="off")))
    check(el[0]["result"] == one,
          "(c) the survivor's fit differs from one process resumed from the "
          "same emergency sub-step")
    rec_c = {"card": card, "plain_exit": [p["rc"] for p in plain],
             "plain_stop_to_exit_s": [p["stop_to_raise_s"] for p in plain],
             "peer_timeout_s": P15_PEER_TIMEOUT_S, "grace_s": grace,
             "elastic_exit": [x["rc"] for x in el],
             "elastic_fit_s": el[0]["s"], "elastic_world": el[0]["world"],
             "survivor_equals_one_process_resume": True}
    out["c"] = rec_c
    print(json.dumps({"phase15": "c", **rec_c}))

    # (d) the CLI: per-rank reading and output, beside one process
    t0 = time.perf_counter()
    mesh_procs = _p15_cli(workdir, infile, "mesh", world)
    one_procs = _p15_cli(workdir, infile, "one", 1)
    mesh_logs = _p15_collect(mesh_procs, "mesh")
    one_log = _p15_collect(one_procs, "one process")[0]
    cli_s = time.perf_counter() - t0
    n = data.shape[0]
    for r, lg in enumerate(mesh_logs):
        lo, hi = (r * n) // world, ((r + 1) * n) // world
        fit_range = lg["ranges"][0]
        read = sum(b - a for a, b in lg["ranges"])
        check(all(fit_range[0] <= a <= b <= fit_range[1]
                  for a, b in lg["ranges"]) and read <= 2 * (hi - lo) + 65536,
              f"(d) rank {r} read ranges {lg['ranges']}")
    same = {ext: _same_bytes(workdir / f"mesh{ext}", workdir / f"one{ext}")
            for ext in (".summary", ".results")}
    check(all(same.values()), f"(d) files differ from one process: {same}")
    check(not list((workdir / "parts").glob("*.part*")), "(d) parts left")
    rec_d = {"card": card, "cli_wall_s": cli_s,
             "rank_ranges": [lg["ranges"] for lg in mesh_logs],
             "rank_seed_rows": [lg["seed_rows"] for lg in mesh_logs],
             "rank_maxrss_mib": [lg["maxrss_kib"] / 1024 for lg in mesh_logs],
             "one_process_maxrss_mib": one_log["maxrss_kib"] / 1024,
             "rank_rss_above_cuda_baseline_mib": [
                 lg["rss_peak_mib"] - lg["rss_base_mib"] for lg in mesh_logs],
             "one_process_rss_above_cuda_baseline_mib":
                 one_log["rss_peak_mib"] - one_log["rss_base_mib"],
             "rss_cuda_baseline_mib": [lg["rss_base_mib"]
                                       for lg in mesh_logs + [one_log]],
             "one_process_ranges": one_log["ranges"],
             "results_bytes": (workdir / "mesh.results").stat().st_size,
             "byte_identical": same}
    out["d"] = rec_d
    print(json.dumps({"phase15": "d", **rec_d}))
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 15 took {out['wall_s']:.1f} s; {card}")
    return out


# ------------------------------------------------------------ phase 16

P16_EVENTS, P16_ITERS, P16_TARGET = 10_000_000, 10, K0 - 2  # K 100 -> 98
P16_CHUNK, P16_BIG_CHUNK = 65536, 1 << 20
P16_MB_SIZE, P16_MB_STEPS = 1 << 20, 40
# The stepwise-EM bar of tests/test_ingest.py:251-266 in that test's regime,
# on 1M events: K = the 4 blobs of phase 4's generator, full EM 12
# iterations against 340 steps over a quarter of the events each (the
# test's matched gamma sum and minibatch share).
P16_BAR_K, P16_BAR_FULL, P16_BAR_STEPS, P16_BAR_SIZE = 4, 12, 340, 1 << 18
P16_PREEMPT = {"iter": 3, "block": 7}
P16_TIMEOUT_S = 600
P16_ARMS = ("inmemory", "resident", "pipelined", "resident_1m", "minibatch")


def write_blobs_bin(path: str, seed: int, n: int, d: int, k: int,
                    spread: float = NEAR, rows: int = 1 << 20) -> None:
    """Phase 4's generator (:func:`make_blobs`: the same centres, weights and
    spreads drawn from ``seed``), its labels and noise drawn and written
    ``rows`` events at a time into a BIN file, so the writer never holds
    the data."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(k, d))
    weights = rng.uniform(0.5, 1.5, size=k)
    scales = rng.uniform(0.5, 1.5, size=k)
    p = weights / weights.sum()
    with open(path, "wb") as f:
        np.asarray([n, d], np.int32).tofile(f)
        for lo in range(0, n, rows):
            m = min(rows, n - lo)
            labels = rng.choice(k, size=m, p=p)
            x = centers[labels] + rng.normal(size=(m, d)) * scales[labels, None]
            f.write(x.astype(np.float32).tobytes())


def _rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


@contextlib.contextmanager
def rss_peak():
    """The peak of VmRSS above the entry value, sampled every 10 ms on a
    thread (phase 15's measure): yields a dict that holds ``base_mib`` and,
    after the block, ``peak_above_mib``."""
    import threading

    out = {"base_mib": _rss_mib()}
    peak, done = [out["base_mib"]], threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], _rss_mib())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        done.set()
        t.join()
        out["peak_above_mib"] = max(peak[0], _rss_mib()) - out["base_mib"]


def _p16_rate(result) -> float:
    """EM iterations (steps) per second over the Ks after the first."""
    rows = result.sweep_log[1:] or result.sweep_log
    return sum(r[3] for r in rows) / sum(r[4] for r in rows)


def p16_arm(arm: str, infile: str, outdir: str) -> dict:
    """``--p16-arm``: one fit of phase 16 (a)/(c) in this process, after a
    warm-up fit of the same kind on the file's first 131,072 events (the
    kernels and the native reader loaded, the allocators primed), so the
    host peak above the baseline is the fit's own. Writes the final
    state to ``outdir/<arm>.npz``; returns the record."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm
    from cuda_gmm_mpi_tpu_torch.io import FileSource, read_data, write_bin
    from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel
    from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    _build.build_all()
    stream = arm != "inmemory"
    extra = dict(
        resident={}, pipelined=dict(ingest="pipelined"),
        resident_1m=dict(chunk_size=P16_BIG_CHUNK),
        minibatch=dict(ingest="pipelined", em_mode="minibatch",
                       minibatch_size=P16_MB_SIZE, min_iters=P16_MB_STEPS,
                       max_iters=P16_MB_STEPS),
    ).get(arm, {})
    kw = dict(dict(min_iters=P16_ITERS, max_iters=P16_ITERS,
                   chunk_size=P16_CHUNK), **extra)
    if stream:
        kw["stream_events"] = True

    def run(path, k0, target, **over):
        config = GMMConfig(**dict(kw, **over))
        model = (StreamingGMMModel if stream else GMMModel)(config)
        data = FileSource(path) if stream else read_data(path)
        return fit_gmm(data, k0, target, config=config, model=model), model

    warm = os.path.join(outdir, f"warm_{arm}.bin")
    write_bin(warm, read_data(infile, 0, 1 << 17))
    run(warm, 4, 4, min_iters=2, max_iters=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_stats.launches = fs.mstep.launches = 0
    with rss_peak() as host:
        t0 = time.perf_counter()
        result, model = run(infile, K0, P16_TARGET)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    st = result.state
    np.savez(os.path.join(outdir, f"{arm}.npz"), means=st.means.cpu().numpy(),
             R=st.R.cpu().numpy(), pi=st.pi.cpu().numpy(),
             loglik=np.float64(result.final_loglik))
    rec = dict(
        arm=arm, backend=model.estep_backend, k=result.ideal_num_clusters,
        merges=[list(m[1]) for m in result.merges],
        final_loglik=result.final_loglik,
        sweep=[list(r[:5]) for r in result.sweep_log],
        iters=sum(r[3] for r in result.sweep_log), ks=len(result.sweep_log),
        rate_after_first_k=_p16_rate(result), fit_s=fit_s,
        launches={"K1": fs.fused_stats.launches, "K2": fs.mstep.launches},
        chunk_size=kw["chunk_size"],
        device_peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
        host_peak_above_base_mib=host["peak_above_mib"],
        host_base_mib=host["base_mib"])
    if arm == "pipelined":
        rec["profile"] = profile_stream_pass(model, result, infile)
    return rec


def profile_stream_pass(model, result, infile: str) -> dict:
    """Phase 16 (b): one pipelined pass of the final K's state under a
    torch.profiler window (the card's activity only, as phase 4's window):
    K1 device time per block (kernel + reduction), the device idle share
    between the first K1 and the last reduction, the host-to-device copies,
    and the host's wait on ingestion (``prefetch_wait_s``) against the
    rest of the pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuda_gmm_mpi_tpu_torch.io import FileSource, PipelinedBlockSource

    n = FileSource(infile).shape[0]
    cs = model.config.chunk_size
    blocks = -(-n // cs)
    shift = np.asarray(result.data_shift, np.float32)
    state = result.state.to(model.device)

    def one_pass():
        src = PipelinedBlockSource(FileSource(infile), start=0, stop=n,
                                   chunk_size=cs, num_chunks=blocks,
                                   shift=shift, dtype=np.float32)
        model._set_local_rows(src, None)
        t0 = time.perf_counter()
        model._estep_all(state, src, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        src.close()
        return wall, src.prefetch_wait_s

    one_pass()  # warm
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        wall, wait = one_pass()
        time.sleep(0.02)
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in dev if "fused_stats_kernel" in e.name]
    ends = [e.time_range.end for e in dev if "reduce_partials" in e.name]
    check(len(starts) == blocks and len(ends) == blocks,
          f"(b) profiler: {len(starts)} K1 kernels, {len(ends)} reductions "
          f"for {blocks} blocks")
    lo, hi = starts[0], ends[-1]
    busy, end = 0.0, lo
    for e in dev:
        a, b = max(e.time_range.start, end), min(e.time_range.end, hi)
        if b > a:
            busy += b - a
        end = max(end, e.time_range.end)
    copies = [e.time_range.elapsed_us() for e in dev
              if "memcpy" in e.name.lower() and "htod" in e.name.lower()]
    k1 = [(e - s) / 1e3 for s, e in zip(starts, ends)]
    rec = dict(blocks=blocks, pass_wall_s=wall, prefetch_wait_s=wait,
               host_other_s=wall - wait, window_ms=(hi - lo) / 1e3,
               device_idle_share=1.0 - busy / (hi - lo),
               k1_ms_per_block=float(np.mean(k1)),
               k1_ms_per_block_median=float(np.median(k1)),
               h2d_copies=len(copies),
               h2d_ms_per_block=(float(np.mean(copies)) / 1e3 if copies
                                 else None))
    return rec


def stepwise_bar(workdir: Path, seed: int) -> dict:
    """Phase 16 (c)'s bar: stepwise EM within 10 x convergence_epsilon of
    full EM (tests/test_ingest.py:251-266), in that test's regime at 1M x 24:
    phase 4's generator with 4 blobs, K = 4 fixed, both fits streaming the
    BIN pipelined; full EM 12 iterations, stepwise EM 340 steps of 262,144
    events (a quarter of the data, as the test's 1024 of 4096)."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.io import FileSource
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon

    path = str(workdir / "bar.bin")
    write_blobs_bin(path, seed, N_EVENTS, DIMS, P16_BAR_K)
    kw = dict(chunk_size=P16_CHUNK, stream_events=True, ingest="pipelined")
    full = fit_gmm(FileSource(path), P16_BAR_K, P16_BAR_K, config=GMMConfig(
        min_iters=P16_BAR_FULL, max_iters=P16_BAR_FULL, **kw))
    t0 = time.perf_counter()
    mb = fit_gmm(FileSource(path), P16_BAR_K, P16_BAR_K, config=GMMConfig(
        min_iters=P16_BAR_STEPS, max_iters=P16_BAR_STEPS, em_mode="minibatch",
        minibatch_size=P16_BAR_SIZE, **kw))
    mb_s = time.perf_counter() - t0
    eps = convergence_epsilon(N_EVENTS, DIMS)
    dist = mb.final_loglik - full.final_loglik
    check(abs(dist) <= 10.0 * eps,
          f"(c) stepwise EM {dist:.6g} from full EM at 1M events (bar "
          f"10 x epsilon = {10 * eps:.6g})")
    return dict(bar_events=N_EVENTS, bar_k=P16_BAR_K,
                bar_full_iters=P16_BAR_FULL, bar_steps=P16_BAR_STEPS,
                bar_minibatch=P16_BAR_SIZE, bar_loglik_minus_full_em=dist,
                bar_10_epsilon=10.0 * eps, bar_steps_per_s=P16_BAR_STEPS / mb_s,
                bar_full_loglik=full.final_loglik)


def _p16_arm_subprocess(arm: str, infile: str, outdir: str) -> dict:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--p16-arm", arm,
         "--p16-file", infile, "--p16-out", outdir],
        capture_output=True, text=True, timeout=P16_TIMEOUT_S)
    check(proc.returncode == 0,
          f"(a) the {arm} arm failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _p16_rank(rank, world, workdir):
    """One rank of phase 16 (e): the pipelined streaming fit of phase 4's
    1M-event BIN on a (2, 1) mesh. Writes p16_rank<r>.json."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.io import FileSource
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    workdir = Path(workdir)
    distributed.initialize("cuda", coordinator=f"file://{workdir}/store16",
                           num_processes=world, process_id=rank,
                           timeout_s=P16_TIMEOUT_S)
    try:
        fs.fused_stats.launches = fs.mstep.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fit_gmm(FileSource(str(workdir / "events1m.bin")), K0, P16_TARGET,
                    config=GMMConfig(
                        min_iters=P16_ITERS, max_iters=P16_ITERS,
                        chunk_size=P16_CHUNK, stream_events=True,
                        ingest="pipelined", mesh_shape=(2, 1)))
        torch.cuda.synchronize()
        rec = dict(rank=rank, k=r.ideal_num_clusters,
                   merges=[list(m[1]) for m in r.merges],
                   final_loglik=r.final_loglik, host_range=list(r.host_range),
                   iters=sum(x[3] for x in r.sweep_log),
                   ks=len(r.sweep_log), em_s=sum(x[4] for x in r.sweep_log),
                   fit_s=time.perf_counter() - t0,
                   launches={"K1": fs.fused_stats.launches,
                             "K2": fs.mstep.launches},
                   backend=r.model.estep_backend)
        (workdir / f"p16_rank{rank}.json").write_text(json.dumps(rec))
    finally:
        distributed.shutdown()


def _p16_mesh(workdir: Path) -> list:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_p16_rank, args=(2, str(workdir)), nprocs=2,
                             join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > P16_TIMEOUT_S:
                raise PhaseError(f"phase 16 ranks still running after "
                                 f"{P16_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise PhaseError(f"a phase 16 rank failed: {e}") from None
    except mp.ProcessExitedException as e:
        raise PhaseError(f"a phase 16 rank died: {e}") from None
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        stop_resource_tracker()
    return [json.loads((workdir / f"p16_rank{r}.json").read_text())
            for r in range(2)]


def phase_out_of_core(data, workdir: Path, card: str, seed: int) -> dict:
    """Phase 16: out-of-core EM on the card (see the module docstring)."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.io import FileSource, write_bin
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
    from cuda_gmm_mpi_tpu_torch.parallel.distributed import host_chunk_bounds
    from cuda_gmm_mpi_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    big = str(workdir / "events10m.bin")
    t0 = time.perf_counter()
    write_blobs_bin(big, seed, P16_EVENTS, DIMS, K_TARGET)
    write_s = time.perf_counter() - t0
    file_mib = os.path.getsize(big) / 2 ** 20
    print(f"  wrote {P16_EVENTS} x {DIMS} float32 events ({file_mib:.1f} MiB) "
          f"in {write_s:.1f} s; card: {card}")

    # (a) the fits, each arm in its own process; (b) rides the pipelined
    # arm; (c)'s 10M stepwise fit is the last arm.
    arms = {}
    for arm in P16_ARMS:
        arms[arm] = _p16_arm_subprocess(arm, big, str(workdir))
        a = arms[arm]
        print(json.dumps({"phase16": "a", "card": card,
                          **{k: v for k, v in a.items() if k != "sweep"}}))
    mem = arms["inmemory"]
    blocks = -(-P16_EVENTS // P16_CHUNK)
    for arm in ("inmemory", "resident", "pipelined", "resident_1m"):
        a = arms[arm]
        check(a["backend"] == "cuda", f"(a) {arm} backend {a['backend']}")
        passes = a["iters"] + a["ks"]
        per_pass = (1 if arm == "inmemory"
                    else -(-P16_EVENTS // a["chunk_size"]))
        check(a["launches"]["K1"] == per_pass * passes
              and a["launches"]["K2"] == a["iters"],
              f"(a) {arm}: K1 {a['launches']['K1']} for {passes} passes of "
              f"{per_pass} block(s), K2 {a['launches']['K2']} for "
              f"{a['iters']} M-steps")
        if arm != "inmemory":
            check(a["k"] == mem["k"] and a["merges"] == mem["merges"],
                  f"(a) {arm}: K {a['k']}, pairs {a['merges']} against the "
                  f"in-memory fit's {mem['k']}, {mem['merges']}")
            rel = abs(a["final_loglik"] - mem["final_loglik"]) / abs(
                mem["final_loglik"])
            check(rel <= 1e-4, f"(a) {arm}: loglik rtol {rel:.2e} > 1e-4")
            a["loglik_rtol_vs_inmemory"] = rel
    res = np.load(workdir / "resident.npz")
    pipe = np.load(workdir / "pipelined.npz")
    same = {k: bool(np.array_equal(res[k], pipe[k]))
            for k in ("means", "R", "pi", "loglik")}
    check(all(same.values()),
          f"(a) pipelined differs from resident: {same}")
    gap = (arms["resident"]["host_peak_above_base_mib"]
           - arms["pipelined"]["host_peak_above_base_mib"])
    check(gap >= 0.7 * file_mib,
          f"(a) pipelined host peak only {gap:.1f} MiB below resident's "
          f"(bar: 0.7 x {file_mib:.1f} MiB)")
    print(f"  (a) EM iterations/s after the first K: in-memory "
          f"{mem['rate_after_first_k']:.2f}, resident "
          f"{arms['resident']['rate_after_first_k']:.2f} (65,536-event "
          f"blocks, {blocks} per pass), pipelined "
          f"{arms['pipelined']['rate_after_first_k']:.2f}, resident at "
          f"1,048,576-event blocks "
          f"{arms['resident_1m']['rate_after_first_k']:.2f}; pipelined == "
          f"resident; host peak above baseline (MiB): in-memory "
          f"{mem['host_peak_above_base_mib']:.1f}, resident "
          f"{arms['resident']['host_peak_above_base_mib']:.1f}, pipelined "
          f"{arms['pipelined']['host_peak_above_base_mib']:.1f}; device "
          f"peak (MiB): in-memory {mem['device_peak_mib']:.1f}, resident "
          f"{arms['resident']['device_peak_mib']:.1f}, pipelined "
          f"{arms['pipelined']['device_peak_mib']:.1f}")
    prof = arms["pipelined"]["profile"]
    print(json.dumps({"phase16": "b", "card": card, **prof}))

    # (c) stepwise EM on 10M: steps/s and the distance from (a)'s full EM
    mb = arms["minibatch"]
    steps = mb["iters"]
    mb_blocks = P16_MB_SIZE // P16_CHUNK
    check(mb["launches"]["K1"] == steps * mb_blocks + mb["ks"] * blocks
          and mb["launches"]["K2"] == steps,
          f"(c) stepwise: K1 {mb['launches']['K1']}, K2 "
          f"{mb['launches']['K2']} for {steps} steps")
    eps10 = convergence_epsilon(P16_EVENTS, DIMS)
    dist10 = mb["final_loglik"] - arms["pipelined"]["final_loglik"]
    bar = stepwise_bar(workdir, seed)
    small = str(workdir / "events1m.bin")
    write_bin(small, data)
    rec_c = dict(card=card, steps_10m=steps,
                 steps_per_s_10m=steps / sum(r[4] for r in mb["sweep"]),
                 minibatch_10m=P16_MB_SIZE, k_10m=mb["k"],
                 loglik_minus_full_em_10m=dist10,
                 convergence_epsilon_10m=eps10, **bar)
    print(json.dumps({"phase16": "c", **rec_c}))

    # (d) stop at pass 3, block 7 of K = 100 and resume, pipelined, 1M
    cfg = dict(min_iters=P16_ITERS, max_iters=P16_ITERS,
               chunk_size=P16_CHUNK, stream_events=True, ingest="pipelined")

    def supervised(ck, spec=None):
        with faults.use(spec or {}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            try:
                return fit_gmm(FileSource(small), K0, P16_TARGET,
                               config=GMMConfig(checkpoint_dir=ck, **cfg)), 0
            except supervisor.PreemptedError as e:
                return e, supervisor.EX_TEMPFAIL
    ref, _ = supervised(str(workdir / "ck_ref"))
    stop, rc = supervised(str(workdir / "ck"), {"preempt": P16_PREEMPT})
    check(rc == 75 and stop.step == 0,
          f"(d) the stop gave exit {rc}, step {getattr(stop, 'step', None)}")
    subs = sorted((workdir / "ck" / "sweep").glob("*.iter*.npz"))
    check(len(subs) == 1, f"(d) sub-steps {subs}")
    with np.load(subs[0]) as z:
        where = (int(z["stream_pass"]), int(z["stream_block"]))
    check(where == (P16_PREEMPT["iter"], P16_PREEMPT["block"] + 1),
          f"(d) stopped at pass/block {where}")
    resumed, rc2 = supervised(str(workdir / "ck"))
    check(rc2 == 0 and _equal_fits(resumed, ref),
          "(d) the resumed fit differs from the uninterrupted one")
    rec_d = dict(card=card, exit=rc, stopped_at_pass_block=list(where),
                 em_iter=stop.em_iter, resumed_equal=True,
                 final_loglik=resumed.final_loglik)
    print(json.dumps({"phase16": "d", **rec_d}))

    # (e) a (2, 1) data mesh on the one card, pipelined, against one process
    one = fit_gmm(FileSource(small), K0, P16_TARGET, config=GMMConfig(**cfg))
    ranks = _p16_mesh(workdir)
    one_pairs = [list(m[1]) for m in one.merges]
    rec_e = dict(card=card, ranks=[])
    per_rank_blocks = host_chunk_bounds(data.shape[0], P16_CHUNK, 2, 0, 2)[2]
    for rk in ranks:
        passes = rk["iters"] + rk["ks"]
        check(rk["backend"] == "cuda"
              and rk["launches"]["K1"] == per_rank_blocks * passes
              and rk["launches"]["K2"] == rk["iters"],
              f"(e) rank {rk['rank']}: launches {rk['launches']} for "
              f"{passes} passes of {per_rank_blocks} blocks")
        check(rk["k"] == one.ideal_num_clusters and rk["merges"] == one_pairs,
              f"(e) rank {rk['rank']}: K {rk['k']}, pairs {rk['merges']} "
              f"against one process's {one.ideal_num_clusters}, {one_pairs}")
        rel = abs(rk["final_loglik"] - one.final_loglik) / abs(
            one.final_loglik)
        check(rel <= 1e-5, f"(e) rank {rk['rank']}: loglik rtol {rel:.2e}")
        rec_e["ranks"].append(dict(
            rank=rk["rank"], launches=rk["launches"], loglik_rtol=rel,
            host_range=rk["host_range"], ms_per_pass=1e3 * rk["em_s"] / passes,
            fit_s=rk["fit_s"]))
    print(json.dumps({"phase16": "e", **rec_e}))
    out = dict(arms=arms, b=prof, c=rec_c, d=rec_d, e=rec_e,
               file_mib=file_mib, write_s=write_s,
               wall_s=time.perf_counter() - t_phase)
    print(f"  phase 16 took {out['wall_s']:.1f} s; {card}")
    return out

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="phase 12 (a) also times the main path of the "
                    "checkout in DIR, in turns with this one")
    ap.add_argument("--rate-of", default=None, metavar="ROOT",
                    help=argparse.SUPPRESS)  # phase 12's subprocess mode
    # phase 16's subprocess mode: one arm of (a) on one file
    ap.add_argument("--p16-arm", default=None, choices=P16_ARMS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--p16-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p16-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.rate_of:
        print(json.dumps(rate_of(args.rate_of, args.seed)))
        return 0
    try:
        from cuda_gmm_mpi_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    if args.p16_arm:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(p16_arm(args.p16_arm, args.p16_file, args.p16_out)))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t_start = time.perf_counter()

    print("phase 1: build")
    t0 = time.perf_counter()
    cubin, clocks, extra = start_extra_builds()
    _build.build_all()
    instances = kernel_report(cubin, extra)
    print(f"  built {len(_build.SIGNATURES)} kernel libraries, the ptxas "
          f"report and the phase-clock build in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    for r in instances:
        hmma = "no cuobjdump" if r["hmma"] is None else f"{r['hmma']} HMMA"
        ctas = ("" if "ctas_card" not in r else
                f"; CTAs per SM at D={DIMS}: {r['ctas_by_registers']} by "
                f"registers, {r['ctas_by_smem']} by shared memory "
                f"({r['smem']} bytes), {r['ctas_card']} on the card, the "
                f"tile's {r['ctas_tile']}")
        print(f"  {r['instance']}: {r['registers']} "
              f"registers, {r['static_smem']} bytes static shared memory, "
              f"spills {r.get('spill_stores', 0)} / {r.get('spill_loads', 0)} "
              f"bytes (stores / loads), {hmma}{ctas}")

    print("phase 2: K1 against its plain version")
    data = make_blobs(args.seed, N_EVENTS, DIMS, K_TARGET)
    k1_full, (state_full, out_full) = phase_k1(data, False, (7, 50), "full",
                                               True, clocks=clocks)
    k1_diag, (state_diag, out_diag) = phase_k1(data, True, (7,), "diag", True,
                                               clocks=clocks)
    phase_k1(data[:999_997], False, (3,), "full ragged N=999997", False)
    far = make_blobs(args.seed + 1, N_EVENTS, DIMS, K_TARGET, spread=FAR)
    k1_far, _ = phase_k1(far, False, (7, 50), "full |x|~170", False, near=False)
    k1_far_diag, _ = phase_k1(far, True, (7,), "diag |x|~170", False,
                              near=False)
    del far

    print("phase 3: K2 against its plain version and the torch-ops M-step")
    k2_full = phase_k2(state_full, out_full, False, "full", args.seed)
    k2_diag = phase_k2(state_diag, out_diag, True, "diag", args.seed)

    print("phase 4: the main path")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        launches, main_result, main_io = phase_main_path(data, workdir)
        diag_ref = phase_diag(data)
        phase_small_reference(args.seed)
        em_profile = profile_em(data)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print("phase 5: K3 against K1 and its plain version; the batched EM loop")
    x_c, rows = restart_rows(data, args.seed)
    lanes_full = restart_lanes(x_c, rows, False)
    k3_full, k3_out = phase_k3(lanes_full, False, "full")
    phase_em_batched(lanes_full)
    lanes_diag = restart_lanes(x_c, rows, True)
    k3_diag, k3_out_diag = phase_k3(lanes_diag, True, "diag")

    print("phase 6: K4 against its plain version, K2 and the torch-ops M-step")
    k4_full = phase_k4(lanes_full[0], k3_out, False, "full", args.seed)
    k4_diag = phase_k4(lanes_diag[0], k3_out_diag, True, "diag", args.seed)
    del lanes_full, lanes_diag, k3_out, k3_out_diag, x_c

    print("phase 7: the restart path")
    restart_launches = phase_restarts(data)
    launches.update(K3=restart_launches["K3"], K4=restart_launches["K4"])

    print("phase 8: K5 and K6 against their plain versions and K1")
    k56 = {}
    for shards in (2, 4):
        for diag, name in ((False, "full"), (True, "diag")):
            k56[shards, diag] = phase_k5_k6(data, shards, diag,
                                            f"{name} C={shards}")
    for ks in (64, 65, 130):  # the 64-wide tile's edge; K1's kernel, 1 and 2 tiles
        for diag, name in ((False, "full"), (True, "diag")):
            k56[ks, diag] = phase_k5_k6(data[:RANK_EVENTS], 2, diag,
                                        f"{name} K_s={ks}", k=2 * ks)
    k5_diag, k6_diag = time_k5_k6(data, True, "diag", clocks)
    k5_full, k6_full = time_k5_k6(data, False, "full", clocks)
    # 'high' and 'default': K1's kernel in the K5/K6 modes for every shard.
    k56_bf16, k56_bf16_times = {}, {}
    for prec in BF16_PASSES:
        for diag, name in ((False, "full"), (True, "diag")):
            k56_bf16[prec, 50, diag] = phase_k5_k6(
                data, 2, diag, f"{name} C=2 {prec}", precision=prec)
            k56_bf16[prec, 130, diag] = phase_k5_k6(
                data[:RANK_EVENTS], 2, diag, f"{name} K_s=130 {prec}", k=260,
                precision=prec)
            k56_bf16_times[prec, diag] = time_k5_k6(
                data, diag, f"{name} {prec}", None, precision=prec)
    print(f"  full covariance on a cluster-sharded mesh routes to torch ops: "
          f"that route's statistics on one rank's shard (accumulate_stats, "
          f"its per-chunk collectives left out) {k6_full['torch_ops_ms']:.3f} "
          f"ms against K5 + K6 {k5_full['ms'] + k6_full['ms']:.3f} ms")

    print("phase 9: the mesh path on the one card")
    meshdir = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
    shutil.rmtree(meshdir, ignore_errors=True)
    meshdir.mkdir(parents=True)
    try:
        mesh = phase_mesh(data, diag_ref, meshdir)
    finally:
        shutil.rmtree(meshdir, ignore_errors=True)
    launches.update(K5=mesh["launches"]["K5"], K6=mesh["launches"]["K6"])

    print("phase 10: K1 and K3 in 'high' and 'default'; the main and restart "
          "paths at those precisions")
    prec_k1, prec_k3, prec_paths = {}, {}, {}
    for prec in BF16_PASSES:
        for diag, name, inactive in ((False, "full", (7, 50)),
                                     (True, "diag", (7,))):
            prec_k1[prec, diag], _ = phase_k1(
                data, diag, inactive, f"{name} {prec}", True, clocks=clocks,
                precision=prec)
    x_c, rows = restart_rows(data, args.seed)
    for diag, name in ((False, "full"), (True, "diag")):
        lanes_in = restart_lanes(x_c, rows, diag)
        for prec in BF16_PASSES:
            prec_k3[prec, diag], _ = phase_k3(lanes_in, diag, f"{name} {prec}",
                                              precision=prec)
        del lanes_in
    del x_c
    for prec in BF16_PASSES:
        prec_paths[prec] = phase_precision_path(data, prec,
                                                main_io["em_iters_per_s"])
        restart = phase_precision_restarts(data, prec)
        prec_paths[prec]["launches"].update(K3=restart["K3"], K4=restart["K4"])
    k5_err = max(v["k5_err"] for v in k56.values())
    k6_err = max(v["k6_err"] for v in k56.values())

    print("phase 11: GaussianMixture at the north-star shape: the four "
          "families, a BIC search, sample weights, inference and the CLI")
    estdir = Path(__file__).resolve().parent / "build" / "chip_smoke_estimator"
    shutil.rmtree(estdir, ignore_errors=True)
    estdir.mkdir(parents=True)
    try:
        estimator = phase_estimator(data, estdir, args.seed)
    finally:
        shutil.rmtree(estdir, ignore_errors=True)

    print("phase 12: containment and resume on the card")
    condir = Path(__file__).resolve().parent / "build" / "chip_smoke_contain"
    shutil.rmtree(condir, ignore_errors=True)
    condir.mkdir(parents=True)
    try:
        containment = phase_containment(data, main_result,
                                        main_io["em_iters_per_s"], condir,
                                        args.parent, args.seed)
    finally:
        shutil.rmtree(condir, ignore_errors=True)

    print("phase 13: the captured EM loop and the fused sweep")
    capdir = Path(__file__).resolve().parent / "build" / "chip_smoke_capture"
    shutil.rmtree(capdir, ignore_errors=True)
    capdir.mkdir(parents=True)
    try:
        capture = phase_capture(data, main_result, capdir)
    finally:
        shutil.rmtree(capdir, ignore_errors=True)

    print("phase 14: the fit's observability: the observed fit, its costs, "
          "--trace-dir and the port's stream tools")
    obsdir = Path(__file__).resolve().parent / "build" / "chip_smoke_observe"
    shutil.rmtree(obsdir, ignore_errors=True)
    obsdir.mkdir(parents=True)
    try:
        phase_observability(data, main_result, obsdir)
    finally:
        shutil.rmtree(obsdir, ignore_errors=True)

    print("phase 15: the mesh made whole: restarts on a mesh, preempt and "
          "resume, peer loss, per-rank reading and output")
    wholedir = Path(__file__).resolve().parent / "build" / "chip_smoke_whole"
    shutil.rmtree(wholedir, ignore_errors=True)
    wholedir.mkdir(parents=True)
    try:
        whole = phase_mesh_whole(data, wholedir, card)
    finally:
        shutil.rmtree(wholedir, ignore_errors=True)

    print("phase 16: out-of-core EM: in-memory, resident and pipelined "
          "streaming at 10M events, one pass profiled, stepwise EM, stop "
          "and resume, a data mesh")
    oocdir = Path(__file__).resolve().parent / "build" / "chip_smoke_ooc"
    shutil.rmtree(oocdir, ignore_errors=True)
    oocdir.mkdir(parents=True)
    try:
        ooc = phase_out_of_core(data, oocdir, card, args.seed)
    finally:
        shutil.rmtree(oocdir, ignore_errors=True)

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
             bound_by=k1_full["bound_by"],
             fp32_bound_ms=k1_full["fp32_bound_ms"],
             library_ms=k1_full["library_ms"],
             diag_ms=k1_diag["ms"], diag_plain_ms=k1_diag["plain_ms"],
             diag_library_ms=k1_diag["library_ms"],
             diag_bound_ms=k1_diag["bound_ms"],
             diag_fp32_bound_ms=k1_diag["fp32_bound_ms"],
             phase_shares=k1_full["phase_shares"],
             diag_phase_shares=k1_diag["phase_shares"], build=instances,
             main_path_io=main_io),
        dict(name="K2 mstep", route="cuda", source=src + "mstep.cu",
             replaces=pallas + "681", launches=launches["K2"],
             library_ms=None, **mstep_record(k2_full, k2_diag),
             em_profile=em_profile),
        dict(name="K3 fused_stats_batched", route="cuda",
             source=src + "fused_stats.cu", replaces=pallas + "475",
             launches=launches["K3"], max_abs_err=k3_full["max_abs_err"],
             fp64_err=k3_full["fp64_err"],
             plain_fp64_err=k3_full["plain_fp64_err"], ms=k3_full["ms"],
             all_live_ms=k3_full["all_live_ms"],
             k1_x4_ms=k3_full["k1_x4_ms"], plain_ms=k3_full["plain_ms"],
             bound_ms=k3_full["bound_ms"], bound_by=k3_full["bound_by"],
             fp32_bound_ms=k3_full["fp32_bound_ms"],
             library_ms=k3_full["library_ms"], diag_ms=k3_diag["ms"],
             diag_all_live_ms=k3_diag["all_live_ms"],
             diag_k1_x4_ms=k3_diag["k1_x4_ms"],
             diag_plain_ms=k3_diag["plain_ms"],
             diag_library_ms=k3_diag["library_ms"],
             diag_bound_ms=k3_diag["bound_ms"],
             diag_fp32_bound_ms=k3_diag["fp32_bound_ms"]),
        dict(name="K4 mstep_batched", route="cuda", source=src + "mstep.cu",
             replaces=pallas + "690", launches=launches["K4"],
             library_ms=None, **mstep_record(k4_full, k4_diag)),
        dict(name="K5 local_lse", route="cuda", source=src + "fused_stats.cu",
             replaces=pallas + "218", launches=launches["K5"],
             max_abs_err=k5_err,
             m_normwise_err=max(v["k5_m_err"] for v in k56.values()),
             s_normwise_err=max(v["k5_s_err"] for v in k56.values()),
             fp64_err=max(v["k5_fp64_err"] for v in k56.values()),
             plain_fp64_err=max(v["k5_plain_fp64_err"] for v in k56.values()),
             ms=k5_diag["ms"], plain_ms=k5_diag["plain_ms"],
             bound_ms=k5_diag["bound_ms"], bound_by=k5_diag["bound_by"],
             fp32_bound_ms=k5_diag["fp32_bound_ms"],
             library_ms=None, torch_ops_ms=k5_diag["torch_ops_ms"],
             full_ms=k5_full["ms"], full_plain_ms=k5_full["plain_ms"],
             full_bound_ms=k5_full["bound_ms"],
             full_fp32_bound_ms=k5_full["fp32_bound_ms"],
             full_torch_ops_ms=k5_full["torch_ops_ms"],
             mesh_breakdown_ms=mesh["breakdown_ms"]["K5"],
             **shard_record(k5_diag, k5_full, instances, "local_lse")),
        dict(name="K6 stats_logz", route="cuda", source=src + "fused_stats.cu",
             replaces=pallas + "235", launches=launches["K6"],
             max_abs_err=k6_err, ms=k6_diag["ms"], plain_ms=k6_diag["plain_ms"],
             bound_ms=k6_diag["bound_ms"], bound_by=k6_diag["bound_by"],
             fp32_bound_ms=k6_diag["fp32_bound_ms"],
             library_ms=None, torch_ops_ms=k6_diag["torch_ops_ms"],
             full_ms=k6_full["ms"], full_plain_ms=k6_full["plain_ms"],
             full_bound_ms=k6_full["bound_ms"],
             full_fp32_bound_ms=k6_full["fp32_bound_ms"],
             full_torch_ops_ms=k6_full["torch_ops_ms"],
             mesh_breakdown_ms=mesh["breakdown_ms"]["K6"],
             mesh_iteration_ms=mesh["em_s"] / mesh["iters"] * 1e3,
             mesh_fit_breakdown_ms=mesh["fit_breakdown_ms"],
             **shard_record(k6_diag, k6_full, instances, "stats_logz")),
    ]
    for prec in BF16_PASSES:
        kernels.append(precision_record(
            f"K1 fused_stats {prec}", pallas + "94",
            prec_paths[prec]["launches"]["K1"], prec_k1[prec, False],
            prec_k1[prec, True], main_path=prec_paths[prec]))
        kernels.append(precision_record(
            f"K3 fused_stats_batched {prec}", pallas + "475",
            prec_paths[prec]["launches"]["K3"], prec_k3[prec, False],
            prec_k3[prec, True]))
    for prec in BF16_PASSES:
        kernels.extend(shard_precision_records(
            prec, pallas, mesh["bf16"][prec], k56_bf16, k56_bf16_times))
    mesh_restart = [dict(rank=x["rank"], launches=x["launches"],
                         ms_per_batched_iteration=x["ms_per_batched_iteration"],
                         lane_iterations_per_s=x["lane_iterations_per_s"])
                    for x in whole["a"]["ranks"]]
    kernels[2]["mesh_restart"] = [dict(x, launches=x["launches"]["K3"])
                                  for x in mesh_restart]
    kernels[3]["mesh_restart"] = [dict(x, launches=x["launches"]["K4"])
                                  for x in mesh_restart]
    for i, key in ((4, "K5"), (5, "K6")):
        kernels[i]["mesh_restart"] = [dict(
            rank=x["rank"], launches=x["launches"][key],
            ms_per_lane_estep=x["ms_per_lane_estep"])
            for x in whole["e"]["ranks"]]
    # The streaming path (phase 16): each arm's K1/K2 launches counted
    # from 0 around its fit, K1's device time per 65,536-event block.
    stream_arms = {a: dict(launches=r["launches"],
                           em_iters_per_s=r["rate_after_first_k"],
                           chunk_size=r["chunk_size"])
                   for a, r in ooc["arms"].items()}
    kernels[0]["streaming"] = dict(
        arms=stream_arms, ms_per_block=ooc["b"]["k1_ms_per_block"],
        device_idle_share=ooc["b"]["device_idle_share"],
        mesh_ranks=[dict(rank=r["rank"], launches=r["launches"]["K1"],
                         ms_per_pass=r["ms_per_pass"])
                    for r in ooc["e"]["ranks"]])
    kernels[1]["streaming"] = {a: r["launches"]["K2"]
                               for a, r in ooc["arms"].items()}
    kernels[0]["estimator"] = estimator
    kernels[0]["containment"] = containment
    kernels[0]["capture"] = capture
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
    rc = 1
    try:
        rc = main()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
    finally:
        for name in stop_children():
            print(f"chip_smoke: stopped a process left running: {name}",
                  file=sys.stderr)
    sys.exit(rc)
