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
   shard kernel (K5/K6 on a shard of at most 64 clusters) and the narrow
   route's instances (K1/K3 at 'highest' with K <= 64, K_pad 16, 32 or 64)
   the CTAs per SM that its registers and its shared memory at D=24 allow,
   beside the card's occupancy calculator (which must fit the tile's CTAs
   per SM, for the shard kernel more than one); and with
   -DGMM_PHASE_CLOCKS, a library whose kernels count the cycles of their
   phases (phases 2 and 8 print each phase's share of one K1, K5 and K6
   launch); each phase's title line gives the seconds since the start;
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
   applies. Then the narrow route on the same events: K1 at K = 16 and 64
   and K3 at K = 16 (4 lanes, one frozen), full and diag, through their
   wrappers (K_pad 16 or 64) torch.equal to the same library's C entry at
   K_pad 128 on the operands padded to 128, in the plain version's class;
   both routes timed in turns on prebuilt operands, the bound at the real
   K, the plain time, and K1's phase shares at K = 16;
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
   K; every K1 launch on the narrow route; both walls); 3 restarts in one
   batch at K 16 -> 12 on the same events (K3 on its narrow route and K4)
   against the sequential driver (the same init, K and merge pairs, loglik
   rtol 1e-5; both walls); integer sample weights in {1, 2} against the replicated rows (same
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
   events at K = 100 -> 98 with 10 iterations per K in (a) and (e); (b)-(d)
   check a mechanism, not a rate, at K = 100 -> 99 with 5 iterations per
   K, and (g) with 5. (a) ``--n-init 4``
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
   the one-card batched fit (init, K, merge pairs, loglik rtol 1e-5). (g)
   The fused sweep (``ShardedGMMModel.make_fused_sweep``) on the (2, 1)
   mesh (K1/K2 per rank) and on a diag (1, 2) mesh (K5/K6 per rank, the
   order reduction over the gathered K-state; K 100 -> 92, phase 9's
   target: the diag fit empties clusters at K = 100 and would stop at 98
   after one K), each beside the host sweep on that mesh at
   ``sweep_k_buckets='off'``, in turns (fused, host, host, fused): the
   same K, Ks and merge pairs, loglik within rtol 1e-4; each rank's
   launches counted from 0 (K1 = iterations + Ks and K2 = iterations on
   (2, 1), K5 = K6 = iterations + Ks on (1, 2), no other), every sweep's
   wall. (h) Phase 19
   (f)'s 4 tenants on a (2, 1) mesh of a world of its own, 'scan' in
   groups of 2 (the first pair stopping at K = 6), under elastic recovery
   with ``rank_lost`` of rank 1 at step 4 of the second group: rank 1
   exits 75, rank 0 seals generation 1 and finishes; the first group is
   torch.equal to its sharded solo fits, the second has a one-process
   fleet's K and merge pairs, loglik within rtol 1e-5. One JSON line per
   part, each with the card's name and power limit.

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
   against 340 steps over a quarter of the events). (d) and (e) check a
   mechanism, not a rate, at K = 100 -> 99 with 5 iterations per K. (d) On
   phase 4's 1M events, pipelined: a ``preempt`` at pass 3, block 7 of
   K = 100 stops the fit (exit 75 in the CLI) with the partial
   accumulator in the sub-step, and the resumed fit == the uninterrupted
   one. (e) 2 ranks of
   a (2, 1) data mesh on the one card (gloo), each streaming its half of
   the 1M BIN pipelined: each rank's K1 launches (8 blocks per pass) and
   K2 launches, the one-process streaming fit's K and merge pairs with the
   loglik within rtol 1e-5, ms per pass per rank.

17. serving at full width (serving/, ops/kernels/score.py): phase 4's full
   fit (K 96, Kb 128) and its diag fit exported to a registry. (a) S1's
   bits: on a synthetic model (12 slots, 3 inactive; numpy, no fit) at Kb
   16 and 128, D 5 and 24, 1, 37, 4,096 and 20,000 rows (every register
   tile of csrc/score.cu), both forms, full and
   diag, float32 and float64, 'proba' and 'assign', the SHA-256 digest of
   its outputs' bytes must equal the first version's (``P17_BITS``, taken
   from commit 477d8c7 on the card). Then S1
   against its plain version (the torch-ops ``posteriors`` on the same
   card) and float64 on the same rows at blocks 1, 7, 256, 4096 and
   65,536, full and diag: against float64 S1's error at most twice the
   torch-ops path's (floored at 2^-20); against torch ops within max|dw|
   1e-4 and logZ 1e-5 normwise, which it may miss only where torch ops
   itself lies outside that class of float64 (``hold_stat``'s rule; S1
   accumulates in double); float64 S1 within 1e-12 (logZ normwise; w on
   the log-density scale); 'assign' equal to torch ops' argmax but on
   near-ties (counted); repeat launches bit-identical. S1's time per
   launch at 64 / 256 / 4,096 / 65,536 rows (the device time of 20
   launches replayed as one CUDA graph) beside torch ops and its bound. The
   same for S1's centered form (the 'centered' quad mode) against its
   plain version (``posteriors`` in that mode) and the float64 centered
   quadratic form (with the full Rinv: the diag ``posteriors`` expands
   x^2 in every mode). (b) The serving contracts with ``torch.equal`` on
   S1's route, at 'highest', 'high' and 'default' (S1 computes at
   'highest', inside both classes) and under 'centered' (its centered
   form), for the full and the diag model each: a split request
   (max_block 64 against 65,536, 300 and 70,000 rows), coalesced against
   solo requests (tests/test_torch_serving.py's mix, 10x the rows), the
   model stacked with a second state of its family against solo
   dispatches, a K-pad of Kb against 2 Kb, and a hot-reloaded route
   against the version loaded fresh; every executor's route must be S1,
   and the centered form's launches there are counted from 0; the same
   probes on the torch-ops route at 'highest' and on 'centered' are
   printed, not held.
   A graph replay against the eager launch per block, each capture's
   seconds, one warm ``infer`` on the host clock. (c) The warm path: two
   models served in process, blocks 256-16,384 warmed, then 1,000
   requests of 1-4,096 rows with mixed ops: no new capture, no host
   staging, S1 launched once per dispatch (counted from 0); the executor
   caches' device memory; the in-process server's p50/p99 latency and
   rows/s under 8 client threads at 64- and 1,024-row requests. (d) ``gmm
   serve --http 0 --workers 2 --device cuda`` as processes: JSON and
   x-gmm-rows answers equal the in-process server's bits, rows/s of each
   at 4,096-row requests, worker 0 SIGKILLed mid-stream with no failed
   request and its slot respawned, SIGTERM drains to exit 75, every
   child reaped. S1's bound is 2 (T+D) flops per (event, active cluster)
   (its centered form's 3 T + D: its products depend on the cluster) at
   the fp32 FMA peak against its bytes (x, the operands, w and logZ
   once), printed beside the same flops at the FP64 FMA rate (33.5
   TFLOP/s), the ceiling of its double chains; it has no PyTorch call
   that computes its function;
18. tuning and the lifecycle at full width (tuning/, lifecycle/), on
   phase 4's events written to a BIN and its K 96 full model. (a) ``gmm
   tune`` on the BIN at K = 100 (3 probe iterations): it must write a
   ``gpu|<card>|...`` row whose estep_backend candidates are torch and
   cuda, each timed by its fits' own EM walls (no fit resolves
   chunk_size on the card). (b) A fit with
   ``autotune='db'`` (K 100 -> 96, 20 iterations) must resolve
   estep_backend from that row and emit its ``tune`` records; its K and
   merge pairs must equal those of an untuned fit with the resolved knobs;
   an ``autotune='off'`` fit naming the DB must equal a fit without the
   fields, result and stream (clocks, heartbeats and compile events
   aside). (c) Serving block bounds measured into the DB (a 100-row
   request at min_block 32 and 64, a 65,536-row one at max_block 8,192 and
   16,384), then ``gmm serve --autotune db`` must reply byte for byte as
   ``--autotune off`` (six requests up to 30,000 rows). (d) The K 96 model
   served in process with a ``LifecycleController`` read from a policy
   file (retrain.data the BIN, max_rows 65,536, one 65,536-row block per
   stepwise step): shifted rows raise the drift alarm, and the arc runs
   retrain (K1, K2 and the holdout gates' S1 launches counted from 0
   around that tick), canary with a 2-tick shadow window (S1 counted),
   promote, watch, cooldown; the promoted version loads from the registry
   and scores; then ``canary_regression`` quarantines the next candidate
   with every reply unchanged byte for byte.
19. multi-tenant fleet fits (tenancy/): 48 tenants at D = 24, float32,
   20 iterations per K, in two packed groups (32 of 33,000-65,536 events at
   K = 16, 16 of 9,000-16,384 at K = 8; four with a target K), blobs from
   the seed. (a) K3's per-lane-events form on the first group's 32 lanes
   (one frozen), full and diag: every live lane torch.equal to K1 on its
   own rows, the frozen lane zeros, two launches equal, the plain
   version's class and twice its float64 error, also at 'high' and
   'default'; one launch timed beside K1 on each lane's rows, the plain
   version and the bound; at 'highest' its narrow route (K_pad 16) against
   the same C entry at K_pad 32, 64 and 128 on prebuilt operands,
   torch.equal, the four timed in turns. (b) ``fit_fleet`` in 'scan' (one captured
   program per lane): every tenant torch.equal to its solo ``fit_gmm`` at
   ``sweep_k_buckets='off'``; K1 = the lanes' iterations + initial
   E-steps (every K1 launch on the narrow route), K2 = the iterations;
   the fleet's wall beside the 48 solo fits'
   and the capture seconds; the second group again on the host loop
   (``_eager_em``), torch.equal, its wall beside the captured group's.
   (c) 'vmap': one launch of K3's per-lane form (on its narrow route) and
   one K4 launch per group iteration, no K1/K2, the solo fits' K and
   merge pairs, loglik within 1e-5, and how many lanes came out
   torch.equal to (b). (d) On the second group alone: ``nan_loglik`` on
   lane 1 drops that tenant and the others equal (b); a preempt at step 2,
   then its resume, equals (b). (e) ``gmm fleet`` on 4 BIN files with
   ``--registry``: each .summary byte-identical to the solo CLI's (at
   ``--sweep-k-buckets off``), ``gmm export --fleet`` 4/4. (f) A (2, 1)
   mesh of 2 ranks on the card (gloo): 4 tenants in 'scan', each
   torch.equal to the sharded solo fit, K1/K2 counted per rank. The kernels
   line gains a "K3 fused_stats_fleet (per-lane events)" record and a
   ``fleet`` sub-record on K1-K4, and three records of the narrow route
   (K1 from (b), K3 from phase 11's restarts, the per-lane form from (c)).

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
import io
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
FP64_FLOPS_PER_S = 33.5e12  # the FP64 FMA units (no tensor cores), H100 SXM
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


_T0 = time.perf_counter()
_PHASE: dict = {}  # the running phase's title and start


def phase_start(title: str) -> None:
    """A phase's title line, with the seconds since the script started,
    after the seconds the phase before it took."""
    phase_end()
    _PHASE.update(title=title, t=time.perf_counter())
    print(f"{title} [{_PHASE['t'] - _T0:.0f} s in]")


def phase_end() -> None:
    """The running phase's seconds, once."""
    if _PHASE:
        name = _PHASE.pop("title").split(":")[0]
        print(f"  {name} took {time.perf_counter() - _PHASE.pop('t'):.1f} s")


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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph (their launches held off the counters), the graph's replays
    timed with CUDA events, so no host launch cost is in the figure."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels.counts import held_launches

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with held_launches():
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


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
    (else None); for the shard kernel and the narrow route's instances
    also the CTAs per SM that its registers, its shared memory at D=DIMS
    (the mesh cell's and the fleet's) and the card's occupancy calculator
    allow. Call after the libraries are built."""
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
        m = (re.search(r"fused_stats_kernelILi(\d)ELb([01])ELi(\d+)ELi(\d)"
                       r"ELi(\d+)E", name)
             or re.search(r"shard_kernelILi(\d)ELb([01])EE", name))
        check(m is not None and "registers" in rec,
              f"unparsed ptxas report for {name}: {rec}")
        mode, diag = m.group(1), m.group(2) == "1"
        width = "diag" if diag else "full"
        if "shard_kernel" not in name:
            prec = ("", " high", " default")[int(m.group(4))]
            w = int(m.group(5))
            if w < fs.TILE:  # the narrow route: its CTAs per SM at D=DIMS
                tile = fs.stats_tile(w, DIMS, diag)
                regs = -(-rec["registers"] // REG_UNIT) * REG_UNIT
                card = ctypes.c_int(0)
                check(lib.gmm_stats_occupancy(w, DIMS, int(diag), tile.bt,
                                              ctypes.addressof(card)) == 0,
                      "gmm_stats_occupancy failed")
                rec.update(
                    ctas_by_registers=SM_REGISTERS // (regs * THREADS),
                    ctas_by_smem=fs.SM_SMEM_BYTES // (
                        tile.smem + rec["static_smem"]
                        + fs.CTA_RESERVED_SMEM),
                    ctas_card=card.value, ctas_tile=tile.ctas_per_sm,
                    smem=tile.smem)
                check(card.value >= tile.ctas_per_sm,
                      f"narrow instance {name}: {card.value} CTAs per SM fit "
                      f"on the card, the tile counts on {tile.ctas_per_sm}")
            out.append(dict(instance=f"{KERNEL_MODES[mode]} {width} "
                            f"{m.group(3)}-row tiles{prec}"
                            + (f" narrow W={w}" if w < fs.TILE else ""),
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
    # tiles), 24 in 'high'/'default' (K1/K3, K5 and K6 alike), 6 on the
    # narrow route (K1/K3 at W = 16, 32, 64 x full/diag, 128-row chunks), 4
    # of the shard kernel.
    check(len(out) == 46, f"{len(out)} kernel instances reported")
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


NARROW_KS = (16, 64)  # phase 2's narrow-route case: K1 at these K (W = K)


def in_turns(*fns, reps: int = 10) -> tuple:
    """The CUDA-event times of routes of one function, in turns (a, b, ...,
    then back: ..., b, a); each the mean of its two turns."""
    times = [time_ms(f, reps) for f in fns + fns[::-1]]
    return tuple((a + b) / 2 for a, b in zip(times, times[::-1]))[:len(fns)]


def narrow_routes(A, h, g, k, d, diag):
    """The narrow route's tile and operands (K_pad W) and the 128-wide
    route's for the same parameters."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    tile = fs.stats_tile(k, d, diag)
    check(tile.k_pad < fs.TILE, f"K = {k}: K_pad {tile.k_pad}, not narrow")
    return ((tile, fs._ext_operands(A, h, g, d, diag, tile.k_pad)[:2]),
            (fs.wide_tile(k, d, diag),
             fs._ext_operands(A, h, g, d, diag, fs.TILE)[:2]))


def hold_class(label, out, ref) -> float:
    """Each output within the phase-2 class of its plain version; returns
    the largest |out - ref|."""
    import torch

    worst = 0.0
    for name, a, b in zip(("ll", "nk", "m1", "m2"), out, ref):
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite {name}")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rtol, atol = TOL[name]
        check(err <= atol + rtol * scale,
              f"{label}: {name} max|err| {err:.3e} > {atol} + {rtol} x "
              f"{scale:.3e}")
        worst = max(worst, err)
    return worst


def phase_k1_narrow(x_np, diag, k, label, clocks=None) -> dict:
    """K1 at K <= 64 on the main path's events: the wrapper (the narrow
    route, K_pad W) against the same library's C entry at K_pad 128 on the
    operands padded to 128, torch.equal; its plain version's class; both
    routes timed in turns on prebuilt operands, the bound at the real K,
    and (with the ``clocks`` library) the narrow route's phase shares."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    _, _, _, args = stats_inputs(x_np, k, diag, (k // 2,))
    x, wt, A, h, g = args
    n, d = x.shape
    (tile, ops_n), (wide, ops_w) = narrow_routes(A, h, g, k, d, diag)
    run_n = lambda: fs._launch_k1(x, wt, *ops_n, k, diag, tile, "highest")
    run_w = lambda: fs._launch_k1(x, wt, *ops_w, k, diag, wide, "highest")
    before = (fs.fused_stats.launches, fs.fused_stats_narrow.launches)
    out = fs.fused_stats(*args, diag=diag)
    check((fs.fused_stats.launches, fs.fused_stats_narrow.launches)
          == (before[0] + 1, before[1] + 1),
          f"K1 {label}: the wrapper did not take the narrow route")
    ref_w = run_w()
    plain = functools.partial(fs.fused_stats_plain, *args, diag=diag)
    ref = plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, ref_w)),
          f"K1 {label}: K_pad {tile.k_pad} differs from K_pad 128")
    rec = {"k": k, "k_pad": tile.k_pad, "max_abs_err": hold_class(
        f"K1 {label}", out, ref), "equal_to_wide": True, "library_ms": None}
    rec["ms"], rec["wide_ms"] = in_turns(run_n, run_w)
    rec["plain_ms"] = time_ms(plain, reps=2)
    f, t = A.shape[0], d if diag else d * (d + 1) // 2
    nbytes = 4 * (n * d + n + A.numel() + h.numel() + g.numel()
                  + 1 + k + k * d + k * f)
    rec.update(route_bound(nbytes, 2.0 * n * k * (t + d),
                           2.0 * n * k * (t + d + 1)))
    print(f"  K1 {label}: K_pad {tile.k_pad} torch.equal to K_pad 128; "
          f"max|K1 - plain| {rec['max_abs_err']:.3e}; {rec['ms']:.3f} ms "
          f"against the 128-wide route's {rec['wide_ms']:.3f} ms (in turns),"
          f" plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    if clocks is not None:
        rec["phase_shares"] = phase_shares(clocks, run_n)
        print(f"  K1 {label} phases (thread-0 cycles of every CTA): "
              + shares_line(rec["phase_shares"]))
    return rec


def phase_k3_narrow(x_np, diag, k, label) -> dict:
    """K3 at K <= 64 on the main path's events: LANES lanes (the state of
    :func:`phase_k1_narrow` with one more cluster inactive per lane, lane
    FROZEN frozen) through the wrapper against the C entry at K_pad 128,
    torch.equal; the plain class; both routes timed in turns; the bound
    over the live lanes."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    state, _, _, (x, wt, _, _, _) = stats_inputs(x_np, k, diag, (k // 2,))
    n, d = x.shape
    params = []
    for r in range(LANES):
        active = state.active.clone()
        active[r % k] = r == 0
        params.append(fs._prep_params(state.replace(active=active), d, diag))
    A, h, g = (torch.stack(p) for p in zip(*params))
    lanes = torch.ones(LANES, dtype=torch.float32, device="cuda")
    lanes[FROZEN] = 0.0
    (tile, ops_n), (wide, ops_w) = narrow_routes(A, h, g, k, d, diag)
    run_n = lambda: fs._launch_k3(x, wt, lanes, *ops_n, k, diag, tile,
                                  "highest")
    run_w = lambda: fs._launch_k3(x, wt, lanes, *ops_w, k, diag, wide,
                                  "highest")
    before = fs.fused_stats_batched_narrow.launches
    out = fs.fused_stats_batched(x, wt, lanes, A, h, g, diag=diag)
    check(fs.fused_stats_batched_narrow.launches == before + 1,
          f"K3 {label}: the wrapper did not take the narrow route")
    ref_w = run_w()
    plain = functools.partial(fs.fused_stats_batched_plain, x, wt, lanes, A,
                              h, g, diag=diag)
    ref = plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, ref_w)),
          f"K3 {label}: K_pad {tile.k_pad} differs from K_pad 128")
    check(not any(bool(o[FROZEN].any()) for o in out),
          f"K3 {label}: frozen lane {FROZEN} is not all zeros")
    rec = {"k": k, "k_pad": tile.k_pad, "lanes": LANES, "max_abs_err":
           hold_class(f"K3 {label}", out, ref), "equal_to_wide": True,
           "library_ms": None}
    rec["ms"], rec["wide_ms"] = in_turns(run_n, run_w)
    rec["plain_ms"] = time_ms(plain, reps=2)
    live = LANES - 1
    f, t = A.shape[1], d if diag else d * (d + 1) // 2
    nbytes = 4 * (n * d + n + LANES + A.numel() + h.numel() + g.numel()
                  + live * (1 + k + k * d + k * f))
    rec.update(route_bound(nbytes, 2.0 * live * n * k * (t + d),
                           2.0 * live * n * k * (t + d + 1)))
    print(f"  K3 {label}: {LANES} lanes (lane {FROZEN} frozen, zeros) at "
          f"K_pad {tile.k_pad} torch.equal to K_pad 128; max|K3 - plain| "
          f"{rec['max_abs_err']:.3e}; {rec['ms']:.3f} ms against the 128-wide "
          f"route's {rec['wide_ms']:.3f} ms (in turns), plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec


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
RESTART_INITS = 3  # phase 11's restart fit at K 16 (K3's narrow route)


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

    # --- the criterion: a BIC search down to K = 1 on 8 seeded blobs (K1
    # on its narrow route: K <= 16)
    small = make_blobs(seed + 2, 200_000, DIMS, 8)
    picks, walls = [], []
    narrow = fs.fused_stats_narrow.launches
    for backend in ("auto", "torch"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm = GaussianMixture(16, criterion="bic", min_iters=10, max_iters=10,
                             estep_backend=backend).fit(small)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        picks.append(gm)
        if backend == "auto":
            narrow = fs.fused_stats_narrow.launches - narrow
    _same_fit(picks[0], picks[1], "bic search kernels vs torch ops",
              pairs=False)
    iters = sum(r[3] for r in picks[0].result_.sweep_log)
    n_k = len(picks[0].result_.sweep_log)
    check(narrow == iters + n_k,
          f"bic search: {narrow} narrow K1 launches for {iters} iterations "
          f"+ {n_k} initial E-steps")
    out["bic_k"] = picks[0].n_components_
    out["bic"] = dict(fit_s=walls[0], torch_ops_fit_s=walls[1],
                      narrow_k1_launches=narrow)
    print(f"  criterion bic, K 16 -> 1 on 200,000 events of 8 blobs: K "
          f"{picks[0].n_components_} on the kernels and on torch ops; "
          f"{narrow} K1 launches, all on the narrow route; fit "
          f"{walls[0]:.2f} s (torch ops {walls[1]:.2f} s)")
    del picks

    # --- restarts at K <= 64: 3 inits in one batch (K3 on its narrow
    # route, K4) against the sequential driver (K1, K2), K 16 -> 12
    rfits, walls, counts = [], [], []
    for batch in (RESTART_INITS, 1):
        before = (fs.fused_stats_batched_narrow.launches,
                  fs.fused_stats_narrow.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rfits.append(GaussianMixture(16, 12, min_iters=10, max_iters=10,
                                    n_init=RESTART_INITS,
                                    restart_batch_size=batch).fit(small))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append((fs.fused_stats_batched_narrow.launches - before[0],
                       fs.fused_stats_narrow.launches - before[1]))
    bat, seq = (f.result_ for f in rfits)
    steps = len(bat.sweep_log)
    check(counts[0][0] == 11 * steps and counts[1][0] == 0,
          f"restarts at K 16: narrow K3 launches {counts} for {steps} Ks")
    check(bat.init_index == seq.init_index
          and [m[1] for m in bat.merges] == [m[1] for m in seq.merges]
          and abs(bat.final_loglik - seq.final_loglik)
          <= 1e-5 * abs(seq.final_loglik),
          f"restarts at K 16: batched init {bat.init_index}, K "
          f"{bat.ideal_num_clusters}, loglik {bat.final_loglik} against the "
          f"sequential driver's {seq.init_index}, {seq.ideal_num_clusters}, "
          f"{seq.final_loglik}")
    out["restarts_k16"] = dict(fit_s=walls[0], sequential_fit_s=walls[1],
                               narrow_k3_launches=counts[0][0],
                               sequential_narrow_k1_launches=counts[1][1])
    print(f"  restarts at K 16 -> 12 ({RESTART_INITS} inits, one batch): "
          f"{counts[0][0]} K3 launches on the narrow route; the sequential "
          f"driver's init {seq.init_index}, K and merge pairs, loglik within "
          f"1e-5; fit {walls[0]:.2f} s against {walls[1]:.2f} s sequential")
    del small, rfits

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
# (b)-(d) and (g) check a mechanism (a stop and its resume, a lost peer,
# the CLI's bytes, the fused sweep's choices), not a rate: 5 iterations
# per K, and one merge in (b)-(d) (K 100 -> 99); (g) keeps K 100 -> 98.
P15_CHECK_ITERS, P15_CHECK_TARGET = 5, K0 - 1
# (g)'s diag case stops at phase 9's K 92: the diag fit empties clusters at
# K = 100, and a stop at 98 would end the sweep after its first K.
P15_DIAG_TARGET = DIAG_TARGET
P15_LANES, P15_PEER_TIMEOUT_S = 4, 5.0
P15_TIMEOUT_S = 420
# (h): phase 19 (f)'s 4 tenants in 2 groups of 2, the first pair stopping at
# K = 6 (3 sweep steps), so that rank 1's loss at step 4 lands in the
# second group.
P15_FLEET_TARGET, P15_FLEET_LOST = 6, {"rank_lost": {"iter": 4, "rank": 1}}


def _p15_cfg(iters=P15_ITERS, **kw):
    from cuda_gmm_mpi_tpu_torch import GMMConfig

    return GMMConfig(min_iters=iters, max_iters=iters, **kw)


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
                r = fit_gmm(data, K0, P15_CHECK_TARGET, config=_p15_cfg(
                    P15_CHECK_ITERS, **cfg))
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
        # (g) the fused sweep on (2, 1) (K1/K2 per rank) and on a diag
        # (1, 2) mesh (K5/K6 per rank, the gathered order reduction), each
        # beside the host sweep on that mesh at its fixed width, in turns.
        report["g"] = {}
        for mesh, diag, target in (((2, 1), False, P15_TARGET),
                                   ((1, 2), True, P15_DIAG_TARGET)):
            arms = {"fused": [], "host": []}
            for arm in ("fused", "host", "host", "fused"):
                kw = (dict(fused_sweep=True) if arm == "fused"
                      else dict(sweep_k_buckets="off"))
                for c in counters.values():
                    c.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fit_gmm(data, K0, target, config=_p15_cfg(
                    P15_CHECK_ITERS, mesh_shape=mesh, diag_only=diag, **kw))
                torch.cuda.synchronize()
                arms[arm].append(dict(
                    _p15_summary(r), wall_s=time.perf_counter() - t0,
                    launches={k: c.launches for k, c in counters.items()},
                    backend=r.model.estep_backend))
            report["g"][f"{mesh[0]}x{mesh[1]}"] = arms
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
    args = [str(K0), infile, str(workdir / out), str(P15_CHECK_TARGET),
            f"--min-iters={P15_CHECK_ITERS}",
            f"--max-iters={P15_CHECK_ITERS}", "--dtype=float64"]
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


def _p15_world(fn, world: int, workdir: Path, *args) -> None:
    """``fn(rank, world, workdir, *args)`` on ``world`` spawned ranks,
    joined within ``P15_TIMEOUT_S``; a rank that fails, dies or outlives
    it fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, str(workdir), *args),
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


def p15_fleet_tenants(seed: int) -> list:
    """(h)'s tenants: phase 19 (f)'s four, the first pair's target K 6."""
    tenants = p19_tenants(seed, only=range(32, 32 + P19_MESH))
    return [dataclasses.replace(t, target_num_clusters=P15_FLEET_TARGET)
            if i < 2 else t for i, t in enumerate(tenants)]


def _p15_fleet_rank(rank, world, workdir, seed):
    """(h): one rank of a (2, 1) mesh on the card: the first pair's sharded
    solo fits, then the fleet ('scan', groups of 2) under elastic recovery
    with rank 1 lost at step 4 of the second group. Writes
    fleet_rank<r>.json: rank 0's outcome and results, rank 1's exit."""
    import torch

    from cuda_gmm_mpi_tpu_torch import fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.parallel import distributed, elastic
    from cuda_gmm_mpi_tpu_torch.tenancy import fit_fleet
    from cuda_gmm_mpi_tpu_torch.testing import faults

    workdir = Path(workdir)
    distributed.initialize("cuda", coordinator=f"file://{workdir}/store_h",
                           num_processes=world, process_id=rank,
                           timeout_s=P15_TIMEOUT_S)
    try:
        tenants = p15_fleet_tenants(seed)
        cfg = p19_config(mesh_shape=(2, 1), chunk_size=P19_MESH_CHUNK,
                         fleet_group_size=2)
        solo = [fit_gmm(t.data, t.num_clusters, t.target_num_clusters,
                        config=cfg) for t in tenants[:2]]
        _zero_fleet_counts()
        rec = dict(rank=rank)
        with faults.use(P15_FLEET_LOST), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                fleet = fit_fleet(tenants, dataclasses.replace(
                    cfg, checkpoint_dir=str(workdir / "ck_h"), elastic=True,
                    elastic_backoff_s=0.0))
            except supervisor.PeerLostError as e:
                rec.update(rc=supervisor.EX_TEMPFAIL, error=str(e))
            else:
                torch.cuda.synchronize()
                res = [fleet[t.name].result for t in tenants]
                rec.update(
                    rc=0, wall_s=time.perf_counter() - t0,
                    groups=[fleet[t.name].group for t in tenants],
                    first_same=[_same_result(r, s)
                                for r, s in zip(res, solo)],
                    second=[dict(k=r.ideal_num_clusters,
                                 merges=[list(m[1]) for m in r.merges],
                                 final_loglik=r.final_loglik)
                            for r in res[2:]],
                    world=list(elastic.world()),
                    generation=elastic.generation(),
                    launches=_fleet_counts())
        (workdir / f"fleet_rank{rank}.json").write_text(json.dumps(rec))
    finally:
        distributed.shutdown()


def phase_mesh_whole(data, workdir: Path, card: str, seed: int) -> dict:
    """Phase 15: restarts on a mesh, preempt and resume, peer loss and
    per-rank I/O, the fused sweep on a mesh and a fleet's elastic shrink,
    on 2 ranks sharing the one card over gloo."""
    import torch

    from cuda_gmm_mpi_tpu_torch import fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.io import write_bin
    from cuda_gmm_mpi_tpu_torch.tenancy import fit_fleet

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
    _p15_world(_p15_rank_main, world, workdir)
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

    # (g)
    rec_g = {"card": card}
    for key, kernels in (("2x1", ("K1", "K2")), ("1x2", ("K5", "K6"))):
        rows = []
        for rk in ranks:
            g = rk["g"][key]
            for f in g["fused"]:
                lc = f["launches"]
                iters = sum(row[3] for row in f["sweep"])
                e_steps = iters + len(f["sweep"])
                want = ({"K1": e_steps, "K2": iters} if key == "2x1"
                        else {"K5": e_steps, "K6": e_steps})
                check(f["backend"] == "cuda" and len(f["sweep"]) > 1
                      and all(lc[k] == v > 0 for k, v in want.items())
                      and all(v == 0 for k, v in lc.items() if k not in want),
                      f"(g) {key} rank {rk['rank']}: fused sweep launches "
                      f"{lc} over {len(f['sweep'])} Ks, expected {want} and "
                      f"no other")
            h, f = g["host"][-1], g["fused"][-1]
            for x in g["fused"] + g["host"]:
                check(x["k"] == h["k"] and x["merges"] == h["merges"]
                      and [r[0] for r in x["sweep"]]
                      == [r[0] for r in h["sweep"]],
                      f"(g) {key} rank {rk['rank']}: K {x['k']}, pairs "
                      f"{x['merges']} against the host sweep's {h['k']}, "
                      f"{h['merges']}")
            rel = abs(f["final_loglik"] - h["final_loglik"]) / abs(
                h["final_loglik"])
            check(rel <= 1e-4, f"(g) {key} rank {rk['rank']}: loglik rtol "
                  f"{rel:.2e} > 1e-4")
            rows.append(dict(
                rank=rk["rank"], launches=f["launches"],
                host_launches=h["launches"], loglik_rtol=rel,
                fused_wall_s=[x["wall_s"] for x in g["fused"]],
                host_wall_s=[x["wall_s"] for x in g["host"]],
                k=f["k"], ks=[r[0] for r in f["sweep"]], merges=f["merges"]))
        rec_g[key] = rows
        print(f"  (g) {key} ({'/'.join(kernels)}): fused sweep walls "
              f"{[[round(w, 3) for w in r['fused_wall_s']] for r in rows]} "
              f"s, host sweep (off) "
              f"{[[round(w, 3) for w in r['host_wall_s']] for r in rows]} s "
              f"(turns: fused, host, host, fused); launches "
              f"{[r['launches'] for r in rows]}; Ks {rows[0]['ks']}, K "
              f"{rows[0]['k']}, pairs {rows[0]['merges']}")
    out["g"] = rec_g
    print(json.dumps({"phase15": "g", **rec_g}))

    # (h) on a world of its own (its shrink leaves it), before (d)'s CLI
    _p15_world(_p15_fleet_rank, world, workdir, seed)
    fr = [json.loads((workdir / f"fleet_rank{r}.json").read_text())
          for r in range(world)]
    check([x["rc"] for x in fr] == [0, 75],
          f"(h) exits {[x['rc'] for x in fr]}: {fr[0].get('error')}")
    h0 = fr[0]
    check(h0["groups"] == [0, 0, 1, 1] and h0["world"] == [0, 1]
          and h0["generation"] == 1,
          f"(h) groups {h0['groups']}, world {h0['world']}, generation "
          f"{h0['generation']}")
    check(all(h0["first_same"]), f"(h) the first group differs from its "
          f"sharded solo fits: {h0['first_same']}")
    tenants = p15_fleet_tenants(seed)
    clean = fit_fleet(tenants[2:], p19_config(chunk_size=P19_MESH_CHUNK,
                                              fleet_group_size=2))
    rels = []
    for t, x in zip(tenants[2:], h0["second"]):
        r = clean[t.name].result
        pairs = [list(m[1]) for m in r.merges]
        check(x["k"] == r.ideal_num_clusters and x["merges"] == pairs,
              f"(h) {t.name}: K {x['k']}, pairs {x['merges']} against the "
              f"one-process fleet's {r.ideal_num_clusters}, {pairs}")
        rels.append(abs(x["final_loglik"] - r.final_loglik)
                    / abs(r.final_loglik))
        check(rels[-1] <= 1e-5, f"(h) {t.name}: loglik rtol {rels[-1]:.2e}")
    rec_h = {"card": card, "exits": [x["rc"] for x in fr],
             "fleet_wall_s": h0["wall_s"], "launches": h0["launches"],
             "second_group_loglik_rtol": rels}
    out["h"] = rec_h
    print(json.dumps({"phase15": "h", **rec_h}))

    # (b)
    b = [rk["b"] for rk in ranks]
    for rk, x in zip(ranks, b):
        st = [(s["rc"], s["step"], s["em_iter"]) for s in x["stops"]]
        check(st == [(75, 0, 4), (75, 1, 4)],
              f"(b) rank {rk['rank']}: stops (exit, step, iteration) {st}")
        # The merge of K = 100 was made before the stop in K = 99: the
        # resumed fit's own merges are the rest.
        ref = dict(x["ref"], merges=x["ref"]["merges"][1:])  # none left
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
        one = _p15_summary(fit_gmm(data, K0, P15_CHECK_TARGET, config=_p15_cfg(
            P15_CHECK_ITERS, checkpoint_dir=str(workdir / "ck_c1"),
            elastic=True, preempt_poll_iters=1, sweep_k_buckets="off")))
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
# (d) and (e) check a mechanism (a stop inside a pass and its resume, a
# data mesh's choices), not a rate: K 100 -> 99 at 5 iterations per K.
P16_CHECK_ITERS, P16_CHECK_TARGET = 5, K0 - 1
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
        r = fit_gmm(FileSource(str(workdir / "events1m.bin")), K0,
                    P16_CHECK_TARGET, config=GMMConfig(
                        min_iters=P16_CHECK_ITERS, max_iters=P16_CHECK_ITERS,
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
    cfg = dict(min_iters=P16_CHECK_ITERS, max_iters=P16_CHECK_ITERS,
               chunk_size=P16_CHUNK, stream_events=True, ingest="pipelined")

    def supervised(ck, spec=None):
        with faults.use(spec or {}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            try:
                return fit_gmm(FileSource(small), K0, P16_CHECK_TARGET,
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
    one = fit_gmm(FileSource(small), K0, P16_CHECK_TARGET,
                  config=GMMConfig(**cfg))
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

# ---------------------------------------------------------------- phase 17

P17_BLOCKS = (1, 7, 256, 4096, 65536)  # (a)'s request blocks
P17_TIMED = (64, 256, 4096, 65536)  # S1's timed blocks; graph vs eager
# (a)'s float32 bars, as ``hold_stat``'s: against float64 S1 may err at
# most P17_FP64_FACTOR x the torch-ops ``posteriors``' error on the same
# card, floored at 2^-20 (8 float32 ulps of 1); against the torch-ops path
# the float32 reassociation class (P17_W_BAR, P17_Z_BAR), which it may miss
# only where the torch-ops path itself lies outside that class of float64
# (the expanded form's |x|^2 cancellation; S1 accumulates in double).
P17_W_BAR, P17_Z_BAR = 1e-4, 1e-5  # max |dw|; normwise dlogZ
P17_FP64_FACTOR, P17_FP64_FLOOR = 2.0, 2.0 ** -20
# S1 at float64 against float64 ``posteriors`` (two float64 orders): logZ
# normwise, w on the log-density scale (w's error is logp's absolute error,
# so the bar is 1e-12 x max(1, max |logZ|)).
P17_F64_BAR = 1e-12
P17_WARM_REQUESTS = 1000
P17_WARM_BLOCKS = tuple(256 << i for i in range(7))  # 256 .. 16384
P17_THREADS = 8
# (b)'s serving families: S1 at each precision in the expanded form, and
# its centered form
P17_FAMILIES = (("highest", dict(matmul_precision="highest")),
                ("high", dict(matmul_precision="high")),
                ("default", dict(matmul_precision="default")),
                ("centered", dict(quad_mode="centered")))
# (a)'s bit check: S1 on a synthetic model of P17_BITS_K slots, those in
# P17_BITS_OFF inactive, at every (Kb, D, rows) below, both forms, full and
# diag, float32 and float64, 'proba' and 'assign'. The model and rows are
# made from uniform draws with + - * only (no libm, no BLAS), so they have
# the same bits on every host.
P17_BITS_K, P17_BITS_OFF = 12, (3, 7, 10)
# 20,000 rows at Kb 128 take the expanded form's wide register tile
P17_BITS_KB, P17_BITS_D = (16, 128), (5, 24)
P17_BITS_ROWS = (1, 37, 4096, 20000)
# The digests of the first version of csrc/score.cu (commit 477d8c7),
# taken on an NVIDIA H100 80GB HBM3 (700 W) by ``p17_bits_digests``.
P17_BITS = {
    "expanded full float32 proba kb16 d5":
        "4b8d7338add67a436ea7d19d0c2d2f03d4ac94c3fd2de277517a8d72c020f602",
    "expanded full float32 proba kb16 d24":
        "8656083d112c6fd11216709ac2de64999ba2df884cbea10cc8e97ec7d4dee5d8",
    "expanded full float32 proba kb128 d5":
        "6b766d5ae7db92eb417cabe33572fe84c0cecf4bd488eebff080c54a09ae791d",
    "expanded full float32 proba kb128 d24":
        "92a44a1ec55b373c44e91e1428500692d78e4d9ca34d8161937c74d378a1728e",
    "expanded full float32 assign kb16 d5":
        "32f9edbf9e34bb8f18454666750a7a4c8207f46bc1c3f88cb67fad9279ffbf82",
    "expanded full float32 assign kb16 d24":
        "7eea5be4a897915f76bf67d71801b2fe9ce8e4452d153b420aed529055218648",
    "expanded full float32 assign kb128 d5":
        "32f9edbf9e34bb8f18454666750a7a4c8207f46bc1c3f88cb67fad9279ffbf82",
    "expanded full float32 assign kb128 d24":
        "7eea5be4a897915f76bf67d71801b2fe9ce8e4452d153b420aed529055218648",
    "expanded full float64 proba kb16 d5":
        "a791ae856c8afad744648e0c373ebac434e3bf935739df0713caf7e8eb2e2900",
    "expanded full float64 proba kb16 d24":
        "b8b08c58395c23172d203d7e0974a9027a3240615554deae49bf6204713b748a",
    "expanded full float64 proba kb128 d5":
        "b1f046a068c46ffc06727716650451af34861f760ce87b8b4df569ee55ba4969",
    "expanded full float64 proba kb128 d24":
        "352c6f67444803aa4afc1d8cdca43206b66d8be53e0799272ffbfb722b375e1f",
    "expanded full float64 assign kb16 d5":
        "0ff7aa19c3276cab83c307c275cccaaa51fc9d78ab2a72e73bfeee0ceb3030dd",
    "expanded full float64 assign kb16 d24":
        "2773b549a726b8273ad3e5b4e63be3c9df21ac934a0f064fcd9d599be49fa31a",
    "expanded full float64 assign kb128 d5":
        "0ff7aa19c3276cab83c307c275cccaaa51fc9d78ab2a72e73bfeee0ceb3030dd",
    "expanded full float64 assign kb128 d24":
        "2773b549a726b8273ad3e5b4e63be3c9df21ac934a0f064fcd9d599be49fa31a",
    "expanded diag float32 proba kb16 d5":
        "7a0e489054244fc4e08983e1b438b5d55bfae8b9e07c67617332ef3ef6fc91f9",
    "expanded diag float32 proba kb16 d24":
        "867a1d366e14f2a9a95538b251285c7e1c268638efdc5158ff0ef1e2d6ced7ce",
    "expanded diag float32 proba kb128 d5":
        "eca2391fc4e9d02297e9d13ffb8b9ab4fa8b51a85ca638c3cfb79eceb2bcb297",
    "expanded diag float32 proba kb128 d24":
        "87dc99fe0ab815b7d7a77a5b9d7b23bb59f7ca6c07ff93ef3bf533f3d84c1abf",
    "expanded diag float32 assign kb16 d5":
        "07317248628f40b6ab4e9cf3f5a2f72902eaaa5400af9b641ea2a6fb41048ece",
    "expanded diag float32 assign kb16 d24":
        "da071da79067128512dd95fb97515577191de26b08055ff8dcff67db9fda5937",
    "expanded diag float32 assign kb128 d5":
        "07317248628f40b6ab4e9cf3f5a2f72902eaaa5400af9b641ea2a6fb41048ece",
    "expanded diag float32 assign kb128 d24":
        "da071da79067128512dd95fb97515577191de26b08055ff8dcff67db9fda5937",
    "expanded diag float64 proba kb16 d5":
        "df3b229e60d66aab0a5243ecab613011f936c726a7ecf8b09376e5fa488d161c",
    "expanded diag float64 proba kb16 d24":
        "78a67bad314e20c1225ef187c3722626cac630c43d3e6b995df2d7f3db98d454",
    "expanded diag float64 proba kb128 d5":
        "11ecaecf6ee7df1516d4a9f551b2b672d551509ea93baaa8e267c64059343b61",
    "expanded diag float64 proba kb128 d24":
        "82ef3312064f84c0b5bd4348d7302cf64dd367922ea94b36316772b657ba681d",
    "expanded diag float64 assign kb16 d5":
        "c7affff54144f3572c5fbdffffa77c54fab6c87d88272a721626d0326a01a5d7",
    "expanded diag float64 assign kb16 d24":
        "dcb9988a449fd18e2fc2292d4470aa5be1c74739a604788786f5c83ab7abd0d4",
    "expanded diag float64 assign kb128 d5":
        "c7affff54144f3572c5fbdffffa77c54fab6c87d88272a721626d0326a01a5d7",
    "expanded diag float64 assign kb128 d24":
        "dcb9988a449fd18e2fc2292d4470aa5be1c74739a604788786f5c83ab7abd0d4",
    "centered full float32 proba kb16 d5":
        "30f8a027b089d6c28dd2a4db4bd458694e11ddcf72118f7ee59d7c527b2c15ff",
    "centered full float32 proba kb16 d24":
        "8ca1114295ee66628bdacac66aa759142e6caabd2a922b06b3e70420f4ad5fef",
    "centered full float32 proba kb128 d5":
        "d346d0ac18dd6351118673331af4d38cee91379175d7606df8421e79a7b55798",
    "centered full float32 proba kb128 d24":
        "c3d25b134a8ce1ee1cfe7bfcc765c9422d3a659da031d0326d7d7508775cb66b",
    "centered full float32 assign kb16 d5":
        "5319cb47f131d4a9aaac4ed876ee46c32a4b4ea79a6f01844870495776174d7c",
    "centered full float32 assign kb16 d24":
        "7998e4650f1718c34be0ff11015793dc116d9ec09c3bf77909d8e7bcddc53340",
    "centered full float32 assign kb128 d5":
        "5319cb47f131d4a9aaac4ed876ee46c32a4b4ea79a6f01844870495776174d7c",
    "centered full float32 assign kb128 d24":
        "7998e4650f1718c34be0ff11015793dc116d9ec09c3bf77909d8e7bcddc53340",
    "centered full float64 proba kb16 d5":
        "4b6f1e9f50143a45346953bf8f8083c64d61a7e7a357f25414c20cdba34fd715",
    "centered full float64 proba kb16 d24":
        "153f3fe56a3d1c47c8b598d693160cef129782050d306b2f466944676991fa31",
    "centered full float64 proba kb128 d5":
        "ecfec7be2de8cf922edc1eca9d2caab19a976ee252038875aa6992f820a757d1",
    "centered full float64 proba kb128 d24":
        "2b2bcaa9732c99ada7dbcb9d18fac5a409ca873111cbc892b66ab93cb154c45f",
    "centered full float64 assign kb16 d5":
        "b5e142851ce3b2a32839ff635b265e8ae41303ea618860fddd0d6c3eb62fa165",
    "centered full float64 assign kb16 d24":
        "e450d7645ba9e548404e4d1f18c534c6c3b02ee7171ef396b528f76a3c4edba3",
    "centered full float64 assign kb128 d5":
        "b5e142851ce3b2a32839ff635b265e8ae41303ea618860fddd0d6c3eb62fa165",
    "centered full float64 assign kb128 d24":
        "e450d7645ba9e548404e4d1f18c534c6c3b02ee7171ef396b528f76a3c4edba3",
    "centered diag float32 proba kb16 d5":
        "e38b1d55b259844acdf1d039921ca1e2fd36256b8209a13d5f2cd7af51316f22",
    "centered diag float32 proba kb16 d24":
        "d2bbba919ecccda5d3c73c98fe56d2b13fd97debb32f6f23dceab911496dea96",
    "centered diag float32 proba kb128 d5":
        "d1de54ea93891d1e7ef442ae0127c39fb1047c16b4fa2f4186995134d1634705",
    "centered diag float32 proba kb128 d24":
        "86205196d4889f90bd62b1815e69cec785b70d2cd19d437da05b648aad94f3f2",
    "centered diag float32 assign kb16 d5":
        "a7b2d9c6dcc3fbc6e9098a3d07ddb7868d7d68dc0e34372197b84612b13071b2",
    "centered diag float32 assign kb16 d24":
        "aec3bd33f067fde2f18311a200fe8b881d2c3c3403ede15d48573f841994eba1",
    "centered diag float32 assign kb128 d5":
        "a7b2d9c6dcc3fbc6e9098a3d07ddb7868d7d68dc0e34372197b84612b13071b2",
    "centered diag float32 assign kb128 d24":
        "aec3bd33f067fde2f18311a200fe8b881d2c3c3403ede15d48573f841994eba1",
    "centered diag float64 proba kb16 d5":
        "0efeee139fcc76a290716402cc9f3f4a0b23fefb83bf39d4e2708ea64a10b8b3",
    "centered diag float64 proba kb16 d24":
        "1d82b6dbed5ae6f6cf9181a63cb0f66b1a3bcc0baa261550450cc7ebf533557f",
    "centered diag float64 proba kb128 d5":
        "9750e18dd2e3e0bd076fe84dead5fe45faf4dae45d3a3284b1d22e71508bc8fa",
    "centered diag float64 proba kb128 d24":
        "f4c8d7b5637017139b719e5f6e4c8d032d0dc80b8c2fae6dca68df355dcdfef1",
    "centered diag float64 assign kb16 d5":
        "a937eaa4a9d0723a8ba110f174b049f474861b14b2d7cd27018f74e5eaed95eb",
    "centered diag float64 assign kb16 d24":
        "889261a11a8b84f3312cbd9d0679d16507a9dc4f842cf7f1179bee9b9b31cf67",
    "centered diag float64 assign kb128 d5":
        "a937eaa4a9d0723a8ba110f174b049f474861b14b2d7cd27018f74e5eaed95eb",
    "centered diag float64 assign kb128 d24":
        "889261a11a8b84f3312cbd9d0679d16507a9dc4f842cf7f1179bee9b9b31cf67",
}


def p17_bits_model(d: int, diag: bool, centered: bool, kb: int):
    """(x [20000, D], A_ext [T + D, Kb], g [Kb]) in float64: a seeded SPD
    precision L L^T (its diagonal in diag mode), means, and g; the
    expanded form's -2 Rinv mu and -0.5 mu^T Rinv mu summed in a fixed
    order; zero A columns and -inf g past the model's slots."""
    rng = np.random.default_rng([18, d, int(diag)])
    k = P17_BITS_K
    mu = rng.uniform(-4.0, 4.0, size=(k, d))
    low = np.tril(rng.uniform(-0.4, 0.4, size=(k, d, d)), -1)
    low[:, np.arange(d), np.arange(d)] = rng.uniform(0.6, 1.4, size=(k, d))
    rinv = np.zeros((k, d, d))
    for i in range(d):
        for j in range(d):
            for m in range(d):
                rinv[:, i, j] = rinv[:, i, j] + low[:, i, m] * low[:, j, m]
    if diag:
        rinv = rinv * np.eye(d)[None]
    base = rng.uniform(-40.0, -30.0, size=k)  # constant + ln pi
    m = max(P17_BITS_ROWS)
    rows = rng.integers(0, k, size=m)
    x = mu[rows] + rng.uniform(-1.5, 1.5, size=(m, d))
    # every fifth row halfway between two means: two slots share its w
    x[::5] = 0.5 * (mu[rows[::5]] + mu[(rows[::5] + 1) % k])
    if diag:
        tri = rinv[:, np.arange(d), np.arange(d)]
    else:
        i, j = np.triu_indices(d)
        tri = rinv[:, i, j] * np.where(i == j, 1.0, 2.0)
    if centered:
        tail, g = mu, base
    else:
        h = np.zeros((k, d))
        for j in range(d):
            h = h + rinv[:, :, j] * mu[:, j:j + 1]
        c = np.zeros(k)
        for j in range(d):
            c = c + h[:, j] * mu[:, j]
        tail, g = -2.0 * h, -0.5 * c + base
    g = g.copy()
    g[list(P17_BITS_OFF)] = -np.inf
    a_ext = np.zeros((tri.shape[1] + d, kb))
    a_ext[:, :k] = np.concatenate([tri, tail], axis=1).T
    g_pad = np.full(kb, -np.inf)
    g_pad[:k] = g
    return x, a_ext, g_pad


def p17_bits_digests() -> dict:
    """{case: SHA-256 of S1's outputs' bytes (w or labels, then logZ) at
    each of P17_BITS_ROWS in turn}, one case per form, covariance, dtype,
    kind, Kb and D."""
    import hashlib

    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1

    out = {}
    for centered, diag, dt, kind, kb, d in itertools.product(
            (False, True), (False, True), (torch.float32, torch.float64),
            ("proba", "assign"), P17_BITS_KB, P17_BITS_D):
        x, a_ext, g = (torch.as_tensor(v, dtype=dt, device="cuda")
                       for v in p17_bits_model(d, diag, centered, kb))
        h = hashlib.sha256()
        for n in P17_BITS_ROWS:
            z = torch.empty(n, dtype=dt, device="cuda")
            if kind == "proba":
                o = torch.empty((n, kb), dtype=dt, device="cuda")
                s1.score_launch(x[:n].contiguous(), a_ext, g, z, diag=diag,
                                w=o, centered=centered)
            else:
                o = torch.empty(n, dtype=torch.int32, device="cuda")
                s1.score_launch(x[:n].contiguous(), a_ext, g, z, diag=diag,
                                labels=o, centered=centered)
            h.update(o.cpu().numpy().tobytes())
            h.update(z.cpu().numpy().tobytes())
        key = (f"{'centered' if centered else 'expanded'} "
               f"{'diag' if diag else 'full'} {str(dt)[6:]} {kind} kb{kb} "
               f"d{d}")
        out[key] = h.hexdigest()
    return out


def s1_bound(n: int, k: int, kb: int, d: int, diag: bool,
             centered: bool = False):
    """S1's bound on this run's shapes: 2 (T + D) flops per (event, active
    cluster) on the fp32 FMA units, 3 T + D in the centered form (its
    products depend on the cluster: D differences, then a product and an
    fma per term); bytes: x, the operands, w [n, Kb] and logZ once
    each."""
    t = d if diag else d * (d + 1) // 2
    flops = (3 * t + d) if centered else 2 * (t + d)
    return bound_ms(4.0 * (n * d + (t + d + 1) * kb + n * (kb + 1)),
                    float(n) * k * flops)


def s1_fp64_ms(n: int, k: int, d: int, diag: bool,
               centered: bool = False) -> float:
    """S1's flops (as ``s1_bound`` counts them) at the FP64 FMA rate, where
    its chains run: the ceiling of a kernel that keeps them in double."""
    t = d if diag else d * (d + 1) // 2
    flops = (3 * t + d) if centered else 2 * (t + d)
    return float(n) * k * flops / FP64_FLOPS_PER_S * 1e3


def _p17_states(result, diag: bool):
    """The fitted state on the card padded to its pow2 K-bucket (float32),
    and its float64 twin."""
    import torch

    from cuda_gmm_mpi_tpu_torch.parallel.sharded_em import pad_state_clusters
    from cuda_gmm_mpi_tpu_torch.serving.executor import pow2_bucket

    st = result.state.to("cuda")
    st = pad_state_clusters(st, pow2_bucket(st.num_clusters_padded))
    f64 = st.replace(**{f: getattr(st, f).double() for f in (
        "N", "pi", "constant", "avgvar", "means", "R", "Rinv")})
    return st, f64


def _normwise(a, ref) -> float:
    return float((a.double() - ref).abs().max() / ref.abs().max())


def p17_s1(result, x_c, diag: bool, label: str,
           quad_mode: str = "expanded") -> dict:
    """(a): S1 (its centered form under 'centered') against its plain
    version and float64 at P17_BLOCKS; the timed blocks. The float64
    reference of the centered form is the centered quadratic form with the
    full Rinv (a diag fit's Rinv is diagonal; the diag ``posteriors``
    expands x^2 whatever the quad mode)."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.estep import posteriors
    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1

    centered = quad_mode == "centered"
    plain = functools.partial(posteriors, diag_only=diag, quad_mode=quad_mode)
    ref64 = functools.partial(posteriors, diag_only=diag and not centered,
                              quad_mode=quad_mode)
    st, st64 = _p17_states(result, diag)
    k, kb = result.state.num_active(), st.num_clusters_padded
    pad = ~st.active
    worst = dict(w=0.0, z=0.0, w64=0.0, z64=0.0, plain_w64=0.0,
                 plain_z64=0.0, f64_w=0.0, f64_z=0.0)
    ties, outside = 0, 0
    for n in P17_BLOCKS:
        x = x_c[:n]
        w, z = s1.score(st, x, diag_only=diag, quad_mode=quad_mode)
        w2, z2 = s1.score(st, x, diag_only=diag, quad_mode=quad_mode)
        lab, zl = s1.score(st, x, diag_only=diag, quad_mode=quad_mode,
                           kind="assign")
        lab2, _ = s1.score(st, x, diag_only=diag, quad_mode=quad_mode,
                           kind="assign")
        wp, zp = plain(st, x)
        w64, z64 = ref64(st64, x.double())
        wd, zd = s1.score(st64, x.double(), diag_only=diag,
                          quad_mode=quad_mode)
        torch.cuda.synchronize()
        where = f"S1 {label} n={n}"
        check(torch.equal(w, w2) and torch.equal(z, z2)
              and torch.equal(lab, lab2) and torch.equal(z, zl),
              f"{where}: two launches differ")
        check(bool(torch.isfinite(w).all() and torch.isfinite(z).all()),
              f"{where}: non-finite output")
        check(bool((w[:, pad] == 0).all()), f"{where}: an inactive slot's w")
        ew, ez = float((w - wp).abs().max()), _normwise(z, zp.double())
        e64w, p64w = float((w.double() - w64).abs().max()), float(
            (wp.double() - w64).abs().max())
        e64z, p64z = _normwise(z, z64), _normwise(zp, z64)
        check(e64w <= P17_FP64_FACTOR * max(p64w, P17_FP64_FLOOR)
              and e64z <= P17_FP64_FACTOR * max(p64z, P17_FP64_FLOOR),
              f"{where}: float64 error w {e64w:.2e} z {e64z:.2e} against the "
              f"plain version's {p64w:.2e} / {p64z:.2e}")
        met = ew <= P17_W_BAR and ez <= P17_Z_BAR
        check(met or p64w > P17_W_BAR or p64z > P17_Z_BAR,
              f"{where}: against torch ops max|dw| {ew:.2e} (bar "
              f"{P17_W_BAR}), normwise dlogZ {ez:.2e} (bar {P17_Z_BAR}), "
              f"the torch-ops path within the class of float64")
        outside += not met
        fw, fz = float((wd - w64).abs().max()), _normwise(zd, z64)
        scale = max(1.0, float(z64.abs().max()))
        check(fw <= P17_F64_BAR * scale and fz <= P17_F64_BAR,
              f"{where}: float64 S1 max|dw| {fw:.2e} (bar "
              f"{P17_F64_BAR * scale:.2e}), dlogZ {fz:.2e} (bar "
              f"{P17_F64_BAR})")
        top = wp.topk(2, dim=1).values if wp.shape[1] > 1 else None
        miss = lab.long() != torch.argmax(wp, dim=1)
        if bool(miss.any()):
            gap = (top[:, 0] - top[:, 1])[miss]
            # a near-tie: the top two w closer than the two versions' w
            check(bool((gap <= max(P17_W_BAR, 2 * ew)).all()),
                  f"{where}: 'assign' differs off a near-tie")
            ties += int(miss.sum())
        for key, v in (("w", ew), ("z", ez), ("w64", e64w), ("z64", e64z),
                       ("plain_w64", p64w), ("plain_z64", p64z),
                       ("f64_w", fw), ("f64_z", fz)):
            worst[key] = max(worst[key], v)
    times = {}
    for n in P17_TIMED:
        x = x_c[:n]
        a_ext, g = s1.score_operands(st, diag, centered)
        w = torch.empty((n, kb), device="cuda")
        z = torch.empty(n, device="cuda")
        ms = graph_ms(lambda: s1.score_launch(x, a_ext, g, z, diag=diag,
                                              w=w, centered=centered))
        plain_ms = time_ms(lambda: plain(st, x), reps=20)
        b, by = s1_bound(n, k, kb, x.shape[1], diag, centered)
        f64 = s1_fp64_ms(n, k, x.shape[1], diag, centered)
        times[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        fp64_ceiling_ms=f64)
        print(f"  S1 {label} {n} rows: {ms:.4f} ms per launch (device time of"
              f" graph replays), torch-ops "
              f"posteriors {plain_ms:.4f} ms, bound {b:.4f} ms ({by}; "
              f"{100 * b / ms:.1f}% of it), FP64 FMA ceiling {f64:.4f} ms")
    print(f"  S1 {label} against torch ops at blocks {P17_BLOCKS}: max|dw| "
          f"{worst['w']:.2e}, normwise dlogZ {worst['z']:.2e} (outside the "
          f"class at {outside} of {len(P17_BLOCKS)} blocks, where torch ops "
          f"is too); against float64 w {worst['w64']:.2e}, logZ "
          f"{worst['z64']:.2e} (torch ops {worst['plain_w64']:.2e}, "
          f"{worst['plain_z64']:.2e}); float64 "
          f"S1 w {worst['f64_w']:.2e}, logZ {worst['f64_z']:.2e}; 'assign' "
          f"differs from torch ops on {ties} near-tie rows; repeat launches "
          f"bit-identical")
    return dict(errors=worst, near_ties=ties, blocks_outside_class=outside,
                times=times)


def _no_latency(resps):
    return [{k: v for k, v in r.items() if k != "latency_ms"} for r in resps]


def _p17_requests(x, model: str, scale: int = 10):
    """tests/test_torch_serving.py's request mix with ``scale`` x the
    rows."""
    cuts = [0, 7, 19, 22, 41, 44]
    ops = ["score", "predict", "predict_proba", "score_samples", "score"]
    return [{"id": i, "model": model, "op": op,
             "x": x[cuts[i] * scale:cuts[i + 1] * scale].tolist()}
            for i, op in enumerate(ops)]


def p17_contracts(make_ex, reg_dir: Path, result, other, x_c, raw,
                  label: str, model: str = "cells",
                  cov: str = "full") -> dict:
    """(b): the four contracts on one route for ``model`` (``result``'s
    fit, of covariance ``cov``); the stacked dispatch pairs it with the
    state ``other``. Returns {name: held}."""
    import dataclasses as dc

    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.serving import GMMServer, ModelRegistry

    out = {}
    st = result.state
    xs = x_c.cpu().numpy()
    small, big = make_ex(min_block=64, max_block=64), make_ex()
    out["split"] = all(
        all(np.array_equal(a, b) for a, b in zip(
            small.infer(st, xs[:n]), big.infer(st, xs[:n])))
        for n in (300, 70_000))
    srv = GMMServer(ModelRegistry(str(reg_dir)), executor=make_ex(),
                    warm=False, device="cuda")
    reqs = _p17_requests(raw, model)
    out["coalesced"] = (_no_latency(srv.handle_requests(reqs))
                        == _no_latency(srv.handle_requests(reqs,
                                                           coalesce=False)))
    ex = make_ex()
    (a, b), _ = ex.infer_stacked([st, other], [xs[:700], xs[700:1300]])
    sa, sb = ex.infer(st, xs[:700]), ex.infer(other, xs[700:1300])
    out["stacked"] = all(np.array_equal(p, q) for p, q in zip(
        a + b, (sa[0], sa[1], sb[0][:, :b[0].shape[1]], sb[1])))
    w1, z1 = ex.infer(st, xs[:5000])
    kb = w1.shape[1]
    route = ex._route_for(st, k_bucket=2 * kb)
    [(w2, z2)] = ex._executable("proba", ex.block_for(5000), 2 * kb,
                                xs.shape[1]).run([(route, xs[:5000])])
    out["k_pad"] = (np.array_equal(w1, w2[:, :kb]) and np.array_equal(z1, z2)
                    and not w2[:, kb:].any())
    # hot reload: v2 (means + 0.5) lands while a server serves v1
    hot = reg_dir.parent / f"hot_{label.replace(' ', '_')}"
    reg = ModelRegistry(str(hot))
    cfg = GMMConfig(covariance_type=cov)
    reg.save("m", result, config=cfg)
    srv = GMMServer(reg, executor=make_ex(), warm=False, device="cuda")

    def ask(server, **extra):
        return server.handle_requests([{"id": 0, "model": "m",
                                        "op": "score_samples",
                                        "x": raw[:900].tolist(), **extra}])[0]

    r1 = ask(srv)
    moved = dc.replace(result, state=result.state.replace(
        means=result.state.means + 0.5))
    reg.save("m", moved, config=cfg)
    swaps = srv.maybe_reload()
    r2, r_pin = ask(srv), ask(srv, version=1)
    fresh = ask(GMMServer(reg, executor=make_ex(), warm=False,
                          device="cuda"), version=2)
    out["hot_reload"] = (swaps == [{"model": "m", "from_version": 1,
                                    "to_version": 2}]
                         and r2["version"] == 2
                         and r2["result"] == fresh["result"]
                         and r_pin["result"] == r1["result"]
                         and r1["result"] != r2["result"])
    shutil.rmtree(hot, ignore_errors=True)
    return out


def p17_graphs(result, x_c) -> dict:
    """A graph replay against the eager launch per block, device time;
    each capture's seconds; the host wall of one warm dispatch."""
    from cuda_gmm_mpi_tpu_torch.serving.executor import ScoringExecutor

    ex = ScoringExecutor(device="cuda")
    st = result.state
    xs = x_c.cpu().numpy()
    route = ex._route_for(st)
    kb, d = route.state.num_clusters_padded, xs.shape[1]
    out = {}
    for n in P17_TIMED:
        prog = ex._executable("proba", n, kb, d)
        prog.run([(route, xs[:n])])
        replay = time_ms(prog.captured.replay, reps=20)
        eager = time_ms(lambda: ex._score_into(
            prog.slots[0], prog.x_dev[0], "proba", prog.a_dev[0],
            prog.z_dev[0]), reps=20)
        t0 = time.perf_counter()
        for _ in range(20):
            ex.infer(st, xs[:n])
        wall = (time.perf_counter() - t0) / 20 * 1e3
        out[n] = dict(replay_ms=replay, eager_ms=eager,
                      capture_s=prog.capture_s, dispatch_wall_ms=wall)
        print(f"  graph {n} rows: replay {replay:.4f} ms, eager launch "
              f"{eager:.4f} ms (device time); capture {prog.capture_s:.3f} "
              f"s; one warm infer() {wall:.3f} ms on the host clock")
    return out


def p17_latency(server, raw, rows: int, per_thread: int) -> dict:
    """The in-process server under P17_THREADS client threads, each
    sending ``per_thread`` requests of ``rows`` rows one after another:
    latency p50/p99 (submit to reply) and rows/s."""
    import threading

    lat, failed = [], []
    lock = threading.Lock()
    total = P17_THREADS * per_thread

    def client(t: int):
        rng = np.random.default_rng(t)
        for i in range(per_thread):
            done = threading.Event()
            box = {}

            def reply(resp, box=box, done=done):
                box["r"] = resp
                done.set()

            lo = int(rng.integers(0, len(raw) - rows))
            t0 = time.perf_counter()
            server.admit_request({"id": i, "model": "cells",
                                  "op": "score_samples",
                                  "x": raw[lo:lo + rows]}, reply)
            done.wait(120)
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
                if not box.get("r", {}).get("ok"):
                    failed.append(box.get("r"))

    loop = threading.Thread(target=server.run_loop,
                            kwargs={"max_requests": total})
    loop.start()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(P17_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    loop.join(60)
    check(not failed and len(lat) == total,
          f"latency run: {len(failed)} failed of {total}")
    lat = np.asarray(lat)
    return dict(rows=rows, requests=total, p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                rows_per_s=rows * total / wall)


def _p17_wait_port(path: Path, proc, timeout: float = 180.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise PhaseError(f"gmm serve exited {proc.returncode} early")
        if path.exists() and path.read_text().strip():
            return int(path.read_text())
        time.sleep(0.1)
    raise PhaseError("gmm serve published no port")


def p17_http(reg_dir: Path, workdir: Path, raw, inproc) -> dict:
    """(d): ``gmm serve --http 0 --workers 2 --device cuda`` as processes:
    bits equal to the in-process server's over JSON and x-gmm-rows frames,
    a worker SIGKILLed mid-stream with zero failed requests, SIGTERM drains
    to exit 75; every child reaped on every way out."""
    import threading

    from cuda_gmm_mpi_tpu_torch.serving import GMMClient, GMMClientError

    port_file, wd = workdir / "port.txt", workdir / "workers"
    cmd = [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli", "serve",
           "--registry", str(reg_dir), "--http", "0", "--workers", "2",
           "--device", "cuda", "--http-port-file", str(port_file),
           "--worker-dir", str(wd), "--max-body-bytes", str(64 << 20)]
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log = open(workdir / "serve.log", "wb")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            stdin=subprocess.DEVNULL, cwd=root, env=env)
    out = {}
    try:
        t0 = time.perf_counter()
        port = _p17_wait_port(port_file, proc)
        client = GMMClient(f"127.0.0.1:{port}", timeout_s=120.0, retries=3,
                           backoff_base_s=0.05, retry_budget=1.0)
        while not client.readyz():
            check(time.perf_counter() - t0 < 180, "pool never ready")
            time.sleep(0.1)
        out["startup_s"] = time.perf_counter() - t0
        same = True
        for model in ("cells", "cells_diag"):
            for op in ("score_samples", "predict_proba", "predict"):
                rows = raw[:1000]
                want = inproc.handle_requests([{"id": 0, "model": model,
                                                "op": op,
                                                "x": rows.tolist()}])[0]
                for enc in ("json", "binary"):
                    x = rows.tolist() if enc == "json" else rows.astype(
                        np.float64)
                    got = client.request(model, op, x, encoding=enc,
                                         deadline_ms=60_000)
                    same &= got["result"] == want["result"]
        check(same, "HTTP results differ from the in-process server's bits")
        for enc in ("json", "binary"):
            rows = raw[:4096]
            x = rows.tolist() if enc == "json" else rows.astype(np.float64)
            t1 = time.perf_counter()
            for _ in range(10):
                client.request("cells", "score_samples", x, encoding=enc,
                               deadline_ms=60_000)
            out[f"{enc}_rows_per_s"] = 10 * 4096 / (time.perf_counter() - t1)
        victim = json.loads((wd / "worker0.json").read_text())["pid"]
        failed, done = [], []

        def stream(t: int):
            for i in range(40):
                lo = 64 * (t * 40 + i)
                try:
                    client.score_samples(("cells", "cells_diag")[t % 2],
                                         raw[lo:lo + 64].tolist(),
                                         deadline_ms=120_000)
                    done.append(1)
                except GMMClientError as e:
                    failed.append(str(e))

        threads = [threading.Thread(target=stream, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        while len(done) < 20 and any(t.is_alive() for t in threads):
            time.sleep(0.01)
        os.kill(victim, signal.SIGKILL)
        for t in threads:
            t.join()
        check(not failed, f"{len(failed)} request(s) failed across the "
              f"SIGKILL: {failed[:2]}")
        deadline = time.monotonic() + 120
        while True:
            doc = json.loads((wd / "worker0.json").read_text())
            if doc["gen"] >= 1 or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check(doc["gen"] >= 1 and doc["pid"] != victim,
              f"worker 0 was not respawned: {doc}")
        out.update(requests_across_kill=len(done), failed=len(failed),
                   respawned=True, worker0_gen=doc["gen"])
        workers = [json.loads(p.read_text())["pid"]
                   for p in wd.glob("worker*.json")]
        proc.send_signal(signal.SIGTERM)
        out["exit_code"] = proc.wait(timeout=120)
        check(out["exit_code"] == 75, f"gmm serve exited {out['exit_code']} "
              "after SIGTERM, not 75")
        alive = [pid for pid in workers if _alive(pid)]
        for pid in alive:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        check(not alive, f"pool workers left running: {alive}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
        left = stop_children(grace_s=5.0)
        out["left_running"] = len(left)
    check(out["left_running"] == 0, f"processes left running: {left}")
    print(f"  HTTP pool of 2 workers: ready in {out['startup_s']:.1f} s; JSON "
          f"and x-gmm-rows answers equal the in-process server's bits; "
          f"{out['json_rows_per_s']:.0f} rows/s JSON against "
          f"{out['binary_rows_per_s']:.0f} binary (4,096-row requests); "
          f"worker 0 SIGKILLed mid-stream: {out['requests_across_kill']} "
          f"requests, {out['failed']} failed, respawned (gen "
          f"{out['worker0_gen']}); SIGTERM -> exit {out['exit_code']}")
    return out


def s1_centered_record(serving: dict) -> dict:
    """The centered S1's line: full covariance at 4,096 rows, its launches
    those of phase 17 (b)'s 'centered' serving routes (counted from 0
    around them)."""
    full, diag = (serving["a"]["centered full"],
                  serving["a"]["centered diag"])
    t = full["times"][4096]
    return dict(
        name="S1 score centered", route="cuda",
        source="cuda_gmm_mpi_tpu_torch/csrc/score.cu",
        replaces="cuda_gmm_mpi_tpu/serving/executor.py:274",
        launches=serving["centered_launches"],
        max_abs_err=max(full["errors"]["w"], diag["errors"]["w"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        fp64_ceiling_ms=t["fp64_ceiling_ms"], errors=full["errors"],
        diag_errors=diag["errors"], times=full["times"],
        diag_times=diag["times"])


def s1_record(serving: dict) -> dict:
    """S1's line of the kernels JSON: full covariance at 4,096 rows; the
    other blocks, diag and the serving measurements beside it."""
    full, diag = serving["a"]["full"], serving["a"]["diag"]
    t = full["times"][4096]
    return dict(
        name="S1 score", route="cuda",
        source="cuda_gmm_mpi_tpu_torch/csrc/score.cu",
        replaces="cuda_gmm_mpi_tpu/serving/executor.py:274",
        launches=serving["warm"]["s1_launches"],
        max_abs_err=max(full["errors"]["w"], diag["errors"]["w"]),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        fp64_ceiling_ms=t["fp64_ceiling_ms"], bits=serving["bits"],
        errors=full["errors"],
        diag_errors=diag["errors"], near_ties=full["near_ties"]
        + diag["near_ties"], times=full["times"], diag_times=diag["times"],
        graphs=serving["graphs"], warm=serving["warm"],
        contracts=serving["contracts"],
        torch_route_probes=serving["torch_route_probes"],
        cache_bytes=serving["cache_bytes"], latency=serving["latency"],
        http=serving["http"], phase_s=serving["wall_s"])


def phase_serving(data, main_result, diag_result, workdir: Path,
                  card: str) -> dict:
    """Phase 17: serving at full width (see the module docstring)."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1
    from cuda_gmm_mpi_tpu_torch.serving import (GMMServer, ModelRegistry,
                                                ScoringExecutor)

    t_phase = time.perf_counter()
    reg_dir = workdir / "registry"
    reg = ModelRegistry(str(reg_dir))
    reg.save("cells", main_result, config=GMMConfig())
    reg.save("cells_diag", diag_result,
             config=GMMConfig(covariance_type="diag"))
    shift = main_result.data_shift.astype(np.float32)
    x_c = torch.as_tensor(data[:70_000] - shift[None, :], device="cuda")
    raw = data[:70_000]
    print(f"  models: cells (full, K {main_result.ideal_num_clusters}), "
          f"cells_diag (diag, K {diag_result.ideal_num_clusters}); card: "
          f"{card}")

    # (a) S1's bits against the first version's, then S1 against its
    # plain version and float64, both forms
    bits = p17_bits_digests()
    differ = sorted(k for k in P17_BITS if bits.get(k) != P17_BITS[k])
    check(not differ and len(bits) == len(P17_BITS),
          f"S1's outputs differ from the first version's digests in "
          f"{len(differ)} of {len(P17_BITS)} cases: {differ[:4]}")
    print(f"  S1 bits: {len(bits)} cases (both forms, full and diag, float32 "
          f"and float64, 'proba' and 'assign', Kb {P17_BITS_KB}, D "
          f"{P17_BITS_D}, rows {P17_BITS_ROWS}) equal to the first "
          f"version's SHA-256 digests (commit 477d8c7)")
    a = {"full": p17_s1(main_result, x_c, False, "full"),
         "diag": p17_s1(diag_result, x_c, True, "diag"),
         "centered full": p17_s1(main_result, x_c, False, "centered full",
                                 "centered"),
         "centered diag": p17_s1(diag_result, x_c, True, "centered diag",
                                 "centered")}

    # (b) the four contracts, held on S1's route at every precision and
    # quad mode, full and diag; printed on torch ops
    held, centered_launches = {}, 0
    for fam_name, fam in P17_FAMILIES:
        for cov, res, other, model in (
                ("full", main_result, diag_result.state, "cells"),
                ("diag", diag_result, diag_result.state.replace(
                    means=diag_result.state.means + 0.5), "cells_diag")):
            def s1_ex(**kw):
                ex = ScoringExecutor(device="cuda", diag_only=cov == "diag",
                                     **fam, **kw)
                check(ex.route == "S1", f"{fam_name} {cov}: route "
                      f"{ex.route!r}")
                return ex

            label = f"S1 {fam_name} {cov}"
            before = s1.centered_form.launches
            held[fam_name, cov] = p17_contracts(
                s1_ex, reg_dir, res, other, x_c, raw, label, model, cov)
            centered_launches += s1.centered_form.launches - before
            check(all(held[fam_name, cov].values()),
                  f"{label} route contracts: {held[fam_name, cov]}")
            print(f"  contracts on {label}'s route (torch.equal): "
                  f"{held[fam_name, cov]}")
    check(centered_launches > 0, "the 'centered' routes never launched S1's "
          "centered form")
    probes = {}
    for name, kw in (("torch ops 'highest'", {}),
                     ("torch ops 'centered'", dict(quad_mode="centered"))):
        def t_ex(**more):
            ex = ScoringExecutor(device="cuda", **kw, **more)
            # The yardstick beside S1: its route set to the torch-ops
            # posteriors before the executor's first call.
            ex.route = "torch"
            return ex

        probes[name] = p17_contracts(t_ex, reg_dir, main_result,
                                     diag_result.state, x_c, raw, name)
        print(f"  contracts on the {name} route (printed, not held): "
              f"{probes[name]}")

    graphs = p17_graphs(main_result, x_c)

    # (c) the warm path: two models, every block warmed, then 1,000 requests
    server = GMMServer(reg, device="cuda")
    for name in ("cells", "cells_diag"):
        m = server.resolve(name)
        ex = server._executor_for(m)
        check(ex.route == "S1", f"{name} is served on {ex.route!r}")
        ex.warmup(m.state, blocks=P17_WARM_BLOCKS)
    compiles = server.executor_stats()["compiles"]
    rng = np.random.default_rng(17)
    ops = ("predict", "predict_proba", "score_samples", "score")
    reqs = []
    for i in range(P17_WARM_REQUESTS):
        n = int(rng.integers(1, 4097))
        lo = int(rng.integers(0, len(raw) - n))
        reqs.append({"id": i, "model": ("cells", "cells_diag")[i % 2],
                     "op": ops[int(rng.integers(0, 4))],
                     "x": raw[lo:lo + n]})
    s1.score.launches = 0
    t0 = time.perf_counter()
    resps = []
    for j in range(0, P17_WARM_REQUESTS, 4):
        resps += server.handle_requests(reqs[j:j + 4])
    warm_s = time.perf_counter() - t0
    launches = s1.score.launches
    stats = server.executor_stats()
    check(all(r["ok"] for r in resps) and len(resps) == P17_WARM_REQUESTS,
          "warm path: a request failed")
    check(stats["compiles"] == compiles and stats["host_stagings"] == 0
          and server.host_stagings == 0,
          f"warm path built {stats['compiles'] - compiles} programs, "
          f"{stats['host_stagings']} host stagings")
    check(launches == server.batches,
          f"S1 launched {launches} times for {server.batches} dispatches")
    warm = dict(requests=P17_WARM_REQUESTS, dispatches=server.batches,
                s1_launches=launches, wall_s=warm_s,
                new_captures=stats["compiles"] - compiles,
                host_stagings=stats["host_stagings"])
    print(f"  warm path: {P17_WARM_REQUESTS} requests (1-4096 rows, mixed "
          f"ops, two models) in {warm_s:.2f} s, {server.batches} dispatches, "
          f"S1 launches {launches}, 0 new captures, 0 host stagings")
    mem = sum(ex.device_bytes() for ex in server._executors.values())
    print(f"  the executor caches hold {mem / 2 ** 20:.1f} MiB of device "
          f"memory ({stats['live_executables']} programs)")
    lat = [p17_latency(GMMServer(reg, device="cuda"), raw, rows, per)
           for rows, per in ((64, 100), (1024, 25))]
    for r in lat:
        print(f"  in-process server, {P17_THREADS} threads x {r['rows']}-row "
              f"requests: p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
              f"{r['rows_per_s']:.0f} rows/s")

    # (d) over HTTP, as processes
    http = p17_http(reg_dir, workdir, raw, server)
    wall = time.perf_counter() - t_phase
    print(f"  phase 17 took {wall:.1f} s")
    return dict(a=a, bits=len(bits),
                contracts={f"{f} {c}": v for (f, c), v in held.items()},
                centered_launches=centered_launches,
                torch_route_probes=probes, graphs=graphs, warm=warm,
                cache_bytes=mem, latency=lat, http=http, wall_s=wall)


P18_PROBE_K, P18_PROBE_ITERS = 100, 3  # (a): `gmm tune --k 100`
P18_SERVE_MIN, P18_SERVE_MAX = (32, 64), (8192, 16384)  # (c)'s candidates
P18_SHIFT = 0.5  # (d): drifted rows are the events + 0.5 x their std
# (d)'s policy: the defaults but for an arc that closes in a few ticks and
# a refit whose every step sees the 65,536 rows (max_rows) as one block, so
# that no step estimates a cluster's covariance from a handful of rows
P18_RETRAIN_CHUNK = 65536
P18_POLICY = {"debounce_alarms": 1, "cooldown_s": 0.0,
              "canary": {"max_psi": 100.0, "max_ks": 1.0, "shadow_ticks": 2},
              "watch": {"probation_ticks": 2, "probation_s": 0.0,
                        "min_rows": 32}}
# stream fields that carry a clock, a run identity or an allocator's state
P18_CLOCK_FIELDS = {"ts", "seconds", "run_id", "clock", "clock0", "metrics",
                    "compile", "phase_profile", "profile", "memory_stats"}


def _p18_stream(path) -> list:
    """A fit's stream without its clocks, heartbeats and compile events."""
    out = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r["event"] in ("heartbeat", "compile", "run_summary"):
                continue
            out.append({k: v for k, v in r.items()
                        if k not in P18_CLOCK_FIELDS and not k.endswith("_s")})
    return out


def _p18_replies(server, raw, shift, requests=8, rows=512, start=0):
    """``requests`` score_samples replies of ``rows`` rows (raw + shift),
    latency scrubbed."""
    out = []
    for i in range(requests):
        lo = ((start + i) * 7919) % (len(raw) - rows)
        x = raw[lo:lo + rows] + np.float32(shift)
        r = server.handle_requests([{"id": i, "model": "cells",
                                     "op": "score_samples", "x": x}])[0]
        check(r["ok"], f"lifecycle traffic: {r}")
        out.append(json.dumps({k: v for k, v in r.items()
                               if k != "latency_ms"}, sort_keys=True))
    return out


def phase_tuning_lifecycle(data, main_result, workdir: Path, card: str
                           ) -> dict:
    """Phase 18: tuning and the lifecycle at full width (see the module
    docstring)."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.cli import main as gmm_main
    from cuda_gmm_mpi_tpu_torch.io import write_bin
    from cuda_gmm_mpi_tpu_torch.lifecycle import (LifecycleController,
                                                  LifecyclePolicy)
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1
    from cuda_gmm_mpi_tpu_torch.serving import (GMMServer, ModelRegistry,
                                                ScoringExecutor)
    from cuda_gmm_mpi_tpu_torch.serving.server import serve_main
    from cuda_gmm_mpi_tpu_torch.testing import faults
    from cuda_gmm_mpi_tpu_torch.tuning import TuningDB, TuningKey
    from cuda_gmm_mpi_tpu_torch.tuning.autotune import device_key

    t_phase = time.perf_counter()
    out = {}
    infile = workdir / "events.bin"
    write_bin(str(infile), data)
    db_path = str(workdir / "tuning.json")

    # (a) `gmm tune` probes estep_backend at K = 100 on the card
    t0 = time.perf_counter()
    rc = gmm_main(["tune", str(infile), "--k", str(P18_PROBE_K),
                   "--probe-iters", str(P18_PROBE_ITERS), "--tuning-db",
                   db_path, "--device", "cuda"])
    tune_s = time.perf_counter() - t0
    check(rc == 0, f"gmm tune exited {rc}")
    platform, kind = device_key("cuda")
    key = TuningKey.for_shape(platform, kind, N_EVENTS, DIMS, P18_PROBE_K,
                              "full", "float32")
    db = TuningDB.open(db_path)
    row = db.lookup(key, "estep_backend")
    check(row is not None and set(row["candidates"]) == {"torch", "cuda"}
          and row["source"] == "probe",
          f"gmm tune wrote no estep_backend row at {key.as_str()}: {row}")
    walls = {c: p["wall_per_iter_s"] for c, p in row["candidates"].items()}
    out["a"] = dict(key=key.as_str(), chosen=row["chosen"], walls=walls,
                    wall_s=tune_s)
    print(f"  (a) gmm tune: row {key.as_str()}: estep_backend torch "
          f"{walls['torch']:.6f} s/iter, cuda {walls['cuda']:.6f} s/iter -> "
          f"{row['chosen']!r} (EM walls; {tune_s:.1f} s; no fit resolves "
          f"chunk_size on the card)")

    # (b) a tuned fit, the untuned fit with its knobs, 'off' against plain
    streams = {}

    def run(name, **cfg):
        path = workdir / f"{name}.jsonl"
        r = fit(data, K0, K_TARGET, ITERS, metrics_file=str(path), **cfg)[0]
        streams[name] = path
        return r

    tuned = run("tuned", autotune="db", tuning_db=db_path)
    tune = {}
    with open(streams["tuned"]) as f:
        for line in f:
            r = json.loads(line)
            if r["event"] == "tune":
                tune[r["knob"]] = r
    check(tune.get("estep_backend", {}).get("source") == "db"
          and tune["estep_backend"]["chosen"] == row["chosen"],
          f"the tuned fit did not resolve estep_backend from the row: {tune}")
    check("chunk_size" not in tune,
          f"the tuned fit resolved chunk_size on the card: {tune}")
    knobs = {k: r["chosen"] for k, r in tune.items()}
    untuned = run("untuned", **knobs)
    pairs = lambda r: [m[1] for m in r.merges]
    check(tuned.ideal_num_clusters == untuned.ideal_num_clusters
          and pairs(tuned) == pairs(untuned),
          f"tuned fit K {tuned.ideal_num_clusters} pairs {pairs(tuned)}, "
          f"untuned {untuned.ideal_num_clusters} {pairs(untuned)}")
    off = run("off", autotune="off", tuning_db=db_path)
    plain = run("plain")
    same_off = (_equal_fits(off, plain)
                and _p18_stream(streams["off"]) == _p18_stream(
                    streams["plain"]))
    check(same_off, "an --autotune off fit differs from a fit without the "
          "fields (result or stream)")
    out["b"] = dict(decisions={k: dict(chosen=r["chosen"], source=r["source"])
                               for k, r in tune.items()},
                    k=tuned.ideal_num_clusters, merge_pairs=pairs(tuned),
                    same_as_untuned=_equal_fits(tuned, untuned),
                    off_equals_plain=same_off)
    print(f"  (b) --autotune db fit: " + ", ".join(
        f"{k}={r['chosen']} ({r['source']})" for k, r in tune.items())
        + f"; K {tuned.ideal_num_clusters} and merge pairs equal the untuned "
        f"fit's with those knobs (bit-identical: "
        f"{out['b']['same_as_untuned']}); 'off' equals a fit without the "
        f"fields, result and stream")

    # (c) serving blocks measured into the DB; `gmm serve --autotune db`
    reg_dir = workdir / "registry"
    reg = ModelRegistry(str(reg_dir))
    reg.save("cells", main_result, config=GMMConfig())
    shift = main_result.data_shift.astype(np.float32)
    raw = data[:70_000]
    st = main_result.state
    skey = TuningKey.for_shape(platform, kind, 65536, DIMS,
                               main_result.ideal_num_clusters, "full",
                               "float32")
    serve_walls = {}
    for knob, cands, rows in (("serve_min_block", P18_SERVE_MIN, 100),
                              ("serve_max_block", P18_SERVE_MAX, 65_536)):
        xs = raw[:rows] - shift[None, :]
        for c in cands:
            kw = ({"min_block": c} if knob == "serve_min_block"
                  else {"max_block": c, "min_block": 256})
            ex = ScoringExecutor(device="cuda", **kw)
            ex.infer(st, xs)  # capture
            t0 = time.perf_counter()
            for _ in range(5):
                ex.infer(st, xs)
            wall = (time.perf_counter() - t0) / 5
            serve_walls[knob, c] = wall
            db.record(skey, knob, c, {"wall_per_iter_s": round(wall, 6),
                                      "rows": rows}, source="probe")
    db.save()
    req_path = workdir / "requests.jsonl"
    reqs = _p17_requests(raw, "cells") + [
        {"id": 5, "model": "cells", "op": "predict_proba",
         "x": raw[:30_000].tolist()}]
    req_path.write_text("\n".join(json.dumps(r) for r in reqs) + "\n")
    replies = {}
    for mode in ("off", "db"):
        resp = workdir / f"serve_{mode}.jsonl"
        met = workdir / f"serve_{mode}_stream.jsonl"
        rc = serve_main(["--registry", str(reg_dir), "--input",
                         str(req_path), "--output", str(resp), "--device",
                         "cuda", "--autotune", mode, "--tuning-db", db_path,
                         "--metrics-file", str(met)])
        check(rc == 0, f"gmm serve --autotune {mode} exited {rc}")
        replies[mode] = [json.loads(ln) for ln in resp.read_text().splitlines()]
        replies[mode] = [{k: v for k, v in r.items() if k != "latency_ms"}
                         for r in replies[mode]]
        check(all(r["ok"] for r in replies[mode])
              and len(replies[mode]) == len(reqs), f"serve {mode} replies")
        if mode == "db":
            serve_tune = {r["knob"]: r["chosen"] for r in map(
                json.loads, met.read_text().splitlines())
                if r["event"] == "tune"}
    check(replies["db"] == replies["off"],
          "gmm serve --autotune db replied other bits than 'off'")
    check(set(serve_tune) == {"serve_min_block", "serve_max_block"},
          f"serve tune records: {serve_tune}")
    out["c"] = dict(walls={f"{k}={c}": w for (k, c), w in serve_walls.items()},
                    resolved=serve_tune, identical=True)
    print(f"  (c) serve blocks measured: " + ", ".join(
        f"{k}={c} {w * 1e3:.3f} ms" for (k, c), w in serve_walls.items())
        + f"; gmm serve --autotune db resolved {serve_tune} and replied "
        f"byte for byte as 'off' ({len(reqs)} requests, up to 30,000 rows)")

    # (d) the lifecycle arc on the K 96 model, then a rejected canary
    policy_path = workdir / "policy.json"
    policy_path.write_text(json.dumps(dict(
        P18_POLICY, retrain={"data": str(infile),
                             "chunk_size": P18_RETRAIN_CHUNK})))
    ctl = LifecycleController(reg, LifecyclePolicy.from_file(
        str(policy_path)), device="cuda")
    server = GMMServer(reg, device="cuda", drift_interval_s=3600.0,
                       drift_psi_threshold=0.2, lifecycle=ctl)
    drift = P18_SHIFT * float(data[:70_000].std())
    edges = []

    def tick(what):
        ctl.on_tick()
        state = ctl.stats()["routes"].get("cells")
        edges.append((what, state))
        return state

    t0 = time.perf_counter()
    _p18_replies(server, raw, drift)
    alarm = server.flush_drift()
    check(any(a.get("alarm") for a in alarm), f"no drift alarm: {alarm}")
    check(ctl.stats()["routes"]["cells"] == "retrain",
          f"the alarm did not schedule a retrain: {ctl.stats()}")
    fs.fused_stats.launches = fs.mstep.launches = s1.score.launches = 0
    t1 = time.perf_counter()
    state = tick("retrain + holdout gates")
    retrain_s = time.perf_counter() - t1
    refit = dict(K1=fs.fused_stats.launches, K2=fs.mstep.launches,
                 S1=s1.score.launches)
    check(state == "canary", f"retrain tick ended in {state!r}: "
          f"{ctl.stats()}")
    check(refit["K1"] > 0 and refit["K2"] > 0 and refit["S1"] > 0,
          f"the refit and gates launched {refit}")
    s1.score.launches = 0
    _p18_replies(server, raw, drift, requests=2, start=50)  # shadow window
    shadow_s1 = s1.score.launches
    check(shadow_s1 > 0, "the shadow window launched no S1")
    check(tick("canary -> promote") == "watch" and
          server.resolve("cells").version == 2,
          f"no promotion: {ctl.stats()}")
    _p18_replies(server, raw, drift, requests=3, start=80)
    check(tick("watch") == "cooldown", f"watch: {ctl.stats()}")
    check(tick("cooldown") == "idle", f"cooldown: {ctl.stats()}")
    promoted = ModelRegistry(str(reg_dir)).load("cells", 2)
    check(promoted.manifest["source"] == "lifecycle"
          and promoted.manifest["retrain_of"] == 1,
          f"promoted manifest {promoted.manifest}")
    xs = raw[:4096] - promoted.data_shift.astype(np.float32)[None, :]
    w, z = ScoringExecutor(device="cuda").infer(promoted.state, xs)
    check(np.isfinite(z).all() and np.allclose(w.sum(axis=1), 1.0,
                                               atol=1e-4),
        "the promoted version does not score in the registry")
    # a rejected canary: every reply byte unchanged
    before = _p18_replies(server, raw, drift, start=200)
    server.flush_drift()
    with faults.use({"canary_regression": {"model": "cells",
                                           "times": 1}}) as plan:
        state = tick("retrain + canary_regression")
        check(plan.fired.get("canary_regression") == 1,
              "the canary_regression fault did not fire")
    after = _p18_replies(server, raw, drift, start=200)
    check(state == "cooldown" and after == before
          and server.resolve("cells").version == 2
          and reg.stage("cells", 3) == "quarantined",
          f"rejected canary: state {state!r}, replies unchanged "
          f"{after == before}, stages {reg.versions('cells')}")
    arc_s = time.perf_counter() - t0
    out["d"] = dict(edges=edges, counts=dict(ctl.counts),
                    refit_launches=refit, shadow_s1_launches=shadow_s1,
                    retrain_tick_s=retrain_s, wall_s=arc_s,
                    versions=reg.versions("cells", include_candidates=True))
    print(f"  (d) lifecycle arc: {' -> '.join(s for _, s in edges)}; the "
          f"retrain tick (stepwise EM on {min(len(data), 65536)} rows of the "
          f"BIN, K {main_result.ideal_num_clusters}, then the holdout gates) "
          f"{retrain_s:.2f} s with K1 {refit['K1']}, K2 "
          f"{refit['K2']}, S1 {refit['S1']} launches; shadow window S1 "
          f"{shadow_s1}; counts {ctl.counts}; v2 promoted and loaded, v3 "
          f"quarantined by canary_regression with every reply unchanged "
          f"({arc_s:.1f} s)")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 18 took {out['wall_s']:.1f} s; card: {card}")
    return out


# ---------------------------------------------------------------- phase 19

# The fleet: two packed groups at D = 24 (float32, 20 iterations per K):
# 32 tenants of 33,000-65,536 events at K = 16 and 16 of 9,000-16,384 at
# K = 8, each a blob mixture from the seed; four tenants have a target K.
P19_GROUPS = ((32, 33_000, 65_536, 16), (16, 9_000, 16_384, 8))
P19_TARGETS = {3: 6, 17: 6, 34: 4, 41: 4}  # tenant index -> target K
P19_ITERS, P19_CHUNK = 20, 16_384
P19_FROZEN = 5  # the lane (a) freezes through the lane mask
P19_CLI, P19_MESH = 4, 4  # tenants of (e) and (f), from the second group
P19_MESH_CHUNK = 1024  # (f): the solo layout's pad chunks interleave
P19_TIMEOUT_S = 300


def p19_tenants(seed: int, only=None) -> list:
    """The fleet's tenants: per tenant its event count, true cluster count
    (8-12, or 4-6 in the second group) and blobs, all from ``seed``
    (``only``: the tenants of these indices)."""
    from cuda_gmm_mpi_tpu_torch.tenancy import TenantSpec

    rng = np.random.default_rng(seed + 19)
    out = []
    i = 0
    for count, lo, hi, k in P19_GROUPS:
        for _ in range(count):
            n = int(rng.integers(lo, hi + 1))
            true_k = int(rng.integers(k // 2, k - k // 4 + 1))
            if only is None or i in only:
                out.append(TenantSpec(
                    f"p{i:02d}", make_blobs(seed + 1000 + i, n, DIMS, true_k),
                    k, target_num_clusters=P19_TARGETS.get(i, 0)))
            i += 1
    return out


def p19_config(**kw):
    from cuda_gmm_mpi_tpu_torch import GMMConfig

    return GMMConfig(**{**dict(min_iters=P19_ITERS, max_iters=P19_ITERS,
                               chunk_size=P19_CHUNK, sweep_k_buckets="off"),
                        **kw})


def _same_result(a, b) -> bool:
    """Two fits' models bit for bit: K, scores, merges, the per-K
    trajectory (seconds aside) and every state field."""
    import torch

    return (a.ideal_num_clusters == b.ideal_num_clusters
            and a.final_loglik == b.final_loglik
            and a.min_rissanen == b.min_rissanen and a.merges == b.merges
            and [r[:4] for r in a.sweep_log] == [r[:4] for r in b.sweep_log]
            and all(torch.equal(getattr(a.state, f), getattr(b.state, f))
                    for f in ("N", "pi", "constant", "avgvar", "means", "R",
                              "Rinv", "active")))


def _zero_fleet_counts():
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    for w in (fs.fused_stats, fs.mstep, fs.fused_stats_batched,
              fs.mstep_batched, fs.fused_stats_fleet, fs.fused_stats_narrow,
              fs.fused_stats_fleet_narrow):
        w.launches = 0


def _fleet_counts() -> dict:
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    return {"K1": fs.fused_stats.launches, "K2": fs.mstep.launches,
            "K3": fs.fused_stats_batched.launches,
            "K4": fs.mstep_batched.launches,
            "K3 fleet": fs.fused_stats_fleet.launches,
            "K1 narrow": fs.fused_stats_narrow.launches,
            "K3 fleet narrow": fs.fused_stats_fleet_narrow.launches}


def p19_form_operands(tenants, diag: bool):
    """The per-lane form's operands on the first group's lanes (their
    packed grids, states after one torch-ops M-step on each lane's events,
    lane P19_FROZEN frozen): (x, wt, n, lanes, A, h, g), each lane's
    (A, h, g), the event counts and the live lanes."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats, apply_mstep
    from cuda_gmm_mpi_tpu_torch.tenancy import pack_group, plan_fleet

    cfg = p19_config(diag_only=diag)
    group = plan_fleet(tenants, cfg)[-1]  # the 65,536-event bucket
    check(group.n_bucket == 65_536 and len(group.indices) == 32,
          f"phase 19 (a): unexpected first group {group}")
    packed = pack_group(group, tenants, cfg, device="cuda")
    R, C, B, d = packed.chunks.shape
    chunks = torch.as_tensor(packed.chunks, device="cuda")
    wts = torch.as_tensor(packed.wts, device="cuda")
    n_np = packed.n_events
    params = []
    for r, s in enumerate(packed.states):
        c = int(packed.solo_chunks[r])
        s = apply_mstep(s, accumulate_stats(s, chunks[r, :c], wts[r, :c],
                                            diag_only=diag), diag_only=diag)
        params.append(fs._prep_params(s, d, diag))
    A, h, g = (torch.stack(p) for p in zip(*params))
    x = chunks.reshape(R, C * B, d)
    wt = wts.reshape(R, C * B)
    n = torch.as_tensor(n_np, dtype=torch.int32, device="cuda")
    lanes = torch.ones(R, dtype=torch.float32, device="cuda")
    lanes[P19_FROZEN] = 0.0
    live = [r for r in range(R) if r != P19_FROZEN]
    return (x, wt, n, lanes, A, h, g), params, n_np, live


def p19_k3_form(tenants, diag: bool, precision: str = "highest",
                timed: bool = True) -> dict:
    """(a): K3's per-lane-events form (:func:`p19_form_operands`) against
    K1 on each lane's rows, its plain version and float64."""
    import torch

    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    args, params, n_np, live = p19_form_operands(tenants, diag)
    x, wt, n, lanes, A, h, g = args
    R, d = x.shape[0], x.shape[-1]
    kw = dict(diag=diag, precision=precision)
    most = int(n_np.max())
    out = fs.fused_stats_fleet(*args, max_events=most, **kw)
    out2 = fs.fused_stats_fleet(*args, max_events=most, **kw)
    ref = fs.fused_stats_fleet_plain(*args, **kw)
    torch.cuda.synchronize()
    label = f"K3 per-lane events {'diag' if diag else 'full'} {precision}"
    check(all(torch.equal(a, b) for a, b in zip(out, out2)),
          f"{label}: two launches differ")
    for r in live:
        m = int(n_np[r])
        one = fs.fused_stats(x[r, :m], wt[r, :m], *params[r], **kw)
        check(all(torch.equal(a[r], b) for a, b in zip(out, one)),
              f"{label}: lane {r} differs from K1 on its {m} rows")
    check(not any(bool(o[P19_FROZEN].any()) for o in out),
          f"{label}: frozen lane {P19_FROZEN} is not all zeros")
    worst = worst64 = worst64_plain = 0.0
    for name, a, b in zip(("ll", "nk", "m1", "m2"), out, ref):
        a, b = a[live], b[live]
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite {name}")
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rtol, atol = TOL[name]
        check(err <= atol + rtol * scale,
              f"{label}: {name} max|err| {err:.3e} > {atol} + {rtol} x "
              f"{scale:.3e}")
        worst = max(worst, err)
    # Against float64, normwise over the live lanes together as phase 5
    # holds K3 (each lane's float64 statistics computed on its own, one
    # lane's [n, D^2] float64 features at a time).
    err64 = {k: [0.0, 0.0, 0.0] for k in ("ll", "nk", "m1", "m2")}
    for r in live:
        m = int(n_np[r])
        c64 = fs.fused_stats_plain(x[r, :m].double(), wt[r, :m].double(),
                                   *(p.double() for p in params[r]),
                                   diag=diag)
        for name, a, b, c in zip(("ll", "nk", "m1", "m2"), out, ref, c64):
            e = err64[name]
            e[0] = max(e[0], float((a[r].double() - c).abs().max()))
            e[1] = max(e[1], float((b[r].double() - c).abs().max()))
            e[2] = max(e[2], float(c.abs().max()))
        del c64
    for name, (ea, eb, scale) in err64.items():
        e64, p64 = ea / max(scale, 1e-300), eb / max(scale, 1e-300)
        check(e64 <= 2.0 * max(p64, FP32_EPS),
              f"{label}: {name} float64 error {e64:.2e} > 2 x the plain "
              f"version's {p64:.2e}")
        worst64, worst64_plain = max(worst64, e64), max(worst64_plain, p64)
    rec = {"max_abs_err": worst, "fp64_err": worst64,
           "plain_fp64_err": worst64_plain, "lanes": R, "live_lanes":
           len(live), "events": int(n_np.sum()), "library_ms": None}
    print(f"  {label}: {len(live)} live lanes torch.equal to K1 on their "
          f"own rows, frozen lane zeros, two launches equal; max|form - "
          f"plain| {worst:.3e}; normwise vs float64 {worst64:.2e} (plain "
          f"{worst64_plain:.2e})")
    if not timed:
        return rec
    k = A.shape[-1]
    t = d if diag else d * (d + 1) // 2
    f = A.shape[1]
    m_live = float(sum(int(n_np[r]) for r in live))
    nbytes = 4 * (m_live * (d + 1) + R + A.numel() + h.numel() + g.numel()
                  + len(live) * (1 + k + k * d + k * f)) + 4 * R
    rec["ms"] = time_ms(lambda: fs.fused_stats_fleet(
        *args, max_events=most, **kw))
    if precision == "highest":
        # The narrow route (the wrapper's, K_pad W) against the C entry at
        # K_pad 128 on prebuilt operands: torch.equal, timed in turns
        # (stats_ab.py times every width).
        (tile, ops), (wide, ops_w) = narrow_routes(A, h, g, k, d, diag)
        routes = {tile.k_pad: (tile, ops), fs.TILE: (wide, ops_w)}
        runs = {w: functools.partial(fs._launch_fleet, x, wt, n, lanes,
                                     *o, k, diag, tl, precision, most)
                for w, (tl, o) in routes.items()}
        for w, run in runs.items():
            check(all(torch.equal(a, b) for a, b in zip(run(), out)),
                  f"{label}: K_pad {w} differs from the wrapper's "
                  f"K_pad {tile.k_pad}")
        rec["width_ms"] = dict(zip(runs, in_turns(*runs.values())))
        rec["k_pad"], rec["equal_to_wide"] = tile.k_pad, True
        rec["wide_ms"] = rec["width_ms"][fs.TILE]
        print(f"  {label}: K_pad {tile.k_pad} torch.equal to K_pad "
              f"{', '.join(str(w) for w in runs if w != tile.k_pad)} on "
              f"prebuilt operands; one launch (in turns) "
              + ", ".join(f"K_pad {w} {v:.3f} ms"
                          for w, v in rec["width_ms"].items()))
    rec["k1_sum_ms"] = sum(time_ms(
        lambda r=r: fs.fused_stats(x[r, :int(n_np[r])], wt[r, :int(n_np[r])],
                                   *params[r], **kw)) for r in live)
    rec["plain_ms"] = time_ms(lambda: fs.fused_stats_fleet_plain(*args, **kw),
                              reps=2)
    rec.update(route_bound(nbytes, 2.0 * m_live * k * (t + d),
                           2.0 * m_live * k * (t + d + 1), precision))
    print(f"  {label}: one launch {rec['ms']:.3f} ms against K1 on each live "
          f"lane's rows {rec['k1_sum_ms']:.3f} ms in all, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}; K = {k}); no single PyTorch call computes "
          f"it")
    return rec


def _p19_rank(rank, world, workdir):
    """(f): one rank of a (2, 1) mesh on the card: the fleet of the saved
    tenants in 'scan', then each tenant's sharded solo fit; writes
    p19_rank<r>.json."""
    import torch

    from cuda_gmm_mpi_tpu_torch import fit_gmm
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.parallel import distributed
    from cuda_gmm_mpi_tpu_torch.tenancy import TenantSpec, fit_fleet

    workdir = Path(workdir)
    distributed.initialize("cuda", coordinator=f"file://{workdir}/store19",
                           num_processes=world, process_id=rank,
                           timeout_s=P19_TIMEOUT_S)
    try:
        saved = np.load(workdir / "p19_mesh.npz")
        tenants = [TenantSpec(f"m{i}", saved[f"x{i}"], int(saved["k"][i]),
                              int(saved["target"][i]))
                   for i in range(len(saved["k"]))]
        cfg = p19_config(mesh_shape=(2, 1), chunk_size=P19_MESH_CHUNK)
        _zero_fleet_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet = fit_fleet(tenants, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _fleet_counts()
        same = [_same_result(fleet[t.name].result, fit_gmm(
            t.data, t.num_clusters, t.target_num_clusters, config=cfg))
            for t in tenants]
        rec = dict(rank=rank, same=same, launches=counts, wall_s=wall,
                   backend=fleet.tenants[0].result.model.estep_backend,
                   iters=sum(r[3] for t in fleet.tenants
                             for r in t.result.sweep_log),
                   ks=sum(len(t.result.sweep_log) for t in fleet.tenants),
                   collective=fleet.tenants[0].result.model.collective_backend)
        (workdir / f"p19_rank{rank}.json").write_text(json.dumps(rec))
    finally:
        distributed.shutdown()


def _p19_mesh(workdir: Path) -> list:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_p19_rank, args=(2, str(workdir)), nprocs=2,
                             join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > P19_TIMEOUT_S:
                raise PhaseError(f"phase 19 ranks still running after "
                                 f"{P19_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise PhaseError(f"a phase 19 rank failed: {e}") from None
    except mp.ProcessExitedException as e:
        raise PhaseError(f"a phase 19 rank died: {e}") from None
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        stop_resource_tracker()
    return [json.loads((workdir / f"p19_rank{r}.json").read_text())
            for r in range(2)]


def phase_fleet(workdir: Path, seed: int, card: str) -> dict:
    """Phase 19: multi-tenant fleet fits on the card (see the module
    docstring)."""
    import torch

    from cuda_gmm_mpi_tpu_torch import GMMModel, fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.cli import main as cli_main
    from cuda_gmm_mpi_tpu_torch.io import write_bin
    from cuda_gmm_mpi_tpu_torch.tenancy import fit_fleet
    from cuda_gmm_mpi_tpu_torch.testing import faults

    t_phase = time.perf_counter()
    tenants = p19_tenants(seed)
    packed_mb = (P19_GROUPS[0][0] * P19_GROUPS[0][2]
                 + P19_GROUPS[1][0] * P19_GROUPS[1][2]) * DIMS * 4 / 1e6
    print(f"  {len(tenants)} tenants (D = {DIMS}, float32): "
          f"{P19_GROUPS[0][0]} of {P19_GROUPS[0][1]}-{P19_GROUPS[0][2]} "
          f"events at K = {P19_GROUPS[0][3]}, {P19_GROUPS[1][0]} of "
          f"{P19_GROUPS[1][1]}-{P19_GROUPS[1][2]} at K = {P19_GROUPS[1][3]}; "
          f"{packed_mb:.1f} MB of packed events; {card}")
    out = {}

    # (a) K3's per-lane-events form.
    out["a"] = {"full": p19_k3_form(tenants, False),
                "diag": p19_k3_form(tenants, True)}
    for prec in BF16_PASSES:
        p19_k3_form(tenants, False, prec, timed=False)
        p19_k3_form(tenants, True, prec, timed=False)

    # (b) 'scan' against the sequential solo fits.
    cfg = p19_config()
    model = GMMModel(cfg)
    _zero_fleet_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan = fit_fleet(tenants, cfg, model=model)
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    counts = _fleet_counts()
    check(not scan.dropped, "phase 19 (b): a tenant was dropped")
    iters = sum(r[3] for t in scan.tenants for r in t.result.sweep_log)
    ks = sum(len(t.result.sweep_log) for t in scan.tenants)
    check(counts["K1"] == iters + ks and counts["K2"] == iters,
          f"phase 19 (b): K1/K2 launches {counts['K1']}/{counts['K2']}, "
          f"the lanes' iterations {iters} + initial E-steps {ks}")
    check(counts["K3"] == counts["K4"] == counts["K3 fleet"] == 0,
          f"phase 19 (b): batched launches in 'scan': {counts}")
    check(counts["K1 narrow"] == counts["K1"],
          f"phase 19 (b): {counts['K1 narrow']} of {counts['K1']} K1 "
          f"launches on the narrow route (every tenant has K <= 16)")
    captures = [s for _, s in model.capture_log]
    check(len(captures) == len(tenants),
          f"phase 19 (b): {len(captures)} captures for {len(tenants)} lanes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solos = {t.name: fit_gmm(t.data, t.num_clusters, t.target_num_clusters,
                             config=cfg) for t in tenants}
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    for t in tenants:
        check(_same_result(scan[t.name].result, solos[t.name]),
              f"phase 19 (b): tenant {t.name} differs from its solo fit")
    # The design's alternative, the host loop on each lane, on the second
    # group (the same packed group as in the fleet above).
    second = [t for t in tenants if len(t.data) <= P19_GROUPS[1][2]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = fit_fleet(second, cfg, model=GMMModel(cfg, _eager_em=True))
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    for t in second:
        check(_same_result(eager[t.name].result, scan[t.name].result),
              f"phase 19 (b): tenant {t.name}'s eager lane differs from its "
              f"captured one")
    g2 = next(g for g in scan.groups if g["n_bucket"] == P19_GROUPS[1][2])
    iters2 = sum(r[3] for t in second for r in scan[t.name].result.sweep_log)
    out["b"] = dict(launches=counts, wall_s=scan_wall, solo_wall_s=solo_wall,
                    second_group_s=g2["seconds"],
                    second_group_eager_s=eager_wall,
                    second_group_iterations=iters2,
                    lane_iterations=iters, ks=ks,
                    lane_iterations_per_s=iters / scan_wall,
                    solo_iterations_per_s=iters / solo_wall,
                    capture_s_total=sum(captures),
                    capture_s_per_lane=sum(captures) / max(len(captures), 1),
                    groups=scan.groups)
    print(f"  (b) 'scan': {len(tenants)} tenants torch.equal to their solo "
          f"fits (K, merges, sweep log, loglik, every state field); K1 "
          f"{counts['K1']} = {iters} lane iterations + {ks} initial E-steps, "
          f"K2 {counts['K2']}; fleet {scan_wall:.2f} s against {solo_wall:.2f}"
          f" s for the {len(tenants)} solo fits one after another "
          f"({iters / scan_wall:.0f} against {iters / solo_wall:.0f} lane "
          f"iterations/s); {len(captures)} captured programs, "
          f"{sum(captures):.2f} s of capture "
          f"({out['b']['capture_s_per_lane']:.3f} s per lane); the second "
          f"group's {len(second)} lanes {g2['seconds']:.2f} s captured against "
          f"{eager_wall:.2f} s on the host loop ({iters2 / g2['seconds']:.0f} "
          f"against {iters2 / eager_wall:.0f} lane iterations/s), torch.equal")

    # (c) 'vmap'.
    vcfg = p19_config(fleet_mode="vmap")
    _zero_fleet_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vmap = fit_fleet(tenants, vcfg)
    torch.cuda.synchronize()
    vmap_wall = time.perf_counter() - t0
    vcounts = _fleet_counts()
    steps = sum(max(len(t.result.sweep_log) for t in vmap.tenants
                    if t.group == g) for g in range(len(vmap.groups)))
    check(vcounts["K3 fleet"] == steps * (P19_ITERS + 1)
          and vcounts["K4"] == steps * P19_ITERS,
          f"phase 19 (c): K3 (per-lane events)/K4 launches "
          f"{vcounts['K3 fleet']}/{vcounts['K4']} for {steps} group steps")
    check(vcounts["K1"] == vcounts["K2"] == vcounts["K3"] == 0,
          f"phase 19 (c): K1/K2/K3 launched in 'vmap': {vcounts}")
    check(vcounts["K3 fleet narrow"] == vcounts["K3 fleet"],
          f"phase 19 (c): {vcounts['K3 fleet narrow']} of "
          f"{vcounts['K3 fleet']} launches of the per-lane form on the "
          f"narrow route")
    equal_b = 0
    for t in tenants:
        r, s = vmap[t.name].result, solos[t.name]
        check(r is not None and r.ideal_num_clusters == s.ideal_num_clusters
              and [m[1] for m in r.merges] == [m[1] for m in s.merges],
              f"phase 19 (c): tenant {t.name}'s K or merge pairs differ "
              f"from its solo fit")
        check(abs(r.final_loglik - s.final_loglik)
              <= 1e-5 * abs(s.final_loglik),
              f"phase 19 (c): tenant {t.name} loglik {r.final_loglik} vs "
              f"solo {s.final_loglik}")
        equal_b += _same_result(r, scan[t.name].result)
    viters = sum(r[3] for t in vmap.tenants for r in t.result.sweep_log)
    out["c"] = dict(launches=vcounts, wall_s=vmap_wall, group_steps=steps,
                    lane_iterations_per_s=viters / vmap_wall,
                    torch_equal_to_scan=equal_b)
    print(f"  (c) 'vmap': every tenant's K and merge pairs those of its solo "
          f"fit, loglik within 1e-5; K3 (per-lane events) {vcounts['K3 fleet']}"
          f" and K4 {vcounts['K4']} launches for {steps} group steps, no "
          f"K1/K2; {equal_b} of {len(tenants)} tenants torch.equal to 'scan';"
          f" {vmap_wall:.2f} s ({viters / vmap_wall:.0f} lane iterations/s)")

    # (d) Drop-one and preempt/resume on the second group alone (the same
    # packed group as in (b)).
    with faults.use({"nan_loglik": {"iter": 2, "restart": 1}}):
        dropped = fit_fleet(second, cfg)
    check([t.name for t in dropped.dropped] == [second[1].name],
          f"phase 19 (d): dropped {[t.name for t in dropped.dropped]}, "
          f"not lane 1 ({second[1].name})")
    for t in second[:1] + second[2:]:
        check(_same_result(dropped[t.name].result, scan[t.name].result),
              f"phase 19 (d): survivor {t.name} differs from the clean run")
    ck = workdir / "p19_ck"
    ccfg = p19_config(checkpoint_dir=str(ck))
    try:
        with faults.use({"preempt": {"iter": 2}}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            fit_fleet(second, ccfg)
        raise PhaseError("phase 19 (d): the preempt did not stop the fleet")
    except supervisor.PreemptedError:
        pass
    resumed = fit_fleet(second, ccfg)
    for t in second:
        check(_same_result(resumed[t.name].result, scan[t.name].result),
              f"phase 19 (d): resumed tenant {t.name} differs from the "
              f"clean run")
    print(f"  (d) nan_loglik on lane 1 dropped {second[1].name}, the other "
          f"{len(second) - 1} == the clean run; a preempt at step 2 then its "
          f"resume == the clean run for all {len(second)}")

    # (e) gmm fleet on BIN files, against the solo CLI, and export --fleet.
    cli_t = second[:P19_CLI]
    entries = []
    for t in cli_t:
        path = workdir / f"{t.name}.bin"
        write_bin(str(path), t.data)
        entries.append({"name": t.name, "infile": str(path),
                        "num_clusters": t.num_clusters,
                        "target_num_clusters": t.target_num_clusters})
    (workdir / "manifest.json").write_text(json.dumps(entries))
    flags = ["--min-iters", str(P19_ITERS), "--max-iters", str(P19_ITERS),
             "--chunk-size", str(P19_CHUNK)]
    rc = cli_main(["fleet", str(workdir / "manifest.json"), "--out-dir",
                   str(workdir / "fleet_out"), "--registry",
                   str(workdir / "reg")] + flags)
    check(rc == 0, f"phase 19 (e): gmm fleet exited {rc}")
    for e in entries:
        rc = cli_main([str(e["num_clusters"]), e["infile"],
                       str(workdir / f"solo_{e['name']}"),
                       str(e["target_num_clusters"]), "--sweep-k-buckets",
                       "off"] + flags)
        check(rc == 0, f"phase 19 (e): the solo CLI exited {rc}")
        a = (workdir / "fleet_out" / f"{e['name']}.summary").read_bytes()
        b = (workdir / f"solo_{e['name']}.summary").read_bytes()
        check(a == b, f"phase 19 (e): {e['name']}.summary differs from the "
              f"solo CLI's")
    manifest = json.loads((workdir / "fleet_out" / "fleet.json").read_text())
    check(all(r.get("registry_version") == 1 for r in manifest["tenants"]),
          "phase 19 (e): gmm fleet --registry did not export every tenant")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["export", "--registry", str(workdir / "reg2"),
                       "--fleet", str(workdir / "fleet_out")])
    check(rc == 0 and f"{P19_CLI}/{P19_CLI} tenants exported" in buf.getvalue(),
          f"phase 19 (e): gmm export --fleet: rc {rc}, {buf.getvalue()!r}")
    print(f"  (e) gmm fleet on {P19_CLI} BIN files: each .summary byte-"
          f"identical to the solo CLI's (--sweep-k-buckets off, the fleet's "
          f"fixed width), {P19_CLI} registry versions, gmm export --fleet "
          f"{P19_CLI}/{P19_CLI}")

    # (f) A (2, 1) mesh of 2 ranks on the card.
    mesh_t = second[:P19_MESH]
    np.savez(workdir / "p19_mesh.npz",
             k=np.asarray([t.num_clusters for t in mesh_t]),
             target=np.asarray([t.target_num_clusters for t in mesh_t]),
             **{f"x{i}": t.data for i, t in enumerate(mesh_t)})
    ranks = _p19_mesh(workdir)
    for r in ranks:
        check(all(r["same"]), f"phase 19 (f): rank {r['rank']}: tenants "
              f"{[i for i, s in enumerate(r['same']) if not s]} differ from "
              f"the sharded solo fits")
        check(r["launches"]["K1"] == r["iters"] + r["ks"]
              and r["launches"]["K2"] == r["iters"],
              f"phase 19 (f): rank {r['rank']} launches {r['launches']}")
    out["f"] = [dict(rank=r["rank"], launches=r["launches"],
                     wall_s=r["wall_s"], collective=r["collective"])
                for r in ranks]
    print(f"  (f) (2, 1) mesh ({ranks[0]['collective']}, 2 ranks on the "
          f"card): {P19_MESH} tenants in 'scan' torch.equal to the sharded "
          f"solo fits on both ranks; K1/K2 per rank "
          f"{[r['launches']['K1'] for r in ranks]}/"
          f"{[r['launches']['K2'] for r in ranks]}; fleet "
          f"{max(r['wall_s'] for r in ranks):.2f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 19: {out['wall_s']:.1f} s")
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

    phase_start("phase 1: build")
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

    phase_start("phase 2: K1 against its plain version")
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
    # The narrow route at K <= 64: K1 at K = 16 and 64, K3 at K = 16.
    k1_narrow = {(k, diag): phase_k1_narrow(
        data, diag, k, f"{'diag' if diag else 'full'} K={k} (narrow)",
        clocks if k == NARROW_KS[0] else None)
        for k in NARROW_KS for diag in (False, True)}
    k3_narrow = {diag: phase_k3_narrow(
        data, diag, NARROW_KS[0], f"{'diag' if diag else 'full'} "
        f"K={NARROW_KS[0]} (narrow)") for diag in (False, True)}

    phase_start("phase 3: K2 against its plain version and the torch-ops M-step")
    k2_full = phase_k2(state_full, out_full, False, "full", args.seed)
    k2_diag = phase_k2(state_diag, out_diag, True, "diag", args.seed)

    phase_start("phase 4: the main path")
    workdir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        launches, main_result, main_io = phase_main_path(data, workdir)
        diag_ref = phase_diag(data)
        phase_small_reference(args.seed)
        em_profile = profile_em(data)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    phase_start("phase 5: K3 against K1 and its plain version; the batched EM loop")
    x_c, rows = restart_rows(data, args.seed)
    lanes_full = restart_lanes(x_c, rows, False)
    k3_full, k3_out = phase_k3(lanes_full, False, "full")
    phase_em_batched(lanes_full)
    lanes_diag = restart_lanes(x_c, rows, True)
    k3_diag, k3_out_diag = phase_k3(lanes_diag, True, "diag")

    phase_start("phase 6: K4 against its plain version, K2 and the torch-ops M-step")
    k4_full = phase_k4(lanes_full[0], k3_out, False, "full", args.seed)
    k4_diag = phase_k4(lanes_diag[0], k3_out_diag, True, "diag", args.seed)
    del lanes_full, lanes_diag, k3_out, k3_out_diag, x_c

    phase_start("phase 7: the restart path")
    restart_launches = phase_restarts(data)
    launches.update(K3=restart_launches["K3"], K4=restart_launches["K4"])

    phase_start("phase 8: K5 and K6 against their plain versions and K1")
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

    phase_start("phase 9: the mesh path on the one card")
    meshdir = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
    shutil.rmtree(meshdir, ignore_errors=True)
    meshdir.mkdir(parents=True)
    try:
        mesh = phase_mesh(data, diag_ref, meshdir)
    finally:
        shutil.rmtree(meshdir, ignore_errors=True)
    launches.update(K5=mesh["launches"]["K5"], K6=mesh["launches"]["K6"])

    phase_start("phase 10: K1 and K3 in 'high' and 'default'; the main and restart "
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

    phase_start("phase 11: GaussianMixture at the north-star shape: the four "
          "families, a BIC search, sample weights, inference and the CLI")
    estdir = Path(__file__).resolve().parent / "build" / "chip_smoke_estimator"
    shutil.rmtree(estdir, ignore_errors=True)
    estdir.mkdir(parents=True)
    try:
        estimator = phase_estimator(data, estdir, args.seed)
    finally:
        shutil.rmtree(estdir, ignore_errors=True)

    phase_start("phase 12: containment and resume on the card")
    condir = Path(__file__).resolve().parent / "build" / "chip_smoke_contain"
    shutil.rmtree(condir, ignore_errors=True)
    condir.mkdir(parents=True)
    try:
        containment = phase_containment(data, main_result,
                                        main_io["em_iters_per_s"], condir,
                                        args.parent, args.seed)
    finally:
        shutil.rmtree(condir, ignore_errors=True)

    phase_start("phase 13: the captured EM loop and the fused sweep")
    capdir = Path(__file__).resolve().parent / "build" / "chip_smoke_capture"
    shutil.rmtree(capdir, ignore_errors=True)
    capdir.mkdir(parents=True)
    try:
        capture = phase_capture(data, main_result, capdir)
    finally:
        shutil.rmtree(capdir, ignore_errors=True)

    phase_start("phase 14: the fit's observability: the observed fit, its costs, "
          "--trace-dir and the port's stream tools")
    obsdir = Path(__file__).resolve().parent / "build" / "chip_smoke_observe"
    shutil.rmtree(obsdir, ignore_errors=True)
    obsdir.mkdir(parents=True)
    try:
        phase_observability(data, main_result, obsdir)
    finally:
        shutil.rmtree(obsdir, ignore_errors=True)

    phase_start("phase 15: the mesh made whole: restarts on a mesh, preempt and "
          "resume, peer loss, per-rank reading and output")
    wholedir = Path(__file__).resolve().parent / "build" / "chip_smoke_whole"
    shutil.rmtree(wholedir, ignore_errors=True)
    wholedir.mkdir(parents=True)
    try:
        whole = phase_mesh_whole(data, wholedir, card, args.seed)
    finally:
        shutil.rmtree(wholedir, ignore_errors=True)

    phase_start("phase 16: out-of-core EM: in-memory, resident and pipelined "
          "streaming at 10M events, one pass profiled, stepwise EM, stop "
          "and resume, a data mesh")
    oocdir = Path(__file__).resolve().parent / "build" / "chip_smoke_ooc"
    shutil.rmtree(oocdir, ignore_errors=True)
    oocdir.mkdir(parents=True)
    try:
        ooc = phase_out_of_core(data, oocdir, card, args.seed)
    finally:
        shutil.rmtree(oocdir, ignore_errors=True)

    phase_start("phase 17: serving at full width: S1 against its plain version, "
          "the serving contracts, the warm path, latency and HTTP workers")
    servedir = Path(__file__).resolve().parent / "build" / "chip_smoke_serve"
    shutil.rmtree(servedir, ignore_errors=True)
    servedir.mkdir(parents=True)
    try:
        serving = phase_serving(data, main_result, diag_ref[0], servedir,
                                card)
    finally:
        shutil.rmtree(servedir, ignore_errors=True)

    phase_start("phase 18: tuning and the lifecycle at full width: gmm tune, an "
          "--autotune db fit and serve, the drift -> retrain -> canary -> "
          "promote -> watch arc and a rejected canary")
    tunedir = Path(__file__).resolve().parent / "build" / "chip_smoke_tune"
    shutil.rmtree(tunedir, ignore_errors=True)
    tunedir.mkdir(parents=True)
    try:
        tuning = phase_tuning_lifecycle(data, main_result, tunedir, card)
    finally:
        shutil.rmtree(tunedir, ignore_errors=True)

    phase_start("phase 19: multi-tenant fleet fits: K3's per-lane-events form, "
          "'scan' against the solo fits, 'vmap', drop-one and resume, gmm "
          "fleet and a (2, 1) mesh")
    fleetdir = Path(__file__).resolve().parent / "build" / "chip_smoke_fleet"
    shutil.rmtree(fleetdir, ignore_errors=True)
    fleetdir.mkdir(parents=True)
    try:
        fleet = phase_fleet(fleetdir, args.seed, card)
    finally:
        shutil.rmtree(fleetdir, ignore_errors=True)

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
        s1_record(serving),
        s1_centered_record(serving),
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
    # Phase 15 (g): the fused sweep on a mesh, each rank's launches counted
    # from 0 around it, its wall beside the host sweep's at 'off'.
    for i, key, mesh_key in ((0, "K1", "2x1"), (1, "K2", "2x1"),
                             (4, "K5", "1x2"), (5, "K6", "1x2")):
        kernels[i]["mesh_fused_sweep"] = [dict(
            rank=x["rank"], mesh=mesh_key, launches=x["launches"][key],
            fused_wall_s=x["fused_wall_s"], host_wall_s=x["host_wall_s"])
            for x in whole["g"][mesh_key]]
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
    # Phase 18's lifecycle refit (stepwise EM) and its canary, counted
    # from 0 around the retrain tick.
    kernels[0]["lifecycle_refit"] = tuning["d"]["refit_launches"]["K1"]
    kernels[1]["lifecycle_refit"] = tuning["d"]["refit_launches"]["K2"]
    kernels[6]["lifecycle"] = dict(
        canary=tuning["d"]["refit_launches"]["S1"],
        shadow=tuning["d"]["shadow_s1_launches"])
    kernels[6]["tuning"] = dict(probe=tuning["a"], fit=tuning["b"],
                                serve=tuning["c"])
    # Phase 19's fleet: K1/K2 counted from 0 around the 'scan' fleet, K3's
    # per-lane-events form and K4 around the 'vmap' one.
    fa = fleet["a"]
    kernels.append(dict(
        name="K3 fused_stats_fleet (per-lane events)", route="cuda",
        source=src + "fused_stats.cu", replaces=pallas + "475",
        launches=fleet["c"]["launches"]["K3 fleet"],
        max_abs_err=max(fa["full"]["max_abs_err"], fa["diag"]["max_abs_err"]),
        fp64_err=fa["full"]["fp64_err"],
        plain_fp64_err=fa["full"]["plain_fp64_err"], ms=fa["full"]["ms"],
        plain_ms=fa["full"]["plain_ms"], bound_ms=fa["full"]["bound_ms"],
        bound_by=fa["full"]["bound_by"],
        fp32_bound_ms=fa["full"]["fp32_bound_ms"], library_ms=None,
        k1_sum_ms=fa["full"]["k1_sum_ms"], lanes=fa["full"]["lanes"],
        live_lanes=fa["full"]["live_lanes"], events=fa["full"]["events"],
        diag_ms=fa["diag"]["ms"], diag_plain_ms=fa["diag"]["plain_ms"],
        diag_bound_ms=fa["diag"]["bound_ms"],
        diag_k1_sum_ms=fa["diag"]["k1_sum_ms"]))
    # The narrow route (K_pad 16, 32 or 64 at 'highest'): K1's launches
    # counted from 0 around phase 19 (b)'s 'scan' fleet, K3's around phase
    # 11's restart fit at K 16, the per-lane form's around phase 19 (c).
    k1n = k1_narrow[NARROW_KS[0], False]
    kernels.append(dict(
        name="K1 fused_stats narrow (K <= 64)", route="cuda",
        source=src + "fused_stats.cu", replaces=pallas + "94",
        launches=fleet["b"]["launches"]["K1 narrow"],
        bic_launches=estimator["bic"]["narrow_k1_launches"],
        max_abs_err=max(r["max_abs_err"] for r in k1_narrow.values()),
        ms=k1n["ms"], plain_ms=k1n["plain_ms"], bound_ms=k1n["bound_ms"],
        bound_by=k1n["bound_by"], fp32_bound_ms=k1n["fp32_bound_ms"],
        library_ms=None, wide_ms=k1n["wide_ms"],
        phase_shares=k1n.get("phase_shares"),
        cases={f"{'diag' if dg else 'full'} K={k}": r
               for (k, dg), r in k1_narrow.items()}))
    k3n = k3_narrow[False]
    kernels.append(dict(
        name="K3 fused_stats_batched narrow (K <= 64)", route="cuda",
        source=src + "fused_stats.cu", replaces=pallas + "475",
        launches=estimator["restarts_k16"]["narrow_k3_launches"],
        max_abs_err=max(r["max_abs_err"] for r in k3_narrow.values()),
        ms=k3n["ms"], plain_ms=k3n["plain_ms"], bound_ms=k3n["bound_ms"],
        bound_by=k3n["bound_by"], fp32_bound_ms=k3n["fp32_bound_ms"],
        library_ms=None, wide_ms=k3n["wide_ms"], diag=k3_narrow[True]))
    kernels.append(dict(
        name="K3 fused_stats_fleet narrow (per-lane events, K <= 64)",
        route="cuda", source=src + "fused_stats.cu", replaces=pallas + "475",
        launches=fleet["c"]["launches"]["K3 fleet narrow"],
        max_abs_err=max(fa["full"]["max_abs_err"], fa["diag"]["max_abs_err"]),
        ms=fa["full"]["ms"], plain_ms=fa["full"]["plain_ms"],
        bound_ms=fa["full"]["bound_ms"], bound_by=fa["full"]["bound_by"],
        fp32_bound_ms=fa["full"]["fp32_bound_ms"], library_ms=None,
        width_ms=fa["full"]["width_ms"],
        diag_width_ms=fa["diag"]["width_ms"]))
    scan_rec = {k: v for k, v in fleet["b"].items() if k != "launches"}
    vmap_rec = {k: v for k, v in fleet["c"].items() if k != "launches"}
    kernels[0]["fleet"] = dict(scan=fleet["b"]["launches"]["K1"],
                               mesh_ranks=[r["launches"]["K1"]
                                           for r in fleet["f"]], **scan_rec)
    kernels[1]["fleet"] = dict(scan=fleet["b"]["launches"]["K2"],
                               mesh_ranks=[r["launches"]["K2"]
                                           for r in fleet["f"]])
    kernels[2]["fleet"] = dict(per_lane_events=fleet["c"]["launches"][
        "K3 fleet"], shared_events=fleet["c"]["launches"]["K3"], **vmap_rec)
    kernels[3]["fleet"] = dict(vmap=fleet["c"]["launches"]["K4"])
    kernels[0]["estimator"] = estimator
    kernels[0]["containment"] = containment
    kernels[0]["capture"] = capture
    phase_end()
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
