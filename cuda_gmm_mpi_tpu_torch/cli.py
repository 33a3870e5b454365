"""Command-line entry point: ``python -m cuda_gmm_mpi_tpu_torch.cli num_clusters
infile outfile [target_num_clusters]``.

The reference's positional CLI (``gaussian.cu:1111-1178``, ``README.txt:
66-70``), run by the PyTorch/CUDA port. Argument validation mirrors
validateArguments: a missing infile exits 2, num_clusters outside
[1, max_clusters] exits 1, target_num_clusters > num_clusters exits 4. An
absent target means "search down to 1, keep the best Rissanen score".

The mesh path runs one process per rank (one per GPU with NCCL), every rank
with the same command:

    torchrun --nproc-per-node=R -m cuda_gmm_mpi_tpu_torch.cli K infile outfile [target] --mesh DATA,CLUSTER

or with ``--coordinator HOST:PORT --num-processes R --process-id I`` on each
rank in place of torchrun. Each rank reads only its block of the events
(a range read of the file), computes the memberships of its own rows on
its own device and writes them as a ``.results`` part (beside the output,
or in ``--part-dir``); rank 0 writes the ``.summary`` and assembles the
parts. With ``--checkpoint-dir`` every rank heartbeats into
``<dir>/heartbeats``: a peer silent for ``--peer-timeout`` seconds stops
the others with exit 75 instead of a hang, and ``--elastic`` shrinks the
world over the survivors and finishes the fit there.

``--init-from MODEL.summary`` seeds the fit's means from a saved model;
``--predict-from MODEL.summary`` fits nothing and writes the memberships of
infile under a saved model (the num_clusters positional is ignored).

Fault containment and resume (the JAX CLI's exit codes): a numerical fault
that the recovery ladder cannot cure (or ``--recovery=off``) exits 70 and
writes no model; unreadable checkpoints, or a torn input file, exit 74; a
run stopped by SIGTERM/SIGINT or ``--max-runtime`` exits 75 after an
emergency checkpoint (with ``--checkpoint-dir``), and the same command
with ``--resume auto`` (the default) continues inside the interrupted fit.
``--metrics-file`` writes the JSONL event stream.

Out of core (the JAX CLI's flags): ``--stream-events`` streams the events
through the device block by block on every pass (K1 per block on the
card); ``--ingest=pipelined`` never reads the file whole (a worker thread
reads each block's rows, and the memberships pass reads the file block by
block too); ``--em-mode=minibatch`` runs stepwise EM over
``--minibatch-size`` events per step.

Observability (the JAX CLI's): ``--profile`` prints the seven-category
phase table (gaussian.cu:967), the I/O time and the EM time;
``--trace-dir DIR`` writes a torch.profiler Chrome trace of the fit;
``--metrics-port PORT`` serves OpenMetrics text on 127.0.0.1:PORT/metrics
during the fit and emits trace spans. The subcommands read recorded
streams and touch no device:

    python -m cuda_gmm_mpi_tpu_torch.cli report STREAM [--validate] [--json] [--follow]
    python -m cuda_gmm_mpi_tpu_torch.cli top STREAM      (report --follow)
    python -m cuda_gmm_mpi_tpu_torch.cli diff A B [--fail-on SPEC]
    python -m cuda_gmm_mpi_tpu_torch.cli runs DIR
    python -m cuda_gmm_mpi_tpu_torch.cli timeline RUN [RUN ...] [--validate]

``fleet MANIFEST [--out-dir DIR] [--registry DIR]`` fits a manifest of
per-tenant input files as packed multi-tenant groups (tenancy/cli.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmm-torch",
        description="GMM-EM clustering with Rissanen model-order search on "
        "PyTorch/CUDA (capabilities of CUDA-GMM-MPI's gaussianMPI).")
    from ._version import __version__

    p.add_argument("--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("num_clusters", type=int, help="number of starting clusters")
    p.add_argument("infile", help="input data: CSV (first line = header) or "
                   "*.bin (int32 N, int32 D, float32 data)")
    p.add_argument("outfile", help="output basename; writes "
                   "<outfile>.summary and <outfile>.results")
    p.add_argument("target_num_clusters", type=int, nargs="?", default=0,
                   help="desired number of clusters (<= num_clusters); "
                   "omit to search for the best Rissanen score")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default cuda; no silent CPU fallback)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"], help="compute dtype")
    p.add_argument("--diag-only", action="store_true",
                   help="diagonal covariance (DIAG_ONLY, gaussian.h:23); "
                   "shorthand for --covariance-type=diag")
    p.add_argument("--covariance-type", default="full",
                   choices=["full", "diag", "spherical", "tied"],
                   help="covariance family: the reference's full/diag plus "
                   "spherical (sigma^2 I per cluster) and tied (one shared "
                   "covariance)")
    p.add_argument("--criterion", default="rissanen",
                   choices=["rissanen", "bic", "aic", "aicc"],
                   help="model-order selection score: the reference's "
                   "Rissanen/MDL (gaussian.cu:826), or BIC/AIC/AICc with "
                   "the family's free-parameter count")
    p.add_argument("--min-iters", type=int, default=100,
                   help="MIN_ITERS (gaussian.h:27)")
    p.add_argument("--max-iters", type=int, default=100,
                   help="MAX_ITERS (gaussian.h:26)")
    p.add_argument("--max-clusters", type=int, default=512,
                   help="MAX_CLUSTERS bound for num_clusters (gaussian.h:10)")
    p.add_argument("--dynamic-range", type=float, default=1e3,
                   help="COVARIANCE_DYNAMIC_RANGE regularizer (gaussian.h:12)")
    p.add_argument("--epsilon-scale", type=float, default=0.01,
                   help="convergence epsilon scale (gaussian.cu:458)")
    p.add_argument("--chunk-size", type=int, default=65536,
                   help="events per fused E+M pass")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "default"],
                   help="matmul precision: 'highest' = fp32-class products, "
                   "'high' = three bf16 passes (bf16_3x), 'default' = one "
                   "bf16 pass; the same arithmetic in the kernels and on "
                   "torch ops")
    p.add_argument("--quad-mode", default="expanded",
                   choices=["expanded", "packed", "centered"],
                   help="quadratic-form evaluation strategy: 'packed' uses "
                   "the upper-triangle features; 'centered' stages x - mu "
                   "explicitly (most stable; torch ops only)")
    p.add_argument("--no-center", action="store_true",
                   help="disable global data centering")
    p.add_argument("--precompute-features", action="store_true",
                   help="hoist the [N, F] outer-product features out of the "
                   "EM loop on torch ops (built once, held in device "
                   "memory: N*F*4 bytes); full-covariance runs only")
    p.add_argument("--estep-backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="statistics path: 'cuda' = the hand-written kernels, "
                   "'torch' = torch ops; 'auto' = kernels on a CUDA device "
                   "at float32, torch ops otherwise")
    p.add_argument("--seed-method", default="even",
                   choices=["even", "kmeans++"],
                   help="initial means: reference evenly-spaced rows, or "
                   "k-means++ D^2-weighted sampling (--seed sets its RNG)")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for randomized paths (kmeans++ seeding)")
    p.add_argument("--n-init", type=int, default=1,
                   help="independent restarts with varied kmeans++ seeds; "
                   "best Rissanen kept (1 = reference single-init)")
    p.add_argument("--restart-batch-size", type=int, default=None,
                   metavar="R",
                   help="restarts per batched EM loop (one K3 + one K4 "
                   "launch per iteration of the whole batch on the "
                   "kernels). Default: sized from a memory budget "
                   "(GMM_RESTART_MEM_BYTES overrides it); 1 = "
                   "sequential restarts (same winner)")
    p.add_argument("--mesh", default=None,
                   help="rank mesh 'DATA[,CLUSTER]', e.g. --mesh=4 or "
                   "--mesh=2,2 (product = the world size); default: every "
                   "rank on the event axis")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="status prints (ENABLE_PRINT, gaussian.h:35)")
    p.add_argument("--debug", action="store_true",
                   help="debug prints (ENABLE_DEBUG, gaussian.h:31)")
    p.add_argument("--fused-sweep", action="store_true",
                   help="run the whole model-order sweep as one device "
                   "program (fastest; composes with --checkpoint-dir and "
                   "--metrics-file via per-K emission -- per-K seconds are "
                   "whole-K spans)")
    p.add_argument("--sweep-k-buckets", default="pow2",
                   choices=["pow2", "off"],
                   help="cluster-width bucketing for the host-driven sweep: "
                   "'pow2' (default) recompacts the state to power-of-two "
                   "padded widths as K drops (~2x sweep-level FLOPs for "
                   "<= ceil(log2 K0)+1 compiled EM widths); 'off' keeps one "
                   "fixed width. The fused sweep is fixed-width by design")
    p.add_argument("--no-validate-input", action="store_true",
                   help="skip the NaN/Inf input-row check at load")
    p.add_argument("--autotune", default="off",
                   choices=["off", "db", "probe"],
                   help="profile-guided knob resolution (tuning/): 'db' "
                   "resolves unset tunable knobs (chunk size, E-step "
                   "backend, sweep bucketing, restart batch) from the "
                   "nearest recorded profile in the tuning database, "
                   "'probe' measures missing rows first (2-3 real EM "
                   "iterations per candidate). Explicitly-passed knobs are "
                   "never touched. Default off (byte-identical streams)")
    p.add_argument("--tuning-db", default=None, metavar="PATH",
                   help="tuning database path (default GMM_TUNING_DB or "
                   "~/.cache/gmm/tuning.json); `gmm tune` writes it")
    o = p.add_argument_group("out of core (models/streaming.py)")
    o.add_argument("--stream-events", action="store_true",
                   help="stream the event chunks through the device block "
                   "by block on every EM pass (N bounded by host memory, "
                   "not device memory; slower -- use only when the data "
                   "exceeds the device). Composes with --mesh=S to stream "
                   "each rank's slice")
    o.add_argument("--ingest", default="resident",
                   choices=["resident", "pipelined"],
                   help="how --stream-events chunks reach the host: "
                   "'resident' loads the rank's slice up front; 'pipelined' "
                   "reads each block's rows from the input file on a worker "
                   "thread while the device computes, so host memory is "
                   "O(queue depth x block) -- results bit-identical")
    o.add_argument("--ingest-queue-depth", type=int, default=4,
                   help="blocks --ingest=pipelined may read ahead")
    o.add_argument("--em-mode", default="full", choices=["full", "minibatch"],
                   help="'full' runs batch EM; 'minibatch' runs stepwise EM "
                   "(Cappe-Moulines decayed sufficient statistics) over "
                   "--minibatch-size events per step")
    o.add_argument("--minibatch-size", type=int, default=0,
                   help="events per stepwise-EM step (rounded up to whole "
                   "blocks); 0 = one block per step")
    o.add_argument("--minibatch-t0", type=float, default=2.0,
                   help="stepwise-EM step size (t + t0)^-alpha: t0")
    o.add_argument("--minibatch-alpha", type=float, default=0.7,
                   help="stepwise-EM step size (t + t0)^-alpha: alpha in "
                   "(0.5, 1]")
    p.add_argument("--init-from", default=None, metavar="MODEL.summary",
                   help="warm-start: initial means from a saved .summary "
                   "model (its K must equal num_clusters); covariances/"
                   "weights restart from the reference seed recipe")
    p.add_argument("--predict-from", default=None, metavar="MODEL.summary",
                   help="skip fitting: load a saved .summary model (this "
                   "package's, the JAX package's or the reference's own "
                   "output) and write <outfile>.results memberships for "
                   "infile under it; the num_clusters positional is ignored")
    t = p.add_argument_group("fault containment, checkpoints, telemetry")
    t.add_argument("--recovery", default="retry", choices=["retry", "off"],
                   help="what a FATAL health flag (non-finite loglik/"
                   "params) does: 'retry' rolls back and climbs the "
                   "escalation ladder (regularize -> centered -> highest "
                   "precision); 'off' exits 70 at once with a diagnostic "
                   "bundle. Detection is always on")
    t.add_argument("--max-recovery-attempts", type=int, default=3,
                   help="escalation rungs attempted per fault before "
                   "failing loudly")
    t.add_argument("--recovery-reseed-empty", action="store_true",
                   help="at a target-K fit, reseed empty clusters from "
                   "worst-fit events instead of eliminating them")
    t.add_argument("--allow-nonfinite", action="store_true",
                   help="drop NaN/Inf input rows at load (with a warning) "
                   "instead of rejecting the file; single-process runs only")
    t.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory of the K-sweep (resume with "
                   "the same path); the JAX CLI's npz layout")
    t.add_argument("--checkpoint-keep", type=int, default=2,
                   help="retained checkpoint steps (newest + fallbacks)")
    t.add_argument("--checkpoint-retries", type=int, default=3,
                   help="bounded retries (jittered backoff) of a failed "
                   "checkpoint write")
    t.add_argument("--max-runtime", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock budget: reaching it acts like SIGTERM "
                   "-- cooperative stop, emergency checkpoint (with "
                   "--checkpoint-dir), exit 75")
    t.add_argument("--resume", default="auto", choices=["auto", "never"],
                   help="'auto' resumes from the newest checkpoint, a "
                   "preempted run's mid-EM sub-step included; 'never' "
                   "starts fresh (checkpoints are still written)")
    t.add_argument("--preempt-poll-iters", type=int, default=25,
                   help="EM iterations between stop-flag checks inside a K "
                   "(with --checkpoint-dir)")
    t.add_argument("--metrics-file", default=None, metavar="FILE.jsonl",
                   help="run-scoped telemetry stream: the JAX CLI's "
                   "schema-versioned JSONL records (run_start, em_iter, "
                   "em_done, merge, health, recovery, run_summary, ...); "
                   "`python -m cuda_gmm_mpi_tpu_torch.cli report FILE` "
                   "renders it")
    t.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="live observability plane: serve Prometheus/"
                   "OpenMetrics text on 127.0.0.1:PORT/metrics (0 = "
                   "OS-assigned port), sample host RSS and device memory "
                   "onto heartbeat records, and emit trace spans around "
                   "the sweep / per-K EM / checkpoint phases (default: off)")
    t.add_argument("--profile", action="store_true",
                   help="per-phase timing report (reference profile_t "
                   "taxonomy)")
    t.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the fit (host "
                   "and, on the card, device activity) as a Chrome trace "
                   "into this directory")
    t.add_argument("--sweep-log", default=None, metavar="FILE.jsonl",
                   help="write the per-K sweep trajectory (num_clusters, "
                   "loglik, score, criterion, em_iters, seconds) as JSON "
                   "lines (rank 0)")
    t.add_argument("--no-output", action="store_true",
                   help="write an empty .summary and no .results "
                   "(ENABLE_OUTPUT off)")
    d = p.add_argument_group(
        "distributed (the reference's mpirun; run the SAME command on every "
        "rank, or launch with torchrun, which sets RANK and WORLD_SIZE)")
    d.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address (tcp://); with --num-processes "
                   "and --process-id. --num-processes=0 reads the world "
                   "from the environment (env://)")
    d.add_argument("--num-processes", type=int, default=None,
                   help="world size (MPI world size)")
    d.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (0-based)")
    d.add_argument("--part-dir", default=None,
                   help="directory of the ranks' .results parts (default: "
                   "beside the output); when rank 0 cannot see them there, "
                   "the parts come to it over the process group")
    d.add_argument("--peer-timeout", type=float, default=60.0,
                   metavar="SECONDS",
                   help="liveness watchdog (with --checkpoint-dir): a peer "
                   "rank whose heartbeat is stale beyond this stops the run "
                   "with exit 75 and an emergency checkpoint instead of a "
                   "hang in the next collective; 0 disables")
    d.add_argument("--elastic", action="store_true",
                   help="on a lost peer the survivors seal a shrunken "
                   "membership on the checkpoint filesystem, rebuild the "
                   "process group over themselves and finish the fit from "
                   "the newest checkpoint, instead of exiting 75. Requires "
                   "--checkpoint-dir")
    d.add_argument("--min-hosts", type=int, default=1, metavar="N",
                   help="smallest world --elastic may shrink to; a loss "
                   "below it exits 75 as without --elastic")
    return p


def _parse_mesh(spec):
    if not spec:
        return None
    parts = [int(x) for x in spec.split(",")]
    if len(parts) == 1:
        return (parts[0], 1)
    if len(parts) == 2:
        return tuple(parts)
    raise SystemExit("--mesh must be DATA or DATA,CLUSTER")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("report", "top"):
        # `report STREAM`: render a --metrics-file stream; `top` is
        # `report --follow`, a live one-screen view as the stream grows.
        from .telemetry import report_main

        return report_main((["--follow"] if argv[0] == "top" else [])
                           + argv[1:])
    if argv and argv[0] == "diff":
        # `diff A B`: cross-run regression analytics with --fail-on gates
        # (0 clean / 1 regressions / 2 usage).
        from .telemetry.diff import diff_main

        return diff_main(argv[1:])
    if argv and argv[0] == "runs":
        # `runs DIR`: index recorded run streams.
        from .telemetry.diff import runs_main

        return runs_main(argv[1:])
    if argv and argv[0] == "timeline":
        # `timeline RUN [RUN ...]`: one Chrome trace of recorded streams,
        # their clocks aligned.
        from .telemetry.timeline import timeline_main

        return timeline_main(argv[1:])
    if argv and argv[0] == "export":
        # `export`: persist a model (sweep checkpoint / .summary) into a
        # serving registry.
        from .serving.registry import export_main

        return export_main(argv[1:])
    if argv and argv[0] == "serve":
        # `serve`: the micro-batched scoring loop over a registry (JSONL
        # on stdin/file/socket, or --http [--workers N]).
        from .serving.server import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "drift":
        # `drift TARGET`: a serve stream or a dataset against a registry
        # version's training envelope (0 clean / 1 gates / 2 usage).
        from .telemetry.drift import drift_main

        return drift_main(argv[1:])
    if argv and argv[0] == "lifecycle":
        # `lifecycle STREAM`: the drift -> retrain -> canary -> promote
        # loop, offline, from a recorded serve stream against a registry;
        # the live form is `serve --lifecycle policy.json`.
        from .lifecycle.cli import lifecycle_main

        return lifecycle_main(argv[1:])
    if argv and argv[0] == "fleet":
        # `fleet MANIFEST`: fit a manifest of per-tenant input files as
        # packed multi-tenant groups (tenancy/).
        from .tenancy.cli import fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "tune":
        # `tune`: probe candidate knob settings at a shape, write the
        # tuning database, print the decision table a later --autotune db
        # run resolves from.
        from .tuning.cli import tune_main

        return tune_main(argv[1:])
    args = build_parser().parse_args(argv)

    from .config import GMMConfig
    from .parallel import distributed

    if not os.path.isfile(args.infile):
        print("Invalid infile.\n", file=sys.stderr)  # gaussian.cu:1130
        return 2
    try:
        config = GMMConfig(
            dtype=args.dtype, diag_only=args.diag_only,
            covariance_type=args.covariance_type, criterion=args.criterion,
            min_iters=args.min_iters, max_iters=args.max_iters,
            max_clusters=args.max_clusters,
            covariance_dynamic_range=args.dynamic_range,
            epsilon_scale=args.epsilon_scale, chunk_size=args.chunk_size,
            matmul_precision=args.precision, quad_mode=args.quad_mode,
            center_data=not args.no_center,
            precompute_features=args.precompute_features,
            estep_backend=args.estep_backend, device=args.device,
            enable_debug=args.debug,
            enable_print=args.verbose or args.debug, seed=args.seed,
            fused_sweep=args.fused_sweep,
            sweep_k_buckets=args.sweep_k_buckets,
            validate_input=not args.no_validate_input,
            seed_method=args.seed_method, n_init=args.n_init,
            restart_batch_size=args.restart_batch_size,
            mesh_shape=_parse_mesh(args.mesh),
            enable_output=not args.no_output, recovery=args.recovery,
            max_recovery_attempts=args.max_recovery_attempts,
            recovery_reseed_empty=args.recovery_reseed_empty,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_keep=args.checkpoint_keep,
            checkpoint_retries=args.checkpoint_retries,
            max_runtime_s=args.max_runtime, resume=args.resume,
            preempt_poll_iters=args.preempt_poll_iters,
            metrics_file=args.metrics_file, profile=args.profile,
            metrics_port=args.metrics_port,
            peer_timeout_s=args.peer_timeout, elastic=args.elastic,
            min_hosts=args.min_hosts, stream_events=args.stream_events,
            ingest=args.ingest, ingest_queue_depth=args.ingest_queue_depth,
            em_mode=args.em_mode, minibatch_size=args.minibatch_size,
            minibatch_t0=args.minibatch_t0,
            minibatch_alpha=args.minibatch_alpha,
            autotune=args.autotune, tuning_db=args.tuning_db)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.predict_from is not None:
        # Inference only: K comes from the model file, so the fit's
        # cluster-count checks do not apply; flags that only a fit reads
        # are refused rather than ignored.
        if (args.coordinator is not None or args.num_processes is not None
                or args.process_id is not None):
            print("--predict-from is a single-process mode", file=sys.stderr)
            return 1
        fit_only = [
            ("--init-from", args.init_from),
            ("--n-init", args.n_init != 1),
            ("--restart-batch-size", args.restart_batch_size is not None),
            ("--mesh", args.mesh),
            ("--seed-method", args.seed_method != "even"),
            ("--sweep-log", args.sweep_log),
            ("--metrics-file", args.metrics_file),
            ("--metrics-port", args.metrics_port is not None),
            ("--checkpoint-dir", args.checkpoint_dir),
            ("--fused-sweep", args.fused_sweep),
            ("--sweep-k-buckets", args.sweep_k_buckets != "pow2"),
            ("--part-dir", args.part_dir),
            ("--stream-events", args.stream_events),
            ("--ingest", args.ingest != "resident"),
            ("--em-mode", args.em_mode != "full"),
            ("--autotune", args.autotune != "off"),
        ]
        for flag, present in fit_only:
            if present:
                print(f"{flag} has no effect with --predict-from",
                      file=sys.stderr)
                return 1
        return _predict_main(args, config)
    if not (1 <= args.num_clusters <= config.max_clusters):
        print("Invalid number of starting clusters\n", file=sys.stderr)  # :1122
        return 1
    if args.target_num_clusters > args.num_clusters:
        print("target_num_clusters must be less than equal to num_clusters\n",
              file=sys.stderr)  # :1150
        return 4

    # MPI_Init equivalent (gaussian.cu:130-140): the distributed flags, or
    # torchrun's environment, bring up the world.
    try:
        rank, world = distributed.initialize(
            args.device, coordinator=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        return _run(args, config, rank, world)
    finally:
        distributed.shutdown()


def _run(args, config, rank: int, world: int) -> int:
    import dataclasses

    from . import supervisor
    from .health import NumericalFaultError
    from .io import read_summary
    from .models.order_search import default_model
    from .utils.checkpoint import CheckpointRestoreError

    if rank != 0:  # status prints from rank 0 only
        config = dataclasses.replace(config, enable_print=False)
    if rank == 0:
        for flag, target in (("--sweep-log", args.sweep_log),
                             ("--metrics-file", args.metrics_file)):
            if target:
                try:
                    with open(target, "a"):
                        pass
                except OSError as e:
                    print(f"Cannot write {flag}={target!r}: {e}",
                          file=sys.stderr)
                    return 1
    if args.allow_nonfinite and world > 1:
        print("--allow-nonfinite is a single-process mode", file=sys.stderr)
        return 1
    if args.allow_nonfinite and config.ingest == "pipelined":
        # Quarantine drops rows from a materialized array; pipelined
        # ingestion reads fixed row ranges and never holds the array.
        print("--allow-nonfinite requires --ingest=resident (quarantine "
              "rewrites the event array; pipelined ingestion reads fixed "
              "byte ranges)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if world > 1 or config.ingest == "pipelined":
        # Per-rank reading: the fit pulls each rank's rows through the file
        # source (the reference broadcast the whole dataset,
        # gaussian.cu:191-201); under --ingest=pipelined only the blocks in
        # flight, and the memberships pass reads the file block by block.
        data, rc = _read_events(args.infile, source=True)
    else:
        data, rc = _read_events(args.infile,
                                allow_nonfinite=args.allow_nonfinite,
                                dtype=config.dtype)
    if data is None:
        return rc
    t_io = time.perf_counter() - t0
    n_events, n_dims = data.shape
    init_means = None
    if args.init_from:
        # Every rank reads the same file, so every rank takes the same
        # branch here.
        try:
            init_means = read_summary(args.init_from)["means"]
        except (OSError, ValueError) as e:
            print(f"Cannot load --init-from={args.init_from!r}: {e}",
                  file=sys.stderr)
            return 1
        if init_means.shape != (args.num_clusters, n_dims):
            print(f"--init-from model is {init_means.shape[0]} clusters x "
                  f"{init_means.shape[1]} dims but this fit needs "
                  f"({args.num_clusters}, {n_dims}).", file=sys.stderr)
            return 1
    try:
        model = default_model(config)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    if config.enable_print:
        print(f"Number of events: {n_events}")
        print(f"Number of dimensions: {n_dims}\n")  # gaussian.cu:223-224
        print(f"Starting with {args.num_clusters} cluster(s), will stop at "
              f"{args.target_num_clusters or 1} cluster(s).")  # :226
        print(f"device: {model.device}; estep backend: {model.estep_backend} "
              f"({model.estep_backend_reason})")
        if model.mesh is not None:
            print(f"mesh (data, cluster): {model.mesh.shape} over {world} "
                  f"rank(s); collective backend: {model.collective_backend}")
    # The run supervisor turns SIGTERM/SIGINT and --max-runtime into a
    # cooperative stop with an emergency checkpoint and exit 75, on every
    # rank: a stop on any rank stops all of them at the same poll, and a
    # lost peer exits 75 too. It stays active through the output writing,
    # so the assembly's barriers take the watchdog's timeout.
    try:
        with supervisor.use(supervisor.RunSupervisor(
                max_runtime_s=config.max_runtime_s)):
            return _fit_and_write(args, config, model, data, init_means,
                                  t_io)
    except NumericalFaultError as e:
        # Unrecovered (or recovery disabled): never write a poisoned model.
        print(f"Numerical fault -- no model written.\n{e}", file=sys.stderr)
        return supervisor.EX_SOFTWARE
    except supervisor.PreemptedError as e:
        print(f"Preempted -- {e}", file=sys.stderr)
        return supervisor.EX_TEMPFAIL
    except supervisor.PeerLostError as e:
        print(f"Peer lost -- {e}", file=sys.stderr)
        return supervisor.EX_TEMPFAIL
    except CheckpointRestoreError as e:
        print(f"Checkpoint unreadable -- {e}", file=sys.stderr)
        return supervisor.EX_IOERR


def _fit_and_write(args, config, model, data, init_means, t_io) -> int:
    """The supervised span of a fit run: fit, then write the outputs. On a
    mesh every rank writes the ``.results`` part of its own rows and rank 0
    the ``.summary`` and the assembled ``.results``; the ranks are those of
    the world the fit ended in (an elastic fit may have shrunk it)."""
    import json

    from .io import stream_results, write_summary
    from .models import fit_gmm, iter_memberships
    from .parallel import distributed
    from .utils.profiling import trace
    from .validation import InvalidInputError

    with trace(args.trace_dir, device=config.device):
        try:
            result = fit_gmm(data, args.num_clusters,
                             args.target_num_clusters, config=config,
                             model=model, init_means=init_means)
        except InvalidInputError as e:
            print(str(e), file=sys.stderr)
            return 1
    rank, world = distributed.rank(), distributed.world_size()
    t_out0 = time.perf_counter()
    if rank == 0:
        write_summary(args.outfile + ".summary", result,
                      enable_output=config.enable_output)
        if args.sweep_log:
            with open(args.sweep_log, "w") as f:
                for k, ll, riss, iters, secs in result.sweep_log:
                    f.write(json.dumps({
                        "num_clusters": int(k), "loglik": float(ll),
                        "score": float(riss), "criterion": config.criterion,
                        "em_iters": int(iters), "seconds": float(secs),
                    }) + "\n")
    if config.enable_output:
        out_path = args.outfile + ".results"
        if world > 1:
            lo, hi = _output_rows(result, config.chunk_size)
            part = distributed.results_part_path(out_path,
                                                 part_dir=args.part_dir)
            rows = (_SourceRows(data, lo, hi)
                    if config.ingest == "pipelined"
                    else data.read_range(lo, hi))
            stream_results(part, iter_memberships(
                result, rows, config, result.model))
            distributed.assemble_results_multihost(out_path, part)
        else:
            # ``data`` is the events, or under --ingest=pipelined the file
            # source, which iter_memberships reads block by block.
            stream_results(out_path, iter_memberships(result, data, config,
                                                      result.model))
    t_out = time.perf_counter() - t_out0
    if config.profile and rank == 0:
        em_s = sum(r[4] for r in result.sweep_log)
        if result.profile_report:
            print(result.profile_report)  # 7-category table (gaussian.cu:967)
        print(f"I/O time: {(t_io + t_out) * 1e3:.3f} (ms)")  # :1093
        print(f"EM time: {em_s * 1e3:.3f} (ms) over "
              f"{sum(r[3] for r in result.sweep_log)} iterations")
    return 0


class _SourceRows:
    """Rows [lo, hi) of a file source, read slice by slice: the memberships
    pass of an out-of-core rank reads its rows block by block."""

    def __init__(self, source, lo: int, hi: int):
        self.source, self.lo, self.hi = source, lo, hi
        self.shape = (hi - lo, source.shape[1])

    def __getitem__(self, key):
        start, stop, _ = key.indices(self.shape[0])
        return self.source.read_range(self.lo + start, self.lo + stop)


def _output_rows(result, chunk_size: int):
    """[lo, hi): the events whose memberships this rank writes. Its mesh
    row's events (``result.host_range``), split over the row's ranks in
    whole chunks, so the parts in rank order are the events in order and
    every block of the output pass starts where one process's would."""
    from .parallel.distributed import host_slice

    start, stop = result.host_range
    mesh = getattr(result.model, "mesh", None)
    if mesh is None or mesh.cluster_size == 1:
        return start, stop
    a, b = host_slice(-(-(stop - start) // chunk_size), mesh.cluster_index,
                      mesh.cluster_size)
    return (min(start + a * chunk_size, stop),
            min(start + b * chunk_size, stop))


def _read_events(path, allow_nonfinite: bool = False, dtype=None,
                 source: bool = False):
    """(events, 0), or (None, exit code) after the reference's abort
    message (gaussian.cu:204-205): 74 (EX_IOERR) for an unreadable or torn
    file, 1 for malformed content. ``allow_nonfinite`` drops NaN/Inf rows
    (in the compute ``dtype``) with a warning. ``source``: an
    ``io.FileSource`` whose shape is probed here, for range reads."""
    import numpy as np

    from . import supervisor
    from .io import FileSource, TruncatedInputError, read_data

    try:
        if source:
            src = FileSource(path)
            src.shape  # the header parse, inside this error guard
            return src, 0
        return read_data(path, screen="quarantine" if allow_nonfinite
                         else "off",
                         screen_dtype=np.dtype(dtype) if dtype else None), 0
    except (OSError, ValueError) as e:
        print("Error parsing input file. This could be due to an empty file "
              f"or an inconsistent number of dimensions. Aborting. ({e})",
              file=sys.stderr)
        torn = isinstance(e, (OSError, TruncatedInputError))
        return None, supervisor.EX_IOERR if torn else 1


def _predict_main(args, config) -> int:
    """Inference only: the memberships of infile under a saved model,
    written as ``<outfile>.results`` beside a ``.summary`` echo of the model
    (the reference has no such mode: its .summary is write-only)."""
    import numpy as np

    from .estimator import GaussianMixture
    from .io import stream_results, write_summary
    from .models import iter_memberships
    from .validation import InvalidInputError, validate_finite

    # The model first: a bad model path fails before a large infile is read.
    try:
        gm = GaussianMixture.from_summary(args.predict_from, config=config)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"Cannot load model {args.predict_from!r}: {e}",
              file=sys.stderr)
        return 1
    data, rc = _read_events(args.infile)
    if data is None:
        return rc
    if config.validate_input:
        try:
            validate_finite(data, dtype=np.dtype(config.dtype))
        except InvalidInputError as e:
            print(str(e), file=sys.stderr)
            return 1
    d_model = gm.result_.num_dimensions
    if data.shape[1] != d_model:
        print(f"Model has {d_model} dimensions but {args.infile!r} has "
              f"{data.shape[1]}.", file=sys.stderr)
        return 1
    if config.enable_print:
        print(f"Number of events: {data.shape[0]}")
        print(f"Scoring under {gm.n_components_}-cluster model "
              f"{args.predict_from!r}.")
    echo_path = args.outfile + ".summary"
    if (os.path.exists(echo_path)
            and os.path.samefile(echo_path, args.predict_from)):
        # The echo is re-derived (pi from N, non-PD R reset), not a byte
        # copy: it must never overwrite the model it was loaded from.
        print(f"outfile would overwrite the loaded model {echo_path!r}; "
              "skipping the .summary echo", file=sys.stderr)
    else:
        write_summary(echo_path, gm.result_)
    stream_results(args.outfile + ".results",
                   iter_memberships(gm.result_, data, config, gm._model))
    return 0


if __name__ == "__main__":
    sys.exit(main())
