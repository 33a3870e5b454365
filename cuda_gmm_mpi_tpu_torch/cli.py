"""Command-line entry point: ``python -m cuda_gmm_mpi_tpu_torch.cli num_clusters
infile outfile [target_num_clusters]``.

The reference's positional CLI (``gaussian.cu:1111-1178``, ``README.txt:
66-70``), run by the PyTorch/CUDA port. Argument validation mirrors
validateArguments: a missing infile exits 2, num_clusters outside
[1, max_clusters] exits 1, target_num_clusters > num_clusters exits 4. An
absent target means "search down to 1, keep the best Rissanen score".

The mesh path runs one process per rank (one per GPU with NCCL), every rank
with the same command, and rank 0 writes the outputs:

    torchrun --nproc-per-node=R -m cuda_gmm_mpi_tpu_torch.cli K infile outfile [target] --mesh DATA,CLUSTER

or with ``--coordinator HOST:PORT --num-processes R --process-id I`` on each
rank in place of torchrun.

``--init-from MODEL.summary`` seeds the fit's means from a saved model;
``--predict-from MODEL.summary`` fits nothing and writes the memberships of
infile under a saved model (the num_clusters positional is ignored).
"""

from __future__ import annotations

import argparse
import os
import sys


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
    p.add_argument("--init-from", default=None, metavar="MODEL.summary",
                   help="warm-start: initial means from a saved .summary "
                   "model (its K must equal num_clusters); covariances/"
                   "weights restart from the reference seed recipe")
    p.add_argument("--predict-from", default=None, metavar="MODEL.summary",
                   help="skip fitting: load a saved .summary model (this "
                   "package's, the JAX package's or the reference's own "
                   "output) and write <outfile>.results memberships for "
                   "infile under it; the num_clusters positional is ignored")
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
            enable_print=args.verbose, seed=args.seed,
            seed_method=args.seed_method, n_init=args.n_init,
            restart_batch_size=args.restart_batch_size,
            mesh_shape=_parse_mesh(args.mesh))
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

    from .io import read_summary, stream_results, write_summary
    from .models import fit_gmm, iter_memberships
    from .models.order_search import default_model
    from .validation import InvalidInputError

    if rank != 0:  # status prints from rank 0 only
        config = dataclasses.replace(config, enable_print=False)
    data, rc = _read_events(args.infile)
    if data is None:
        return rc
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
    try:
        result = fit_gmm(data, args.num_clusters, args.target_num_clusters,
                         config=config, model=model, init_means=init_means)
    except InvalidInputError as e:
        print(str(e), file=sys.stderr)
        return 1
    if rank != 0:  # rank 0 alone writes .summary and .results
        return 0
    write_summary(args.outfile + ".summary", result)
    stream_results(args.outfile + ".results",
                   iter_memberships(result, data, config, model))
    return 0


def _read_events(path):
    """(events, 0), or (None, exit code) after the reference's abort
    message (gaussian.cu:204-205): 74 for an unreadable or torn file, 1 for
    malformed content."""
    from .io import TruncatedInputError, read_data

    try:
        return read_data(path), 0
    except (OSError, ValueError) as e:
        print("Error parsing input file. This could be due to an empty file "
              f"or an inconsistent number of dimensions. Aborting. ({e})",
              file=sys.stderr)
        return None, 74 if isinstance(e, (OSError, TruncatedInputError)) else 1


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
