"""Command-line entry point: ``python -m cuda_gmm_mpi_tpu_torch.cli num_clusters
infile outfile [target_num_clusters]``.

The reference's positional CLI (``gaussian.cu:1111-1178``, ``README.txt:
66-70``), run by the PyTorch/CUDA port. Argument validation mirrors
validateArguments: a missing infile exits 2, num_clusters outside
[1, max_clusters] exits 1, target_num_clusters > num_clusters exits 4. An
absent target means "search down to 1, keep the best Rissanen score".
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
                   help="diagonal covariance (DIAG_ONLY, gaussian.h:23)")
    p.add_argument("--min-iters", type=int, default=100,
                   help="MIN_ITERS (gaussian.h:27)")
    p.add_argument("--max-iters", type=int, default=100,
                   help="MAX_ITERS (gaussian.h:26)")
    p.add_argument("--estep-backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="statistics path: 'cuda' = the hand-written kernels, "
                   "'torch' = torch ops; 'auto' = kernels on a CUDA device "
                   "at float32, torch ops otherwise")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="status prints (ENABLE_PRINT, gaussian.h:35)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .config import GMMConfig
    from .io import TruncatedInputError, read_data, stream_results, write_summary
    from .models import GMMModel, fit_gmm, iter_memberships
    from .validation import InvalidInputError

    if not os.path.isfile(args.infile):
        print("Invalid infile.\n", file=sys.stderr)  # gaussian.cu:1130
        return 2
    try:
        config = GMMConfig(
            dtype=args.dtype, diag_only=args.diag_only,
            min_iters=args.min_iters, max_iters=args.max_iters,
            estep_backend=args.estep_backend, device=args.device,
            enable_print=args.verbose)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not (1 <= args.num_clusters <= config.max_clusters):
        print("Invalid number of starting clusters\n", file=sys.stderr)  # :1122
        return 1
    if args.target_num_clusters > args.num_clusters:
        print("target_num_clusters must be less than equal to num_clusters\n",
              file=sys.stderr)  # :1150
        return 4

    try:
        data = read_data(args.infile)
    except (OSError, ValueError) as e:
        print("Error parsing input file. This could be due to an empty file "
              f"or an inconsistent number of dimensions. Aborting. ({e})",
              file=sys.stderr)
        return 74 if isinstance(e, (OSError, TruncatedInputError)) else 1
    n_events, n_dims = data.shape
    try:
        model = GMMModel(config)
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
    try:
        result = fit_gmm(data, args.num_clusters, args.target_num_clusters,
                         config=config, model=model)
    except InvalidInputError as e:
        print(str(e), file=sys.stderr)
        return 1
    write_summary(args.outfile + ".summary", result)
    stream_results(args.outfile + ".results",
                   iter_memberships(result, data, config, model))
    return 0


if __name__ == "__main__":
    sys.exit(main())
