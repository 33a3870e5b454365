"""``gmm fleet``: fit a manifest of per-tenant input files in one run.

The port of the JAX package's ``tenancy/cli.py``, with its flags: a
manifest names T tenants -- each with its own input file, starting K,
optional target K and seed -- and one invocation packs them into
shape-bucketed groups, fits every group with fleet EM calls
(``tenancy.fleet.fit_fleet``) and writes per-tenant outputs:

- ``<out-dir>/<name>.summary`` per fitted tenant (the reference's model
  format) plus ``<out-dir>/fleet.json``, the machine-readable fleet
  manifest (per-tenant status/score/paths) that ``gmm export --fleet``
  consumes for bulk registry export;
- with ``--registry``, one EXACT registry version per tenant model in
  the same invocation (a tenant whose export fails is reported and
  skipped, never run-fatal).

Manifest format -- JSON array or JSONL, one object per tenant::

    {"name": "patient-007", "infile": "p007.csv", "num_clusters": 8,
     "target_num_clusters": 0, "seed": 7}

Runs on the card unless ``--device cpu``. On a mesh (``--mesh`` under
torchrun, one process per rank) every rank fits every tenant and rank 0
writes the outputs. Exit codes follow the fit CLI's contract: 0 fitted
(even with some tenants dropped -- per-tenant status is in fleet.json), 70
when EVERY tenant was dropped or an unrecovered numerical fault aborted
the run, 74 unreadable input or checkpoint, 75 preempted (resume with the
same ``--checkpoint-dir``), 1/2 usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List


def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmm fleet",
        description="Fit a manifest of independent per-tenant datasets "
        "as packed fleet groups.")
    p.add_argument("manifest",
                   help="tenant manifest: JSON array or JSONL of "
                   "{name, infile, num_clusters[, target_num_clusters, "
                   "seed]}")
    p.add_argument("--out-dir", default=None, metavar="DIR",
                   help="write <name>.summary per tenant + fleet.json "
                   "(the bulk-export manifest) into DIR")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="also export each fitted tenant as one EXACT "
                   "registry version (model name = tenant name); "
                   "per-tenant failures are reported, not run-fatal")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (default: the CUDA card)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--chunk-size", type=int, default=65536)
    p.add_argument("--covariance-type", default="full",
                   choices=["full", "diag", "spherical", "tied"])
    p.add_argument("--criterion", default="rissanen",
                   choices=["rissanen", "bic", "aic", "aicc"])
    p.add_argument("--min-iters", type=int, default=100)
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=0,
                   help="default RNG seed (per-tenant manifest seeds "
                   "override)")
    p.add_argument("--seed-method", default="even",
                   choices=["even", "kmeans++"])
    p.add_argument("--mesh", default=None,
                   help="(data, cluster) mesh 'DATA[,CLUSTER]' over the "
                   "ranks of a torchrun world")
    p.add_argument("--fleet-mode", default="scan",
                   choices=["scan", "vmap"],
                   help="per-group mode: 'scan' (default) is "
                   "bit-identical to solo fits; 'vmap' batches each "
                   "group's tenants into one loop (K3's per-lane-events "
                   "form + K4 per iteration on the card) at "
                   "reduction-order tolerance")
    p.add_argument("--fleet-group-size", type=int, default=None,
                   metavar="T",
                   help="max tenants per packed group (default: whole "
                   "group)")
    p.add_argument("--recovery", default="retry",
                   choices=["retry", "off"],
                   help="'retry' drops a numerically poisoned tenant "
                   "and keeps its groupmates; 'off' aborts the run "
                   "(exit 70) on the first fatal fault")
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-group sweep checkpoints (resume with the "
                   "same path)")
    p.add_argument("--resume", default="auto", choices=["auto", "never"])
    p.add_argument("--max-runtime", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock budget: reaching it drains like "
                   "SIGTERM -- checkpointed stop between sweep steps, "
                   "exit 75")
    p.add_argument("--metrics-file", default=None, metavar="FILE.jsonl",
                   help="fleet telemetry stream (fleet_start / "
                   "tenant_done / fleet_summary); render with "
                   "`gmm report`")
    p.add_argument("--metrics-port", type=int, default=None,
                   metavar="PORT",
                   help="live observability plane: serve OpenMetrics "
                   "text on 127.0.0.1:PORT/metrics (0 = OS-assigned) "
                   "and emit fleet/group trace spans (default: off)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the fleet "
                   "fit into DIR")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def _load_manifest(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        text = f.read().strip()
    if not text:
        raise ValueError("empty manifest")
    if text.startswith("["):
        entries = json.loads(text)
    else:  # JSONL
        entries = [json.loads(line) for line in text.splitlines()
                   if line.strip()]
    if not isinstance(entries, list) or not entries:
        raise ValueError("manifest must be a non-empty list of tenants")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"manifest entry {i} is not an object")
        for field in ("name", "infile", "num_clusters"):
            if field not in e:
                raise ValueError(
                    f"manifest entry {i} is missing {field!r}")
    return entries


def fleet_main(argv=None) -> int:
    args = build_fleet_parser().parse_args(argv)
    try:
        entries = _load_manifest(args.manifest)
    except (OSError, ValueError) as e:
        print(f"Cannot read manifest {args.manifest!r}: {e}",
              file=sys.stderr)
        return 1

    from .. import supervisor
    from ..cli import _parse_mesh, _read_events
    from ..config import GMMConfig
    from ..health import NumericalFaultError
    from ..parallel import distributed
    from ..utils.checkpoint import CheckpointRestoreError
    from .packing import TenantSpec

    try:
        config = GMMConfig(
            dtype=args.dtype,
            chunk_size=args.chunk_size,
            covariance_type=args.covariance_type,
            criterion=args.criterion,
            min_iters=args.min_iters,
            max_iters=args.max_iters,
            seed=args.seed,
            seed_method=args.seed_method,
            mesh_shape=_parse_mesh(args.mesh),
            device=args.device,
            recovery=args.recovery,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            max_runtime_s=args.max_runtime,
            metrics_file=args.metrics_file,
            metrics_port=args.metrics_port,
            fleet_mode=args.fleet_mode,
            fleet_group_size=args.fleet_group_size,
            enable_print=args.verbose,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    tenants: List[TenantSpec] = []
    for e in entries:
        if not os.path.isfile(str(e["infile"])):
            # The JAX CLI's reader raises OSError here: exit 74.
            print(f"Invalid infile {e['infile']!r} (tenant {e['name']!r}).",
                  file=sys.stderr)
            return supervisor.EX_IOERR
        data, rc = _read_events(str(e["infile"]))
        if data is None:
            return rc
        try:
            tenants.append(TenantSpec(
                name=str(e["name"]), data=data,
                num_clusters=int(e["num_clusters"]),
                target_num_clusters=int(e.get("target_num_clusters", 0)),
                seed=(int(e["seed"]) if e.get("seed") is not None
                      else None)))
        except ValueError as err:
            print(str(err), file=sys.stderr)
            return 1

    try:
        distributed.initialize(args.device)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        return _fit_and_write(args, config, tenants)
    except NumericalFaultError as e:
        print(f"Numerical fault -- no models written.\n{e}",
              file=sys.stderr)
        return supervisor.EX_SOFTWARE
    except (supervisor.PreemptedError, supervisor.PeerLostError) as e:
        print(f"Preempted -- {e}", file=sys.stderr)
        return supervisor.EX_TEMPFAIL
    except CheckpointRestoreError as e:
        print(f"Checkpoint unreadable -- {e}", file=sys.stderr)
        return supervisor.EX_IOERR
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    finally:
        distributed.shutdown()


def _fit_and_write(args, config, tenants) -> int:
    """The supervised fleet fit, then rank 0's outputs."""
    from .. import supervisor
    from ..parallel import distributed
    from ..utils.profiling import trace
    from .fleet import fit_fleet

    with supervisor.use(supervisor.RunSupervisor(
            max_runtime_s=args.max_runtime)), \
            trace(args.trace_dir, device=config.device):
        fleet = fit_fleet(tenants, config, verbose=args.verbose)
    if distributed.rank() != 0:
        return 0 if fleet.fitted else supervisor.EX_SOFTWARE

    rows: List[dict] = []
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    for tr in fleet.tenants:
        row: dict = {"name": tr.name, "dropped": tr.dropped,
                     "group": tr.group}
        if tr.dropped:
            row["error"] = tr.error
        else:
            r = tr.result
            row.update(
                k=int(r.ideal_num_clusters),
                score=(float(r.min_rissanen)
                       if r.min_rissanen == r.min_rissanen else None),
                loglik=float(r.final_loglik),
                criterion=config.criterion,
                covariance_type=config.covariance_type,
                dtype=config.dtype,
            )
            if args.out_dir:
                from ..io import write_summary

                summary_path = os.path.join(args.out_dir,
                                            f"{tr.name}.summary")
                write_summary(summary_path, r, enable_output=True)
                row["summary"] = os.path.abspath(summary_path)
                if getattr(r, "envelope", None) is not None:
                    # The tenant's training drift envelope: `gmm export
                    # --fleet` republishes it beside the tenant's version.
                    env_path = os.path.join(
                        args.out_dir, f"{tr.name}.envelope.json")
                    with open(env_path, "w", encoding="utf-8") as f:
                        json.dump(r.envelope, f, sort_keys=True)
                    row["envelope"] = os.path.abspath(env_path)
        rows.append(row)

    exported = 0
    if args.registry:
        from ..serving.registry import ModelRegistry, RegistryError

        reg = ModelRegistry(args.registry)
        for tr, row in zip(fleet.tenants, rows):
            if tr.dropped:
                continue
            try:
                v = reg.save(tr.name, tr.result, config=config,
                             source="fleet")
                row["registry_version"] = int(v)
                exported += 1
            except (RegistryError, OSError) as e:
                # Partial failure stays per-tenant: one unexportable
                # model must not void its siblings' exports.
                row["export_error"] = str(e)
                print(f"export of {tr.name!r} failed: {e}",
                      file=sys.stderr)

    if args.out_dir:
        manifest_out = {
            "schema": 1,
            "mode": fleet.mode,
            "groups": fleet.groups,
            "wall_s": fleet.wall_s,
            "tenants": rows,
        }
        with open(os.path.join(args.out_dir, "fleet.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest_out, f, indent=1, sort_keys=True)

    fitted = len(fleet.fitted)
    print(f"fleet: {fitted}/{len(fleet.tenants)} tenants fitted in "
          f"{len(fleet.groups)} group(s), {fleet.wall_s:.2f}s"
          + (f"; {exported} exported to registry" if args.registry
             else ""))
    for row in rows:
        if row["dropped"]:
            print(f"  {row['name']}: DROPPED ({row.get('error')})",
                  file=sys.stderr)
    return 0 if fitted else supervisor.EX_SOFTWARE
