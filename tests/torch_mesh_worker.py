"""Rank functions of the port's multi-process mesh tests.

``spawn_world`` starts a torch.distributed world of processes with
torch.multiprocessing (a ``file://`` store in a temporary directory) and
runs one function on every rank; each rank's return value comes back to
the caller, in rank order. This module imports neither jax nor the JAX
package, so the ranks never load them.
"""

from __future__ import annotations

import functools
import pickle
from pathlib import Path

import numpy as np
import torch


def spawn_world(fn, world: int, tmp_dir, *args, device: str = "cpu"):
    """``fn(*args)`` on every rank of a new world of ``world`` processes
    (gloo, unless ``device='cuda'`` finds a GPU per rank); returns the
    per-rank results. A rank that raises fails the call."""
    import torch.multiprocessing as mp

    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    mp.spawn(_rank_main, args=(world, str(tmp_dir), device, fn, args),
             nprocs=world, join=True)
    return [pickle.loads((tmp_dir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _rank_main(rank, world, tmp_dir, device, fn, args):
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.initialize(device, coordinator=f"file://{tmp_dir}/store",
                           num_processes=world, process_id=rank)
    try:
        out = fn(*args)
    finally:
        distributed.shutdown()
    Path(tmp_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _numpy_state(state):
    from cuda_gmm_mpi_tpu_torch.interop import state_to_numpy

    return state_to_numpy(state)


def run_em_case(data, state_np, iters, mesh_shape, chunk, dtype="float64",
                diag=False, stats="auto", device="cpu", precision="highest"):
    """``ShardedGMMModel.run_em`` on this rank's shard. ``stats='sharded'``
    passes ``fused_stats_cuda_sharded`` (K5 + collectives + K6; their plain
    versions on the CPU) at ``precision`` as an explicit stats_fn. Returns
    this rank's mesh position, local state (numpy), loglik, iterations and
    health counters."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.parallel import ShardedGMMModel, make_mesh

    cfg = GMMConfig(min_iters=iters, max_iters=iters, chunk_size=chunk,
                    dtype=dtype, diag_only=diag, device=device,
                    mesh_shape=mesh_shape, matmul_precision=precision)
    mesh = make_mesh(mesh_shape)
    stats_fn = None
    if stats == "sharded":
        stats_fn = functools.partial(fs.fused_stats_cuda_sharded,
                                     cluster_group=mesh.cluster_group,
                                     diag_only=diag, precision=precision)
    model = ShardedGMMModel(cfg, mesh=mesh, stats_fn=stats_fn)
    chunks, wts = chunk_events(np.asarray(data, dtype), chunk,
                               num_shards=model.data_size)
    state, chunks, wts = model.prepare(state_from_numpy(state_np), chunks,
                                       wts)
    eps = convergence_epsilon(*data.shape)
    counters = (fs.local_lse, fs.stats_logz, fs.fused_stats, fs.mstep)
    before = [c.launches for c in counters]
    s, ll, it = model.run_em(state, chunks, wts, eps,
                             n_events=data.shape[0])
    return dict(data_index=mesh.data_index, cluster_index=mesh.cluster_index,
                state=_numpy_state(s), loglik=ll, iters=it,
                health=model.last_health, backend=model.estep_backend,
                collective=model.collective_backend,
                launches=[c.launches - b for c, b in zip(counters, before)])


def fit_case(data, k0, target, **cfg):
    """``fit_gmm`` on every rank; returns what the comparison needs."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm

    r = fit_gmm(data, k0, target, config=GMMConfig(device="cpu", **cfg))
    return dict(k=r.ideal_num_clusters, merges=[m[1] for m in r.merges],
                min_rissanen=r.min_rissanen, final_loglik=r.final_loglik,
                means=r.means, sweep=[row[:4] for row in r.sweep_log])


def collectives_case():
    """``allgather_host`` (ints and floats) around a ``barrier``."""
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    me = distributed.rank()
    ints = distributed.allgather_host(np.array([me, 10 * me], np.int32))
    distributed.barrier()
    floats = distributed.allgather_host(np.full((2, 2), me + 0.5))
    return dict(rank=me, world=distributed.world_size(), ints=ints,
                floats=floats)


def run_cases(cases):
    """Several cases in one world, in order: [(function name, kwargs)]."""
    return [globals()[name](**kw) for name, kw in cases]
