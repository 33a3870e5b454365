"""Rank functions of the port's multi-process mesh tests.

``spawn_world`` starts a torch.distributed world of processes with
torch.multiprocessing (a ``file://`` store in a temporary directory) and
runs one function on every rank; each rank's return value comes back to
the caller, in rank order. This module imports neither jax nor the JAX
package, so the ranks never load them.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import pickle
import threading
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


# This rank's result file (set by _rank_main): where a timed-out case
# leaves the rank's results so far.
_RESULT_PATH = None


def _rank_main(rank, world, tmp_dir, device, fn, args):
    global _RESULT_PATH
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    _RESULT_PATH = Path(tmp_dir, f"rank{rank}.pkl")
    distributed.initialize(device, coordinator=f"file://{tmp_dir}/store",
                           num_processes=world, process_id=rank)
    try:
        out = fn(*args)
    finally:
        distributed.shutdown()
    _RESULT_PATH.write_bytes(pickle.dumps(out))


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
    return _summary(r)


def _summary(r):
    return dict(k=r.ideal_num_clusters, merges=[m[1] for m in r.merges],
                min_rissanen=r.min_rissanen, final_loglik=r.final_loglik,
                means=r.means, sweep=[row[:4] for row in r.sweep_log],
                envelope=r.envelope, init_index=r.init_index,
                host_range=r.host_range)


class _Warnings(logging.Handler):
    """The port's warning lines, kept."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def fused_fit_case(data, k0, target, stop_rank=None, **cfg):
    """``fit_gmm(fused_sweep=True)`` on every rank under a run supervisor;
    with ``stop_rank`` that rank's supervisor has a deadline already past,
    so it asks for a stop at the first per-K emission. Returns the fit's
    summary (or the stop's exception type, step and reason), its profile's
    e_step seconds and whether its report names the fused sweep, and the
    port's warning lines."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.parallel import distributed
    from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

    handler = _Warnings()
    logger = logging.getLogger("cuda_gmm_mpi_tpu_torch")
    logger.addHandler(handler)
    restored = []  # the step of each checkpoint the fit restored, or None
    restore = SweepCheckpointer.restore

    def noted(self, *a, **kw):
        tree = restore(self, *a, **kw)
        restored.append(None if tree is None else int(tree["step"]))
        return tree

    SweepCheckpointer.restore = noted
    deadline = 0.0 if distributed.rank() == stop_rank else None
    try:
        with supervisor.use(supervisor.RunSupervisor(
                max_runtime_s=deadline, install_signals=False)):
            r = fit_gmm(data, k0, target,
                        config=GMMConfig(device="cpu", fused_sweep=True,
                                         **cfg))
    except supervisor.PreemptedError as e:
        return dict(stopped=type(e).__name__, step=e.step, reason=e.reason,
                    checkpointed=e.checkpointed, warnings=handler.lines)
    finally:
        logger.removeHandler(handler)
        SweepCheckpointer.restore = restore
    return dict(_summary(r), warnings=handler.lines, restored=restored,
                e_step=(r.profile or {}).get("e_step"),
                fused_report="fused sweep" in (r.profile_report or ""))


def supervised_fit_case(data, k0, target, faults_spec=None, only_rank=None,
                        **cfg):
    """``fit_gmm`` under a run supervisor (no signal handlers) with the
    fault plan ``faults_spec`` armed (on rank ``only_rank`` alone, when
    set); returns the fit's summary, or the stop's exception type, step,
    iteration and reason."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm, supervisor
    from cuda_gmm_mpi_tpu_torch.parallel import distributed
    from cuda_gmm_mpi_tpu_torch.testing import faults

    if only_rank is not None and distributed.rank() != only_rank:
        faults_spec = None
    try:
        with faults.use(faults_spec or {}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            r = fit_gmm(data, k0, target,
                        config=GMMConfig(device="cpu", **cfg))
    except (supervisor.PreemptedError, supervisor.PeerLostError) as e:
        return dict(stopped=type(e).__name__,
                    step=getattr(e, "step", None),
                    em_iter=getattr(e, "em_iter", None),
                    reason=getattr(e, "reason", None))
    return _summary(r)


def fleet_case(tenants, **cfg):
    """``fit_fleet`` ('scan') on every rank, then each tenant's sharded solo
    ``fit_gmm`` on the same mesh; returns per tenant the fleet's summary
    and whether the two are the same bit for bit (state, scores, the per-K
    trajectory and the merges)."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.tenancy import TenantSpec, fit_fleet

    config = GMMConfig(device="cpu", **cfg)
    fleet = fit_fleet([TenantSpec(*t) for t in tenants], config)
    out = {}
    for name, data, k0, target, seed in tenants:
        r = fleet[name].result
        solo = fit_gmm(data, k0, target, config=dataclasses.replace(
            config, seed=config.seed if seed is None else seed))
        same = (r.ideal_num_clusters == solo.ideal_num_clusters
                and r.final_loglik == solo.final_loglik
                and r.min_rissanen == solo.min_rissanen
                and r.merges == solo.merges
                and [x[:4] for x in r.sweep_log]
                == [x[:4] for x in solo.sweep_log]
                and all(torch.equal(getattr(r.state, f),
                                    getattr(solo.state, f))
                        for f in ("N", "pi", "constant", "means", "R",
                                  "Rinv", "active")))
        out[name] = dict(_summary(r), R=r.state.R.numpy(), bit_identical=same)
    return out


def moments_case(data, chunk, data_axis):
    """This rank's ``host_chunk_bounds`` slice of ``data`` and the global
    moments from every rank's slice (one all_reduce)."""
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    me, world = distributed.rank(), distributed.world_size()
    start, stop, num = distributed.host_chunk_bounds(
        data.shape[0], chunk, data_axis, me, world)
    mean, var = distributed.global_moments(data[start:stop], chunk, num,
                                           index=me, count=world)
    return dict(bounds=(start, stop, num), mean=mean, var=var)


def assemble_case(tmp_dir, payloads, shared):
    """Each rank writes ``payloads[rank]`` as its .results part (in one
    shared directory, or a directory of its own) and the ranks assemble
    them; returns the assembled bytes on rank 0 and the files left."""
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    me = distributed.rank()
    tmp = Path(tmp_dir)
    part_dir = tmp / ("parts" if shared else f"parts{me}")
    out = tmp / "out.results"
    part = distributed.results_part_path(str(out), part_dir=str(part_dir))
    Path(part).write_bytes(payloads[me])
    distributed.assemble_results_multihost(str(out), part, chunk_bytes=7)
    distributed.barrier()
    left = sorted(str(p.relative_to(tmp)) for p in tmp.rglob("*.part*"))
    return dict(out=out.read_bytes() if me == 0 else None, left=left)


def collectives_case():
    """``allgather_host`` (ints and floats) around a ``barrier``, and
    ``allgather_json`` of payloads of different lengths."""
    from cuda_gmm_mpi_tpu_torch.parallel import distributed

    me = distributed.rank()
    ints = distributed.allgather_host(np.array([me, 10 * me], np.int32))
    distributed.barrier()
    floats = distributed.allgather_host(np.full((2, 2), me + 0.5))
    objs = distributed.allgather_json({"rank": me, "x": [0.5] * me})
    return dict(rank=me, world=distributed.world_size(), ints=ints,
                floats=floats, objs=objs)


def run_cases(cases):
    """Several cases in one world, in order: [(function name, kwargs)], or
    [(function name, kwargs, seconds)] for a case with a time limit of its
    own. A case that outlives its limit (a rank stuck in a collective)
    ends the rank: its results so far are written, every case left reads
    ``{"timed_out": name}``, and the process exits, so a hang fails those
    cases' tests instead of holding the suite until its own limit."""
    out = []
    for case in cases:
        name, kw = case[:2]
        timer = None
        if len(case) > 2:
            left = [{"timed_out": c[0]} for c in cases[len(out):]]
            timer = threading.Timer(case[2], _give_up, (out, left))
            timer.daemon = True
            timer.start()
        try:
            out.append(globals()[name](**kw))
        finally:
            if timer is not None:
                timer.cancel()
    return out


def _give_up(done, left):
    _RESULT_PATH.write_bytes(pickle.dumps(list(done) + left))
    os._exit(0)


def k3_k4_shard_case(data, states_np, chunk, diag, lane_mask):
    """K3 on this rank's block of the chunk grid of a (2, 1) mesh, the
    all_reduce of its [R, ...] statistics over the data axis, and K4 on the
    reduced statistics -- the mesh restart loop's three steps -- on the
    card; returns the rank's block bounds, and every output as numpy."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig
    from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
    from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
    from cuda_gmm_mpi_tpu_torch.parallel import ShardedGMMModel, shard_chunks
    from cuda_gmm_mpi_tpu_torch.state import stack_states

    model = ShardedGMMModel(GMMConfig(chunk_size=chunk, diag_only=diag,
                                      mesh_shape=(2, 1)))
    chunks, wts = chunk_events(np.asarray(data, np.float32), chunk,
                               num_shards=2)
    c, w = shard_chunks(model.mesh, chunks, wts)
    c, w = model.place(c), model.place(w)
    states = model.prepare_states_batched(stack_states(
        [state_from_numpy(s) for s in states_np]))
    n = model.local_events(data.shape[0], c)
    mask = torch.as_tensor(lane_mask, device=model.device)
    k3, k4 = fs.fused_stats_batched.launches, fs.mstep_batched.launches
    local = fs.fused_stats_cuda_batched(states, c, w, mask, diag_only=diag,
                                        n_events=n)
    reduced = model._reduce(local)
    out = fs.fused_mstep_cuda_batched(states, reduced, diag_only=diag)
    torch.cuda.synchronize()
    leaves = lambda t: {f.name: getattr(t, f.name).cpu().numpy()
                        for f in dataclasses.fields(t)}
    return dict(rank=model.mesh.rank, n=n, local=leaves(local),
                reduced=leaves(reduced), mstep=leaves(out),
                launches=(fs.fused_stats_batched.launches - k3,
                          fs.mstep_batched.launches - k4))


def counted_fit_case(data, k0, target, **cfg):
    """``fit_gmm`` on the card with every kernel's launch counter set to 0
    just before; returns the fit's summary and the counts."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

    counters = dict(K1=fs.fused_stats, K2=fs.mstep, K3=fs.fused_stats_batched,
                    K4=fs.mstep_batched, K5=fs.local_lse, K6=fs.stats_logz)
    for c in counters.values():
        c.launches = 0
    r = fit_gmm(data, k0, target, config=GMMConfig(**cfg))
    out = _summary(r)
    out["launches"] = {k: c.launches for k, c in counters.items()}
    return out
