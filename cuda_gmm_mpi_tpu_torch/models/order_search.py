"""Model-order search: EM at each K, merge the closest pair, keep the best.

The reference's main loop (``gaussian.cu:479-952``) on one device, with the
data in memory and the sweep driven from the host:

- center the data on its float64 mean and seed the state (``_prepare_fit``);
- for each K, run EM; eliminate empty clusters; scan all pairs and merge the
  closest (ops/merge.py);
- keep the K with the best score (gaussian.cu:832-854), skipping a
  non-finite score: the reference's Rissanen/MDL score, or BIC/AIC/AICc
  (``config.criterion``) with the family's free parameters.

``sample_weight`` weights every event's statistics (integer weights equal
replicated rows); ``init_means`` replaces the seeding of init 0 with the
caller's means (sklearn's ``means_init``).

The sweep rebuckets the padded cluster width to the active count's power of
two whenever a merge crosses a bucket boundary (``state.compact_to``), as
the JAX package's default ``sweep_k_buckets='pow2'`` does: EM at k active
clusters pays products at width ~k instead of the starting K.

With ``n_init > 1`` the fit runs independent restarts and keeps the best
score (``_fit_with_restarts``): in batches through ``models/restarts.py``
(one batched EM loop per batch), or one ``fit_gmm`` per init with
``restart_batch_size=1``. Either way the data is centred, chunked and
uploaded once per fit and handed to every init.

On a mesh (``config.mesh_shape``, or a torch.distributed world of more than
one rank) the fit runs on every rank through ``parallel.ShardedGMMModel``:
each rank reads the whole input, as every node does in the reference
(gaussian.cu:191-201), and keeps its block of the chunk grid and its
clusters. Before each merge scan the ranks of a mesh row gather their
clusters; every rank runs the same scan on the same state, checks with one
all_reduce that all chose the same pair, and keeps its own rows of the
result. Every rank returns the same ``GMMResult``.

Fault containment, checkpoints and the run recorder ride the sweep as in
the JAX package: each K's EM returns its health counters (health.py); a
fatal word rolls back to the K's input state and climbs the recovery
ladder (``recovery='retry'``) or raises ``NumericalFaultError``
(``'off'``), and a non-finite score never takes the best slot. With
``checkpoint_dir`` every completed K saves the sweep position
(utils/checkpoint.py) and ``resume='auto'`` continues from it; under an
active run supervisor (supervisor.py) a stop inside a K writes an
emergency mid-EM sub-step and raises ``PreemptedError``. With
``metrics_file`` the fit writes the JAX package's JSONL event stream
(telemetry/). On a mesh of more than one rank, checkpoints and the
supervisor are not ported yet (ROADMAP item 9) and raise
``NotImplementedError``. The fused sweep and streaming are not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from .. import health, supervisor, telemetry
from ..config import GMMConfig
from ..ops.formulas import convergence_epsilon, model_score
from ..ops.merge import eliminate_and_reduce
from ..ops.seeding import (
    kmeanspp_from_pool, kmeanspp_pool, seed_means_indices,
    seed_state_from_parts,
)
from ..parallel.mesh import shard_chunks
from ..state import GMMState, bucket_width, clone_state, compact, compact_to
from ..testing import faults
from ..utils.logging_ import get_logger
from ..validation import InvalidInputError, validate_finite
from .gmm import GMMModel, chunk_events

# Checkpoints carry the config's identity as int codes (the JAX package's):
# a checkpoint is only resumable under the semantics it was written with.
_CRITERION_CODE = {"rissanen": 0, "bic": 1, "aic": 2, "aicc": 3}
_CRITERION_NAME = {v: k for k, v in _CRITERION_CODE.items()}
_COV_CODE = {"full": 0, "diag": 1, "spherical": 2, "tied": 3}
_COV_NAME = {v: k for k, v in _COV_CODE.items()}


def _resume_mismatch(restored, config, log) -> bool:
    """True (and warns) when a checkpoint's criterion or covariance family
    differ from this run's (the JAX package's rule, order_search.py:58-100;
    a checkpoint without ``cov_code`` is assumed to be this run's family,
    except for 'spherical'/'tied', which it cannot be)."""
    crit = _CRITERION_NAME.get(int(restored.get("criterion_code", 0)),
                               "rissanen")
    if "cov_code" in restored:
        cov = _COV_NAME.get(int(restored["cov_code"]), config.covariance_type)
    elif config.covariance_type in ("spherical", "tied"):
        cov = "pre-covariance_type (full or diag)"
    else:
        cov = config.covariance_type
    if crit == config.criterion and cov == config.covariance_type:
        if "cov_code" not in restored and log:
            log.warning(
                "checkpoint predates the covariance_type field; assuming it "
                "was written under this run's family (%r) -- verify the "
                "original run's config if results look wrong",
                config.covariance_type)
        return False
    if log:
        log.warning(
            "checkpoint was written under criterion=%r covariance_type=%r "
            "but this run uses %r/%r; starting fresh",
            crit, cov, config.criterion, config.covariance_type)
    return True


def _to_host(state) -> GMMState:
    """``state`` on the CPU, for a checkpoint; on the card after the device
    work that made it has finished."""
    if state.N.device.type == "cuda":
        torch.cuda.synchronize(state.N.device)
    return state.to("cpu")


def _host_state(state, model) -> GMMState:
    """The sweep's current state on the CPU: a mesh row's clusters are
    gathered first (the best state is kept gathered already)."""
    if getattr(model, "mesh", None) is not None:
        state = model.gather_state(state)
    return _to_host(state)


def _place_state(state, model):
    """A restored current state (CPU) on the model: the mesh's rows of it,
    or the whole state on the model's device."""
    if getattr(model, "mesh", None) is not None:
        return model.prepare_state(state)
    return state.to(model.device)


def _platform(model) -> str:
    return "gpu" if model.device.type == "cuda" else "cpu"


def _emit_run_start(rec, model, config, n_events, n_dims, num_clusters,
                    target_num_clusters, epsilon, **extra):
    """The ``run_start`` record: platform ``gpu`` (with the card's name) or
    ``cpu``, as torch sees the device."""
    from ..parallel import distributed

    world = distributed.world_size()
    dev = model.device
    rec.emit(
        "run_start", platform=_platform(model),
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        num_events=int(n_events), num_dimensions=int(n_dims),
        start_k=int(num_clusters), target_k=int(target_num_clusters),
        epsilon=float(epsilon), process_count=int(world),
        device_count=int(world), local_device_count=1,
        dtype=config.dtype, chunk_size=int(config.chunk_size),
        covariance_type=config.covariance_type, criterion=config.criterion,
        fused_sweep=False, stream_events=False, n_init=int(config.n_init),
        em_backend=model.estep_backend,
        em_backend_reason=model.estep_backend_reason,
        memory_stats=telemetry.memory_stats(dev), **extra)


def _emit_em_iters(rec, k, lls, iters, dt, epsilon):
    """Per-iteration ``em_iter`` records of one K's EM from its loglik
    trajectory (slot 0 the initial E-step's); wall time amortized over the
    K (the JAX package's ``timing='amortized'``)."""
    if not rec.active or lls is None or iters <= 0:
        return
    n = min(int(iters), len(lls) - 1)
    for i in range(n):
        rec.emit("em_iter", k=int(k), iter=i, loglik=float(lls[i + 1]),
                 delta=float(lls[i + 1] - lls[i]), epsilon=float(epsilon),
                 wall_s=round(float(dt / max(iters, 1)), 6),
                 timing="amortized")


def _emit_health(rec, k, counts, where="em"):
    word = health.pack_word(counts)
    if word and rec.active:
        rec.emit("health", k=int(k), where=where, flags=int(word),
                 flag_names=health.flag_names(word),
                 counters=health.counts_dict(counts))
        rec.metrics.count("health_events")


def _emit_score_health(rec, k):
    if rec.active:
        name = health.FLAG_NAMES[health.NONFINITE_SCORE]
        rec.emit("health", k=int(k), where="score",
                 flags=1 << health.NONFINITE_SCORE, flag_names=[name],
                 counters={name: 1})
        rec.metrics.count("health_events")


def _phase_profile(em_s=0.0, em_n=0, reduce_s=0.0, reduce_n=0, cpu_s=0.0,
                   cpu_n=0, memcpy_s=0.0, memcpy_n=0) -> dict:
    """``run_summary.phase_profile`` in the JAX package's seven
    categories, from the sweep's host clock: EM (e_step), merge scans
    (reduce), checkpoint writes (cpu) and rebucketing (memcpy)."""
    cats = ("e_step", "m_step", "constants", "reduce", "memcpy", "cpu", "mpi")
    seconds = dict.fromkeys(cats, 0.0)
    counts = dict.fromkeys(cats, 0)
    seconds.update(e_step=em_s, reduce=reduce_s, cpu=cpu_s, memcpy=memcpy_s)
    counts.update(e_step=em_n, reduce=reduce_n, cpu=cpu_n, memcpy=memcpy_n)
    return {"seconds": seconds, "counts": counts}


def _emit_run_summary(rec, model, config, sweep_log, ideal_k, best_score,
                      best_ll, em_walls, buckets=None, health_section=None,
                      phase_profile=None):
    """The final ``run_summary`` record (the JAX package's fields; no
    ``profile``: the compile watch is not ported)."""
    if not rec.active:
        return
    first = em_walls[0] if em_walls else None
    warm = min(em_walls[1:]) if len(em_walls) > 1 else None
    fields = dict(
        **({"buckets": buckets} if buckets is not None else {}),
        **({"health": health_section} if health_section is not None else {}),
        em_backend=model.estep_backend,
        ideal_k=int(ideal_k), score=float(best_score),
        criterion=config.criterion, final_loglik=float(best_ll),
        total_iters=int(sum(r[3] for r in sweep_log)),
        wall_s=round(float(sum(r[4] for r in sweep_log)), 6),
        phase_profile=phase_profile or _phase_profile(),
        compile={
            "first_call_s": (round(first, 6) if first is not None else None),
            "warm_call_s": (round(warm, 6) if warm is not None else None),
        },
        metrics=rec.metrics.snapshot(),
        memory_stats=telemetry.memory_stats(model.device),
    )
    rec.emit("run_summary", **fields)


def _shutdown_and_raise(sup, rec, log, ckpt, *, step, k=None, em_iter=None,
                        payload=None, checkpointed=None):
    """The cooperative stop's endgame: write the emergency intra-K sub-step
    (when ``payload`` is given), emit ``shutdown`` and raise
    ``PreemptedError`` (exit 75 in the CLI)."""
    if payload is not None:
        checkpointed = bool(
            ckpt is not None
            and ckpt.save_substep(int(step), int(em_iter), payload))
    checkpointed = bool(checkpointed)
    if rec.active:
        fields = dict(reason=sup.stop_reason or "unknown",
                      checkpointed=checkpointed)
        if step is not None:
            fields["step"] = int(step)
        if k is not None:
            fields["k"] = int(k)
        if em_iter is not None:
            fields["em_iter"] = int(em_iter)
        rec.emit("shutdown", **fields)
        if checkpointed:
            rec.metrics.count("emergency_checkpoints")
    log.warning(
        "stopping (%s)%s: emergency checkpoint %s", sup.stop_reason,
        (f" at K={k}" + (f" iteration {em_iter}" if em_iter is not None
                         else "")) if k is not None else "",
        "written" if checkpointed else
        ("not needed (sweep position already durable)" if payload is None
         and ckpt is not None else "unavailable"))
    sup.raise_stop(step=step, em_iter=em_iter, checkpointed=checkpointed)


def _reseed_and_refit(model, config, state, chunks, wts, epsilon, k,
                      n_events, rec, log, primary):
    """Reseed empty clusters from worst-fit events and refit at the same K
    (``recovery_reseed_empty``; at most ``max_recovery_attempts`` times).
    Returns the refit ``(state, loglik, iters, counts, lls)``; a refit that
    goes fatal is discarded for the pre-reseed result."""
    best = (state,) + tuple(primary)
    for attempt in range(1, config.max_recovery_attempts + 1):
        state2, n_reseeded = health.reseed_empty_clusters(model, best[0],
                                                         chunks)
        if not n_reseeded:
            break
        new_state, ll_a, iters_a = model.run_em(state2, chunks, wts, epsilon,
                                                n_events=n_events)
        counts_a = model.last_health
        fatal_a = health.word_is_fatal(health.pack_word(counts_a))
        outcome = ("fatal" if fatal_a
                   else "recovered" if counts_a[health.EMPTY_CLUSTER] == 0
                   else "retry")
        log.info("reseeded %d empty cluster(s) at K=%d (attempt %d): %s",
                 n_reseeded, int(k), attempt, outcome)
        if rec.active:
            rec.emit("recovery", k=int(k), attempt=attempt,
                     action="reseed_empty", outcome=outcome,
                     flags=int(health.pack_word(counts_a)),
                     flag_names=health.flag_names(
                         health.pack_word(counts_a)))
            rec.metrics.count("reseeds")
        if fatal_a:
            return best
        best = (new_state, ll_a, iters_a, counts_a, model.last_lls)
        if counts_a[health.EMPTY_CLUSTER] == 0:
            break
    return best


@dataclasses.dataclass
class GMMResult:
    """The best (lowest-score) configuration across the sweep.

    ``state`` is compacted (inactive slots dropped) and lives on the CPU;
    ``means`` are in the original data coordinates (the centering shift is
    undone). ``sweep_log`` holds one (num_clusters, loglik, score, em_iters,
    seconds) row per K; ``merges`` one (k_active, (c1, c2), distance) row
    per merge, with c1 < c2 the pair's positions in the compacted order.
    ``init_index`` is the restart that won an ``n_init > 1`` fit (None for
    a single init). ``health`` is the run's numerical-health summary
    (``health.health_summary``: the flag word and counters over every K,
    the recoveries and checkpoint retries; ``{"flags": 0, ...}`` when
    clean). ``timings`` holds the host-clock seconds of the batched
    restart driver's parts (prepare, seed, em, merge; empty on the other
    paths): consecutive pieces of the fit's wall, so device work that a
    piece leaves queued is counted in the next one that waits for it.
    """

    state: GMMState
    ideal_num_clusters: int
    min_rissanen: float
    final_loglik: float
    epsilon: float
    num_events: int
    num_dimensions: int
    data_shift: np.ndarray
    sweep_log: list = dataclasses.field(default_factory=list)
    merges: list = dataclasses.field(default_factory=list)
    model: Optional[GMMModel] = dataclasses.field(default=None, repr=False)
    init_index: Optional[int] = None
    timings: dict = dataclasses.field(default_factory=dict)
    health: Optional[dict] = None

    @property
    def means(self) -> np.ndarray:
        return np.asarray(self.state.means) + self.data_shift[None, :]

    @property
    def covariances(self) -> np.ndarray:
        return np.asarray(self.state.R)

    @property
    def weights(self) -> np.ndarray:
        return np.asarray(self.state.pi)


def _moments(data: np.ndarray, chunk_size: int):
    """Per-dimension float64 (mean, E[x^2]-E[x]^2): per-chunk partial sums
    added in chunk order (the JAX package's ``global_moments`` on one host,
    so both packages center on the same bits)."""
    d = data.shape[1]
    num_chunks = -(-data.shape[0] // chunk_size)
    parts = np.zeros((num_chunks, 1 + 2 * d), np.float64)
    for j in range(num_chunks):
        block = data[j * chunk_size:(j + 1) * chunk_size]
        parts[j, 0] = block.shape[0]
        parts[j, 1:1 + d] = block.sum(axis=0, dtype=np.float64)
        parts[j, 1 + d:] = (block.astype(np.float64) ** 2).sum(axis=0)
    total = parts.sum(axis=0)
    mean = total[1:1 + d] / total[0]
    return mean, total[1 + d:] / total[0] - mean * mean


def _seed_rows(data: np.ndarray, num_clusters: int, n_events: int, *,
               seed_method: str, seed: int, init_means=None) -> np.ndarray:
    """One init's K seed rows in ORIGINAL data coordinates: ``init_means``
    verbatim, the k-means++ draw (deterministic per ``seed``) or the
    reference's evenly spaced rows in float32 index math
    (gaussian.cu:108-123). Shared by ``_prepare_fit`` and the batched
    restart path, so both seed every init identically."""
    if init_means is not None:
        rows = np.asarray(init_means)
        if rows.shape != (num_clusters, data.shape[1]):
            raise ValueError(
                f"init_means must be [{num_clusters}, {data.shape[1]}], got "
                f"{rows.shape}")
        return rows
    if seed_method == "kmeans++":
        pool, rng = kmeanspp_pool(n_events, seed=seed)
        x_pool = np.asarray(data[pool])
        return x_pool[kmeanspp_from_pool(x_pool, num_clusters, rng)]
    return data[seed_means_indices(n_events, num_clusters)]


def _check_sample_weight(sample_weight, n_events: int,
                         num_clusters: int) -> np.ndarray:
    """``sample_weight`` as float64 [n_events], or an error: ValueError for
    its shape; InvalidInputError for a weight not finite or negative, or a
    total below ``num_clusters`` (weights are event multiplicities: the
    absolute Nk thresholds would call every cluster empty)."""
    w = np.asarray(sample_weight, np.float64)
    if w.shape != (n_events,):
        raise ValueError(f"sample_weight must be [{n_events}], got {w.shape}")
    if not np.isfinite(w).all() or (w < 0).any():
        raise InvalidInputError("sample_weight must be finite and nonnegative")
    total = float(w.sum())
    if total < num_clusters:
        raise InvalidInputError(
            f"sample_weight sums to {total:.4g} < num_clusters="
            f"{num_clusters}: weights are event multiplicities, not "
            "probabilities -- scale them up (e.g. multiply normalized "
            "weights by the event count)")
    return w


def _prepare_data(data: np.ndarray, config: GMMConfig, model: GMMModel,
                  num_clusters: int = 1, sample_weight=None):
    """Validate, center, chunk and place the events. Returns (data, chunks,
    wts, n_events, n_dims, shift, var_mean), ``data`` as a contiguous host
    array. ``sample_weight`` (checked against ``num_clusters``) becomes the
    events' weight row; the moments, seeding and event counts stay
    unweighted, as in the JAX package."""
    data = np.ascontiguousarray(data)
    n_events, n_dims = data.shape
    if sample_weight is not None:
        sample_weight = _check_sample_weight(sample_weight, n_events,
                                             num_clusters)
    dtype = np.dtype(config.dtype)
    # Before any arithmetic touches the data: reject rows non-finite now or
    # after the cast to the compute dtype.
    validate_finite(data, dtype=dtype)
    mean64, var64 = _moments(data, config.chunk_size)
    # Global centering keeps the expanded quadratic form well-conditioned
    # (shift-equivariant: EM on x-c equals EM on x, means shifted by c).
    shift = (mean64.astype(dtype) if config.center_data
             else np.zeros((n_dims,), dtype))
    local = data.astype(dtype, copy=False)
    if config.center_data:
        local = local - shift[None, :]
    chunks_np, wts_np = chunk_events(
        local, config.chunk_size,
        num_shards=model.mesh.data_size if _sharded(model) else 1,
        sample_weight=(None if sample_weight is None
                       else sample_weight.astype(dtype)))
    if _sharded(model):  # this rank's block of the chunk grid
        chunks_np, wts_np = shard_chunks(model.mesh, chunks_np, wts_np)
    chunks, wts = model.place(chunks_np), model.place(wts_np)
    return (data, chunks, wts, n_events, n_dims, shift, float(var64.mean()))


def _prepare_fit(data: np.ndarray, num_clusters: int, config: GMMConfig,
                 model: GMMModel, prepared=None, init_means=None,
                 sample_weight=None):
    """Prepare the data (unless ``prepared``, a :func:`_prepare_data`
    result, is given) and seed. Returns (state, chunks, wts, n_events,
    n_dims, shift)."""
    if prepared is None:
        prepared = _prepare_data(data, config, model, num_clusters,
                                 sample_weight)
    data, chunks, wts, n_events, n_dims, shift, var_mean = prepared
    dtype = np.dtype(config.dtype)
    # Seed rows in ORIGINAL coordinates, shifted into fit coordinates.
    rows = _seed_rows(data, num_clusters, n_events,
                      seed_method=config.seed_method, seed=config.seed,
                      init_means=init_means)
    state = seed_state_from_parts(
        np.asarray(rows, dtype) - shift[None, :], n_events, var_mean,
        num_clusters, covariance_dynamic_range=config.covariance_dynamic_range,
        dtype=dtype, device=model.device)
    # Deterministic singular-covariance injection (testing.faults), before
    # mesh placement as in the JAX package.
    state = faults.maybe_poison_state(state)
    if _sharded(model):
        state = model.prepare_state(state)
    return state, chunks, wts, n_events, n_dims, shift


def _sharded(model) -> bool:
    return model.mesh is not None


def default_model(config: GMMConfig):
    """The model ``fit_gmm`` builds: ``parallel.ShardedGMMModel`` when
    ``mesh_shape`` is set or the torch.distributed world has more than one
    rank, else :class:`GMMModel`."""
    from ..parallel import ShardedGMMModel, distributed

    if config.mesh_shape is not None or distributed.world_size() > 1:
        return ShardedGMMModel(config)
    return GMMModel(config)


def fit_gmm(data: np.ndarray, num_clusters: int, target_num_clusters: int = 0,
            config: GMMConfig = GMMConfig(), model: Optional[GMMModel] = None,
            verbose: Optional[bool] = None,
            init_means: Optional[np.ndarray] = None,
            sample_weight: Optional[np.ndarray] = None,
            _prepared=None) -> GMMResult:
    """Full GMM fit with model-order search -- the library entry point.

    Args mirror the reference CLI (gaussian.cu:1111-1178): ``num_clusters``
    is the starting K (1..max_clusters); ``target_num_clusters`` = 0 means
    search all the way down to 1 keeping the best score
    (``config.criterion``), else stop at (and keep) that K. Runs on
    ``config.device`` ('cuda' by default). With ``config.n_init > 1``, runs
    that many restarts and returns the best (``GMMResult.init_index`` names
    it). ``init_means`` ([K, D], original coordinates) replaces the seeding
    of init 0; the k-means++ restarts still run. ``sample_weight`` ([N]
    nonnegative event multiplicities) weights every sufficient statistic:
    integer weights reproduce replicated rows, except for the avgvar
    loading, which is seeded from the unweighted variance; a total below
    ``num_clusters`` is rejected. Seeding and the epsilon/criterion event
    counts stay unweighted. ``_prepared`` is the restart driver's
    :func:`_prepare_data` result, shared by its inits.

    With ``config.metrics_file`` the fit runs under a
    :class:`~cuda_gmm_mpi_tpu_torch.telemetry.RunRecorder` (an ambient one
    a caller activated is reused); with ``config.max_runtime_s`` and no
    ambient supervisor, under a deadline-only
    :class:`~cuda_gmm_mpi_tpu_torch.supervisor.RunSupervisor`.
    """
    with contextlib.ExitStack() as stack:
        if config.metrics_file and not telemetry.current().active:
            rec = telemetry.RunRecorder(config.metrics_file)
            stack.enter_context(telemetry.use(rec))
            stack.enter_context(rec)
        if (config.max_runtime_s is not None
                and not supervisor.current().active):
            # No signal handlers from a library call: taking over a host
            # application's SIGTERM is the CLI's business.
            stack.enter_context(supervisor.use(supervisor.RunSupervisor(
                max_runtime_s=config.max_runtime_s, install_signals=False)))
        return _fit_gmm(data, num_clusters, target_num_clusters, config,
                        model, verbose, init_means, sample_weight, _prepared)


def _check_supervision(config) -> None:
    """Checkpoints and the supervisor need the whole sweep state on one
    process: on a mesh of more than one rank they are not ported yet."""
    from ..parallel import distributed

    if distributed.world_size() > 1 and (
            config.checkpoint_dir or config.max_runtime_s is not None
            or supervisor.current().active):
        raise NotImplementedError(
            "checkpoints (--checkpoint-dir), --max-runtime and the run "
            "supervisor on a mesh of more than one rank are not ported yet "
            "(ROADMAP.md item 9: multi-host liveness and elastic recovery); "
            "run them on one process")


def _fit_gmm(data, num_clusters, target_num_clusters, config, model,
             verbose, init_means, sample_weight, _prepared) -> GMMResult:
    """fit_gmm's body, under whatever ambient recorder and supervisor."""
    if not (1 <= num_clusters <= config.max_clusters):
        raise ValueError(f"num_clusters must be in [1, {config.max_clusters}],"
                         f" got {num_clusters}")
    if target_num_clusters > num_clusters:
        raise ValueError("target_num_clusters must be <= num_clusters")
    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    verbose = config.enable_print if verbose is None else verbose
    _check_supervision(config)
    model = model or default_model(config)
    if config.n_init > 1 and _sharded(model):
        raise NotImplementedError(
            "n_init > 1 on a mesh is not ported yet (ROADMAP.md: batched "
            "restarts on a mesh); run the restarts on one device")
    if config.n_init > 1:
        return _fit_with_restarts(data, num_clusters, target_num_clusters,
                                  config, model, verbose, init_means,
                                  sample_weight)
    diag_only = config.diag_only
    log = get_logger(config)
    rec = telemetry.current()

    state, chunks, wts, n_events, n_dims, shift = _prepare_fit(
        data, num_clusters, config, model, _prepared, init_means,
        sample_weight)
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462

    sharded = _sharded(model)
    if rec.active:
        rec.set_context(path="sharded" if sharded else "in-memory",
                        mesh=list(model.mesh.shape) if sharded else None)
        _emit_run_start(rec, model, config, n_events, n_dims, num_clusters,
                        target_num_clusters, epsilon)

    ckpt = None
    if config.checkpoint_dir:
        from ..utils.checkpoint import SweepCheckpointer

        ckpt = SweepCheckpointer(config.checkpoint_dir,
                                 keep=config.checkpoint_keep,
                                 retries=config.checkpoint_retries)
    sup = supervisor.current()

    sweep_log, merges = [], []
    min_rissanen = math.inf
    ideal_k, best_state, best_ll = num_clusters, state, -math.inf
    k = num_clusters
    step = 0
    resume_em = None
    resume_sub_step = None
    if ckpt is not None and config.resume != "never":
        # A live intra-K sub-step outranks every full step (its step is the
        # one in flight) and carries the whole sweep position, so it is
        # read first; the JAX package reads the full step first and lets
        # the sub-step override it, which selects the same checkpoint.
        restored = ckpt.restore_substep()
        if restored is not None and (
                _resume_mismatch(restored, config, log)
                or int(restored["num_clusters"]) != num_clusters):
            restored = None
        if restored is None:
            restored = ckpt.restore()
            if restored is not None and (
                    _resume_mismatch(restored, config, log)
                    or int(restored["num_clusters"]) != num_clusters):
                restored = None
        if restored is not None:
            state = _place_state(restored["state"], model)
            best_state = restored["best_state"].to(model.device)
            min_rissanen = float(restored["min_rissanen"])
            ideal_k = int(restored["ideal_k"])
            best_ll = float(restored["best_ll"])
            k = int(restored["k"])
            sweep_log = [tuple(r) for r in np.asarray(
                restored["sweep_log"]).tolist()] if len(
                    restored.get("sweep_log", [])) else []
            if "em_iter" in restored:
                step = resume_sub_step = int(restored["step"])
                resume_em = {"em_iter": int(restored["em_iter"]),
                             "em_lls": np.asarray(
                                 restored.get("em_lls", ()), np.float64)}
                log.info("resuming INSIDE the interrupted fit: K=%d at EM "
                         "iteration %d (intra-K sub-step %d.iter%d)",
                         k, resume_em["em_iter"], step, resume_em["em_iter"])
            else:
                step = int(restored["step"]) + 1
                log.info("resumed sweep from checkpoint: next K=%d", k)
            if rec.active:
                rec.metrics.count("resumes")

    def checkpoint_payload(cur_state):
        return {
            "state": _host_state(cur_state, model),
            "best_state": _to_host(best_state),
            "min_rissanen": float(min_rissanen),
            "ideal_k": int(ideal_k),
            "best_ll": float(best_ll),
            "k": int(k),
            "num_clusters": int(num_clusters),
            "criterion_code": _CRITERION_CODE[config.criterion],
            "cov_code": _COV_CODE[config.covariance_type],
            "sweep_log": np.asarray(sweep_log, np.float64),
            "data_shift": np.asarray(shift, np.float64),
        }

    recovery_on = config.recovery == "retry"
    health_totals = np.zeros((health.NUM_FLAGS,), np.int64)
    n_recoveries = 0
    # With a supervisor AND checkpoints the EM loop polls the stop flag
    # (and can write an emergency mid-EM sub-step).
    supervised = sup.active and ckpt is not None
    em_walls, em_widths = [], []
    n_rebuckets = 0
    reduce_s = cpu_s = memcpy_s = 0.0
    reduce_n = cpu_n = 0
    while k >= stop_number:
        if sup.active and sup.poll(where="sweep", k=int(k)):
            # Between Ks every completed K is already durable.
            _shutdown_and_raise(sup, rec, log, ckpt,
                                step=step - 1 if step else None, k=int(k),
                                checkpointed=ckpt is not None and step > 0)
        t0 = time.perf_counter()
        last_k = k <= stop_number
        em_widths.append(int(state.num_clusters_padded))
        rollback = clone_state(state) if recovery_on else None
        if supervised or resume_em is not None:
            state, ll, iters, _, stopped, extra = model.run_em_resumable(
                state, chunks, wts, epsilon, n_events=n_events, sweep=True,
                poll_iters=config.preempt_poll_iters,
                should_stop=((lambda done, _k=int(k): sup.poll(
                    where="em", k=_k, em_iter=done)) if sup.active else None),
                resume=resume_em)
            resume_em = None
            if stopped:
                payload = checkpoint_payload(state)
                if not math.isfinite(best_ll):
                    # No K has completed: the mid-EM state stands in (the
                    # resumed first K always takes the best slot anyway).
                    payload["best_state"] = payload["state"]
                payload.update(extra)
                _shutdown_and_raise(sup, rec, log, ckpt, step=step, k=int(k),
                                    em_iter=int(iters), payload=payload)
            if resume_sub_step is not None and ckpt is not None:
                # The interrupted K completed: its sub-step is superseded.
                ckpt.discard_substeps(resume_sub_step)
                resume_sub_step = None
        else:
            state, ll, iters = model.run_em(state, chunks, wts, epsilon,
                                            n_events=n_events, sweep=True)
        counts = model.last_health
        lls = model.last_lls
        dt = time.perf_counter() - t0  # EM only: run_em ends on a host read
        if health.word_is_fatal(health.pack_word(counts)):
            # The observed fault is recorded before recovery replaces the
            # counters with the retried run's.
            health_totals += counts
            _emit_health(rec, k, counts)
            model, state, ll, iters, counts, lls = health.recover_em(
                model, config, rollback, chunks, wts, epsilon, k,
                n_events=n_events, rec=rec, log=log, faulty_counts=counts)
            n_recoveries += 1
            dt = time.perf_counter() - t0
        if (last_k and config.recovery_reseed_empty and target_num_clusters
                and counts[health.EMPTY_CLUSTER] > 0):
            state, ll, iters, counts, lls = _reseed_and_refit(
                model, config, state, chunks, wts, epsilon, k, n_events,
                rec, log, (ll, iters, counts, lls))
            dt = time.perf_counter() - t0
        del rollback
        health_totals += counts
        _emit_health(rec, k, counts)
        if sharded:  # the mesh row's clusters, on every rank of the row
            state = model.gather_state(state)
        riss = model_score(ll, k, n_events, n_dims,
                           criterion=config.criterion,
                           covariance_type=config.covariance_type)
        score_ok = math.isfinite(riss)
        if not score_ok:
            # NaN compares false both ways: it must never take the best slot.
            health_totals[health.NONFINITE_SCORE] += 1
            log.warning("non-finite %s score at K=%d; excluded from "
                        "best-model selection", config.criterion, k)
            _emit_score_health(rec, k)
        sweep_log.append((k, ll, riss, iters, dt))
        em_walls.append(dt)
        if verbose:
            print(f"K={k}: loglik={ll:.6e} {config.criterion}={riss:.6e} "
                  f"iters={iters} ({dt:.2f}s)")
        if rec.active:
            rec.metrics.count("em_iters", int(iters))
            rec.metrics.gauge("active_k", int(k))
            rec.metrics.series("active_k", int(k))
            _emit_em_iters(rec, k, lls, iters, dt, epsilon)
            rec.emit("em_done", k=int(k), loglik=float(ll), score=float(riss),
                     criterion=config.criterion, iters=int(iters),
                     seconds=round(dt, 6))
            rec.heartbeat("sweep", k=int(k))
        # gaussian.cu:839, NaN-score-guarded (health.NONFINITE_SCORE).
        if score_ok and (k == num_clusters
                         or (riss < min_rissanen and target_num_clusters == 0)
                         or k == target_num_clusters):
            min_rissanen, ideal_k = riss, k
            best_state, best_ll = state, ll
        if last_k:
            break
        # Order reduction (gaussian.cu:857-952).
        t1 = time.perf_counter()
        next_state, k, min_d, pair = eliminate_and_reduce(
            state, diag_only=diag_only)
        reduce_s += time.perf_counter() - t1
        reduce_n += 1
        if sharded:
            model.assert_same_merge(k, pair)
        if k < 2:
            break
        if verbose:
            print(f"non-empty clusters: {k}; merging closest pair "
                  f"{pair[0]},{pair[1]}")
        if not math.isfinite(min_d):
            # No valid merge pair (degenerate covariances everywhere).
            print(f"no valid merge pair at K={k}; stopping sweep",
                  file=sys.stderr)
            break
        if rec.active:
            rec.emit("merge", k_active=int(k), next_k=int(k) - 1,
                     min_distance=float(min_d),
                     pair=[int(pair[0]), int(pair[1])])
            rec.metrics.count("merges")
        merges.append((k, pair, min_d))
        state = next_state
        k -= 1
        cur_w = state.num_clusters_padded
        width = bucket_width(k, cur_w, multiple=model.bucket_multiple)
        t1 = time.perf_counter()
        if sharded:
            state = model.rebucket_state(state, width)
        elif width < cur_w:
            state = compact_to(state, width)
        memcpy_s += time.perf_counter() - t1
        if width < cur_w:
            n_rebuckets += 1
            if rec.active:
                rec.metrics.count("rebuckets")
                rec.emit("rebucket", k_active=int(k), from_width=int(cur_w),
                         to_width=int(state.num_clusters_padded))
        if ckpt is not None:
            t1 = time.perf_counter()
            if rec.active:
                rec.metrics.count("checkpoint_saves")
            ckpt.save(step, checkpoint_payload(state))
            cpu_s += time.perf_counter() - t1
            cpu_n += 1
        step += 1

    compact_state, n_active = compact(best_state)
    if verbose:
        # Exact reference wording for the default criterion (gaussian.cu:962).
        print(f"Final {config.criterion} score was: {min_rissanen}, "
              f"with {ideal_k} clusters.")
    health_section = health.health_summary(
        health_totals, recoveries=n_recoveries,
        io_retries=ckpt.io_retries if ckpt is not None else 0)
    _emit_run_summary(
        rec, model, config, sweep_log, n_active, float(min_rissanen),
        float(best_ll), em_walls,
        buckets=dict(mode="pow2", em_widths=sorted(set(em_widths),
                                                   reverse=True),
                     em_compiles=len(set(em_widths)),
                     rebuckets=n_rebuckets),
        health_section=health_section,
        phase_profile=_phase_profile(
            em_s=float(sum(em_walls)), em_n=len(em_walls),
            reduce_s=reduce_s, reduce_n=reduce_n, cpu_s=cpu_s, cpu_n=cpu_n,
            memcpy_s=memcpy_s, memcpy_n=n_rebuckets))
    return GMMResult(
        state=compact_state.to("cpu"), ideal_num_clusters=n_active,
        min_rissanen=float(min_rissanen), final_loglik=float(best_ll),
        epsilon=epsilon, num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=sweep_log, merges=merges,
        model=model, health=health_section)


def _fit_with_restarts(data, num_clusters: int, target_num_clusters: int,
                       config: GMMConfig, model: GMMModel,
                       verbose: bool, init_means=None,
                       sample_weight=None) -> GMMResult:
    """``n_init`` independent fits, keeping the best score.

    Init 0 uses ``init_means`` when given, else the caller's
    ``seed_method``; restarts i >= 1 use k-means++ at ``seed + i``. A
    restart batch size above 1 runs the inits through the batched path
    (models/restarts.py); 1 runs one ``fit_gmm`` per init. Both pick the
    first init with the lowest score, and a NaN score never holds the best
    slot. The data (with ``sample_weight``) is prepared once and handed to
    every init.
    """
    from .restarts import fit_restarts_batched, resolve_restart_batch_size

    batch_size = resolve_restart_batch_size(config, data, num_clusters,
                                            model.device)
    t0 = time.perf_counter()
    prepared = _prepare_data(data, config, model, num_clusters, sample_weight)
    prepare_s = time.perf_counter() - t0
    if batch_size > 1:
        result = fit_restarts_batched(prepared, num_clusters,
                                      target_num_clusters, config, model,
                                      verbose, batch_size, init_means)
        result.timings["prepare"] = prepare_s
        return result
    best, best_i = None, None
    init_scores = []  # each init's best criterion score (restart_select)
    rec = telemetry.current()
    for i in range(config.n_init):
        if rec.active:
            # The init tags every record of its sub-fit; all inits share
            # one stream.
            rec.set_context(init=i)
            if i:
                rec.metrics.count("restarts")
        sub = dataclasses.replace(
            config, n_init=1,
            seed_method=config.seed_method if i == 0 else "kmeans++",
            seed=config.seed + i,
            checkpoint_dir=(os.path.join(config.checkpoint_dir, f"init{i}")
                            if config.checkpoint_dir else None))
        r = fit_gmm(data, num_clusters, target_num_clusters, config=sub,
                    model=model, verbose=verbose,
                    init_means=init_means if i == 0 else None,
                    _prepared=prepared)
        model = r.model  # a recovery rung's model stays (sticky escalation)
        if verbose:
            print(f"init {i}: {config.criterion}={r.min_rissanen:.6e} "
                  f"K={r.ideal_num_clusters}")
        init_scores.append(float(r.min_rissanen))
        if (best is None or math.isnan(best.min_rissanen)
                or r.min_rissanen < best.min_rissanen):
            best, best_i = r, i
    best.init_index = best_i
    if rec.active:
        rec.set_context(init=None)
        rec.emit("restart_select", winner=int(best_i),
                 scores=[x if math.isfinite(x) else None
                         for x in init_scores],
                 criterion=config.criterion, mode="sequential",
                 batch_size=1)
    if verbose:
        print(f"best of {config.n_init} inits: "
              f"{config.criterion}={best.min_rissanen:.6e} "
              f"K={best.ideal_num_clusters}")
    return best


def iter_memberships(result: GMMResult, data: np.ndarray,
                     config: GMMConfig = GMMConfig(),
                     model: Optional[GMMModel] = None):
    """Yield ``(data_block, posteriors_block)`` per block, original coords.

    Each block is shifted into fit coordinates, padded to the block size and
    its posteriors recomputed from the final parameters (the memberships are
    computed on the un-centered data's shifted copy, never stored at N x K).
    """
    model = model or result.model or GMMModel(config)
    dtype = np.dtype(config.dtype)
    n, d = data.shape
    B = model.inference_block
    shift = np.asarray(result.data_shift, dtype)[None, :]
    state = result.state.to(model.device)
    for lo in range(0, n, B):
        block = data[lo:lo + B]
        valid = block.shape[0]
        xb = block.astype(dtype, copy=False) - shift
        if valid < B:
            xb = np.concatenate([xb, np.zeros((B - valid, d), dtype)])
        w, _ = model.infer_posteriors(state, xb)
        yield block, w[:valid].cpu().numpy()


def compute_memberships(result: GMMResult, data: np.ndarray,
                        config: GMMConfig = GMMConfig(),
                        model: Optional[GMMModel] = None) -> np.ndarray:
    """Posteriors [N, K_final] recomputed from the saved parameters."""
    blocks = [w for _, w in iter_memberships(result, data, config, model)]
    return np.concatenate(blocks, axis=0)
