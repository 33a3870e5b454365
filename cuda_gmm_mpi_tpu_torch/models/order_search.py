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
clusters pays products at width ~k instead of the starting K. Each width's
EM is one program (``GMMModel.em_program``: a CUDA-graph capture on the
card), at most ceil(log2 K0) + 1 of them.

With ``n_init > 1`` the fit runs independent restarts and keeps the best
score (``_fit_with_restarts``): in batches through ``models/restarts.py``
(one batched EM loop per batch), or one ``fit_gmm`` per init with
``restart_batch_size=1``. Either way the data is centred, chunked and
uploaded once per fit and handed to every init.

On a mesh (``config.mesh_shape``, or a torch.distributed world of more than
one rank) the fit runs on every rank through ``parallel.ShardedGMMModel``:
each rank holds only its block of the chunk grid (``_prepare_data``: a
range read of a file source, or a slice of an in-memory array), centres on
the global moments of every rank's slice, and keeps its clusters. Before
each merge scan the ranks of a mesh row gather their clusters; every rank
runs the same scan on the same state, checks with one all_reduce that all
chose the same pair, and keeps its own rows of the result. Every rank
returns the same ``GMMResult`` but for ``host_range``, its own rows.
Restarts run on the mesh too: one batched loop over each rank's events
(K3, one all_reduce of the lanes' statistics, K4), or on a cluster-sharded
mesh the lanes of the mesh's own loop.

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
(telemetry/). On a mesh every rank builds the checkpointer (rank 0
writes), polls the supervisor at the same points (a stop on any rank stops
all of them there: ``RunSupervisor.poll_world``) and, with a checkpoint
directory, runs the liveness watchdog; ``elastic`` shrinks the world over
the survivors of a lost peer and refits from the newest checkpoint (the
retry loop of :func:`fit_gmm`).

With ``stream_events`` the fit runs on ``models.StreamingGMMModel``: the
chunk grid stays on the host and every E-step pass streams it through the
device block by block (a data mesh ``(S, 1)`` streams each rank's slice).
Under ``ingest='pipelined'`` the events are never read whole:
``_prepare_data`` takes the moments and the input check in one pass of
range reads (``io.streamed_moments``) and hands the model a
``io.PipelinedBlockSource`` that reads each block on a worker thread. The
outermost :func:`fit_gmm` owns that source: it closes it (joining its
worker) on every way out, and an elastic refit re-seeks it to the
survivor's rows instead of reopening the file.

Observability at the JAX package's sites and under its conditions: a fit
with an active recorder (or ``profile``) times its phases in the
reference's seven categories (``utils/profiling.PhaseTimer``:
``GMMResult.profile``/``profile_report``, ``run_summary.phase_profile``)
and runs under a compile watch (``telemetry/profiling.py``: kernel builds
and CUDA-graph captures as ``compile`` events, the ``sweep``/``em_k``
memory watermarks, ``run_summary.profile``); ``metrics_port`` starts the
live plane (the OpenMetrics endpoint and the resource sampler) and the
trace spans ``fit`` > ``sweep`` > ``em_k`` / ``recovery`` /
``checkpoint`` (``fused_sweep`` on that path); ``envelope`` (on by
default) sketches the fit data under the final parameters
(:func:`compute_envelope`).

``sweep_k_buckets='off'`` keeps the starting width for every K. With
``fused_sweep`` the whole sweep runs on the device (models/fused_sweep.py,
``_run_fused_sweep``): fixed-width, the per-K checkpoints and the
recorder's per-K seconds through its per-K emission, where a requested
stop also lands; a fatal word falls back to the host-driven sweep and its
recovery ladder under ``recovery='retry'``. A model without it (a mesh)
runs the host-driven sweep with the JAX package's warning.
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
from ..state import GMMState, bucket_width, clone_state, compact, compact_to
from ..telemetry import exporter as tl_exporter
from ..telemetry import profiling as tl_profiling
from ..telemetry import sketch as tl_sketch
from ..telemetry import spans as tl_spans
from ..testing import faults
from ..utils.logging_ import get_logger, metrics_line
from ..utils.profiling import PhaseTimer
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
        fused_sweep=bool(config.fused_sweep),
        stream_events=bool(config.stream_events),
        n_init=int(config.n_init),
        em_backend=model.estep_backend,
        em_backend_reason=model.estep_backend_reason,
        memory_stats=telemetry.memory_stats(dev), **extra)


def _emit_em_iters(rec, k, lls, iters, dt, epsilon, model=None):
    """Per-iteration ``em_iter`` records of one K's EM from its loglik
    trajectory (slot 0 the initial E-step's). The wall time is measured
    where the model's host loop measured it (``last_iter_seconds`` of the
    streaming model), else amortized over the K (the JAX package's
    ``timing``)."""
    if not rec.active or lls is None or iters <= 0:
        return
    n = min(int(iters), len(lls) - 1)
    secs = getattr(model, "last_iter_seconds", None)
    measured = isinstance(secs, list) and len(secs) == iters
    for i in range(n):
        wall = secs[i] if measured else dt / max(iters, 1)
        rec.emit("em_iter", k=int(k), iter=i, loglik=float(lls[i + 1]),
                 delta=float(lls[i + 1] - lls[i]), epsilon=float(epsilon),
                 wall_s=round(float(wall), 6),
                 timing="measured" if measured else "amortized")


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


@contextlib.contextmanager
def _null_phase(_name):
    yield


def compute_envelope(model, state, chunks, n_events, k):
    """The training envelope (telemetry/sketch.py): one pass of the fit's
    events through the final compacted ``state``, sketching the
    per-event log evidence and counting each cluster's argmax occupancy
    -- the distribution serve-time drift is measured against.

    The events stay on the device: block by block (one chunk of the
    model's chunk grid, its ``inference_block``) through
    ``infer_posteriors``, with the argmax and the bincount on the device;
    only each block's log evidence goes to the host for the sketch. (The
    JAX package copies the whole array to the host first; the values are
    the same.) ``n_events`` is the fit's event count; on a mesh each rank
    of cluster index 0 sketches the real events of its data block, and
    the ranks' envelopes merge through ``allgather_json``, which every
    rank reaches. Observational: a failure logs and returns None."""
    from ..parallel import distributed

    log = get_logger()
    local = None
    try:
        B = int(chunks.shape[1])
        n_valid = int(n_events)
        mesh = getattr(model, "mesh", None)
        if mesh is not None:  # this rank's block of the chunk grid
            rows = int(chunks.shape[0]) * B
            n_valid = (min(max(n_valid - mesh.data_index * rows, 0), rows)
                       if mesh.cluster_index == 0 else 0)
        if n_valid > 0:
            k = int(k)
            state = state.to(model.device)
            sk = tl_sketch.StreamSketch()
            occ = torch.zeros((k,), dtype=torch.int64, device=model.device)
            for i in range(-(-n_valid // B)):
                valid = min(B, n_valid - i * B)
                w, logz = model.infer_posteriors(state, chunks[i])
                sk.update(logz[:valid].cpu().numpy())
                occ += torch.bincount(torch.argmax(w[:valid, :k], dim=1),
                                      minlength=k)
            local = tl_sketch.make_envelope(sk, occ.cpu().numpy(), k=k,
                                            num_events=n_valid)
    except Exception:  # noqa: BLE001 -- observational, never run-fatal
        log.warning("envelope computation failed; fit continues "
                    "without one", exc_info=True)
    if distributed.world_size() > 1:
        try:
            return tl_sketch.merge_envelopes(
                distributed.allgather_json(local))
        except Exception:  # noqa: BLE001
            log.warning("envelope allgather failed", exc_info=True)
            return None
    return local


def _emit_run_summary(rec, model, config, timer, sweep_log, ideal_k,
                      best_score, best_ll, em_walls, buckets=None,
                      health_section=None, envelope=None):
    """The final ``run_summary`` record (the JAX package's fields):
    ``profile`` from the active compile watch, ``phase_profile`` from
    ``timer`` (empty without one), ``envelope`` when computed."""
    if not rec.active:
        return
    from ..parallel import elastic

    first = em_walls[0] if em_walls else None
    warm = min(em_walls[1:]) if len(em_walls) > 1 else None
    watch = tl_profiling.active()
    elastic_section = elastic.run_summary_section()
    fields = dict(
        **({"profile": watch.snapshot()} if watch is not None else {}),
        **({"buckets": buckets} if buckets is not None else {}),
        **({"health": health_section} if health_section is not None else {}),
        # Present only when the run survived an elastic shrink.
        **({"elastic": elastic_section} if elastic_section is not None
           else {}),
        em_backend=model.estep_backend,
        **({"envelope": envelope} if envelope is not None else {}),
        ideal_k=int(ideal_k), score=float(best_score),
        criterion=config.criterion, final_loglik=float(best_ll),
        total_iters=int(sum(r[3] for r in sweep_log)),
        wall_s=round(float(sum(r[4] for r in sweep_log)), 6),
        phase_profile=(timer.snapshot() if timer is not None
                       else {"seconds": {}, "counts": {}}),
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
    ``profile``/``profile_report`` are the seven-category phase seconds and
    their table (with ``config.profile`` or an active recorder; None on
    the batched restart path, as in the JAX package); ``envelope`` the
    training envelope (:func:`compute_envelope`; None when
    ``config.envelope`` is off or it failed). ``host_range`` is the
    [start, stop) of the events this rank held ((0, num_events) in one
    process): the output pass computes the memberships of its own rows.
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
    profile: Optional[dict] = None
    profile_report: Optional[str] = None
    envelope: Optional[dict] = None
    host_range: Optional[tuple] = None

    @property
    def means(self) -> np.ndarray:
        return np.asarray(self.state.means) + self.data_shift[None, :]

    @property
    def covariances(self) -> np.ndarray:
        return np.asarray(self.state.R)

    @property
    def weights(self) -> np.ndarray:
        return np.asarray(self.state.pi)


def _host_bounds(n_events: int, chunk_size: int, model):
    """(start, stop, num_chunks): the events this rank holds -- its mesh
    row's block of the chunk grid (``host_chunk_bounds`` over the data
    axis; the ranks of one row share it), or all of them in one process."""
    from ..parallel.distributed import host_chunk_bounds

    mesh = getattr(model, "mesh", None)
    S, i = (mesh.data_size, mesh.data_index) if mesh is not None else (1, 0)
    return host_chunk_bounds(n_events, chunk_size, S, i, S)


def _seed_rows(data, num_clusters: int, n_events: int, *,
               seed_method: str, seed: int, init_means=None) -> np.ndarray:
    """One init's K seed rows in ORIGINAL data coordinates: ``init_means``
    verbatim, the k-means++ draw (deterministic per ``seed``) or the
    reference's evenly spaced rows in float32 index math
    (gaussian.cu:108-123). ``data`` is the events or a file source, whose
    ``read_rows`` fetches just those rows; every rank fetches the same
    ones. Shared by ``_prepare_fit`` and the batched restart path, so both
    seed every init identically."""
    def rows_at(idx):
        return (np.asarray(data.read_rows(idx)) if hasattr(data, "read_rows")
                else np.asarray(data[idx]))

    if init_means is not None:
        rows = np.asarray(init_means)
        if rows.shape != (num_clusters, data.shape[1]):
            raise ValueError(
                f"init_means must be [{num_clusters}, {data.shape[1]}], got "
                f"{rows.shape}")
        return rows
    if seed_method == "kmeans++":
        pool, rng = kmeanspp_pool(n_events, seed=seed)
        x_pool = rows_at(pool)
        return x_pool[kmeanspp_from_pool(x_pool, num_clusters, rng)]
    return rows_at(np.asarray(seed_means_indices(n_events, num_clusters)))


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


def _prepare_data(data, config: GMMConfig, model: GMMModel,
                  num_clusters: int = 1, sample_weight=None,
                  phase=_null_phase, ingest: Optional[dict] = None):
    """Validate, center, chunk and place this rank's events. Returns (data,
    chunks, wts, n_events, n_dims, shift, var_mean): ``data`` the events
    as a contiguous host array, or the file source it was given, for the
    seeding rows.

    Each rank takes only its block of the chunk grid (``_host_bounds``):
    from a file source (``io.FileSource``) it reads just those rows; an
    in-memory array, which every rank holds, is sliced. The centering
    moments are the global ones from every rank's per-chunk partials
    (``parallel.distributed.global_moments``, the same bits for every rank
    count), and a non-finite row on any rank fails every rank. The JAX
    package's multi-process ``_prepare_fit`` (order_search.py:1296-1420).
    ``sample_weight`` (checked against ``num_clusters``; in-memory only)
    becomes the events' weight row; the moments, seeding and event counts
    stay unweighted. ``phase`` times the steps in the JAX package's
    categories (cpu, mpi for the moments, memcpy for the placement).

    Under ``stream_events`` the chunk grid stays on the host (the model's
    ``place``); with ``ingest='pipelined'`` (a file source only) nothing is
    read whole: ``chunks`` is a ``io.PipelinedBlockSource`` over this
    rank's rows and ``wts`` None. ``ingest`` is the outermost fit's holder
    of that source (``ingest['source']``): a live one over the same file
    is re-seeked to this rank's rows, else a new one is made and kept
    there."""
    from ..parallel import distributed

    source = data if hasattr(data, "read_range") else None
    mesh = model.mesh if _sharded(model) else None
    pipelined = config.stream_events and config.ingest == "pipelined"
    if pipelined and source is None:
        raise ValueError(
            "ingest='pipelined' reads per-block byte ranges from a file "
            "source; an in-memory array is already resident -- pass an "
            "io.FileSource or keep ingest='resident'")
    if pipelined:
        if sample_weight is not None:
            raise ValueError("sample_weight requires in-memory event data "
                             "(a file source carries no weights)")
        return _prepare_pipelined(source, config, model, mesh, phase,
                                  {} if ingest is None else ingest)
    with phase("cpu"):
        if source is not None:
            if sample_weight is not None:
                raise ValueError("sample_weight requires in-memory event "
                                 "data (a file source carries no weights)")
            n_events, n_dims = source.shape
        else:
            data = np.ascontiguousarray(data)
            n_events, n_dims = data.shape
        if sample_weight is not None:
            sample_weight = _check_sample_weight(sample_weight, n_events,
                                                 num_clusters)
        start, stop, num_chunks = _host_bounds(n_events, config.chunk_size,
                                               model)
        local = np.ascontiguousarray(
            source.read_range(start, stop) if source is not None
            else data[start:stop])
    dtype = np.dtype(config.dtype)
    world = distributed.world_size()
    # Before any arithmetic touches the data: reject rows non-finite now or
    # after the cast to the compute dtype (every rank alike; the ranks of a
    # mesh row share a slice, which its first rank checks).
    if config.validate_input:
        validate_finite(local if mesh is None or mesh.cluster_index == 0
                        else local[:0], start, dtype=dtype,
                        collective=world > 1)
    with phase("mpi"):
        mean64, var64 = distributed.global_moments(
            local, config.chunk_size, num_chunks,
            index=mesh.data_index if mesh is not None else 0,
            count=mesh.data_size if mesh is not None else 1,
            group=mesh.data_group if mesh is not None else None)
    with phase("cpu"):
        # Global centering keeps the expanded quadratic form
        # well-conditioned (shift-equivariant: EM on x-c equals EM on x,
        # means shifted by c).
        shift = (mean64.astype(dtype) if config.center_data
                 else np.zeros((n_dims,), dtype))
        local = local.astype(dtype, copy=False)
        if config.center_data:
            local = local - shift[None, :]
        chunks_np, wts_np = chunk_events(
            local, config.chunk_size, num_chunks=num_chunks,
            sample_weight=(None if sample_weight is None
                           else sample_weight[start:stop].astype(dtype)))
        if world > 1 and mesh is not None:
            distributed.require_host_local_chunks(chunks_np.shape)
    with phase("memcpy"):
        chunks, wts = model.place(chunks_np), model.place(wts_np)
    return (data if source is None else source, chunks, wts, n_events,
            n_dims, shift, float(var64.mean()))


def _prepare_pipelined(source, config: GMMConfig, model, mesh, phase,
                       ingest: dict):
    """:func:`_prepare_data` under ``ingest='pipelined'``: the moments and
    the input check from one pass of range reads, then the block source
    (the JAX package's out-of-core prologue, order_search.py:1347-1398)."""
    from ..io.pipeline import PipelinedBlockSource, streamed_moments
    from ..parallel import distributed

    dtype = np.dtype(config.dtype)
    with phase("cpu"):
        n_events, n_dims = source.shape
        start, stop, num_chunks = _host_bounds(n_events, config.chunk_size,
                                               model)
    with phase("mpi"):
        mean64, var64 = streamed_moments(
            source, start, stop, config.chunk_size, num_chunks,
            validate=config.validate_input,
            collective=distributed.world_size() > 1, dtype=dtype,
            index=mesh.data_index if mesh is not None else 0,
            count=mesh.data_size if mesh is not None else 1,
            group=mesh.data_group if mesh is not None else None)
    with phase("cpu"):
        shift = (mean64.astype(dtype) if config.center_data
                 else np.zeros((n_dims,), dtype))
        prior = ingest.get("source")
        if (prior is not None and prior.source is source
                and not prior.closed
                and prior.chunk_size == config.chunk_size):
            # An elastic refit over the same file: the survivor's new rows.
            prior.reseek(start=start, stop=stop, num_chunks=num_chunks)
            lazy = prior
        else:
            if prior is not None:
                prior.close()
            lazy = ingest["source"] = PipelinedBlockSource(
                source, start=start, stop=stop,
                chunk_size=config.chunk_size, num_chunks=num_chunks,
                shift=shift if config.center_data else None, dtype=dtype,
                queue_depth=config.ingest_queue_depth)
    lazy.emit_start(telemetry.current(), em_mode=config.em_mode)
    return (source, lazy, None, n_events, n_dims, shift,
            float(var64.mean()))


def _prepare_fit(data: np.ndarray, num_clusters: int, config: GMMConfig,
                 model: GMMModel, prepared=None, init_means=None,
                 sample_weight=None, phase=_null_phase, ingest=None):
    """Prepare the data (unless ``prepared``, a :func:`_prepare_data`
    result, is given) and seed. Returns (state, chunks, wts, n_events,
    n_dims, shift)."""
    if prepared is None:
        prepared = _prepare_data(data, config, model, num_clusters,
                                 sample_weight, phase, ingest)
    data, chunks, wts, n_events, n_dims, shift, var_mean = prepared
    dtype = np.dtype(config.dtype)
    with phase("cpu"):
        # Seed rows in ORIGINAL coordinates, shifted into fit coordinates.
        rows = _seed_rows(data, num_clusters, n_events,
                          seed_method=config.seed_method, seed=config.seed,
                          init_means=init_means)
        state = seed_state_from_parts(
            np.asarray(rows, dtype) - shift[None, :], n_events, var_mean,
            num_clusters,
            covariance_dynamic_range=config.covariance_dynamic_range,
            dtype=dtype, device=model.device)
        # Deterministic singular-covariance injection (testing.faults),
        # before mesh placement as in the JAX package.
        state = faults.maybe_poison_state(state)
    if _sharded(model):
        with phase("memcpy"):
            state = model.prepare_state(state)
    return state, chunks, wts, n_events, n_dims, shift


def _sharded(model) -> bool:
    return model.mesh is not None


def default_model(config: GMMConfig):
    """The model ``fit_gmm`` builds: ``models.StreamingGMMModel`` under
    ``stream_events`` (one rank of a data mesh on a mesh),
    ``parallel.ShardedGMMModel`` when ``mesh_shape`` is set or the
    torch.distributed world has more than one rank, else
    :class:`GMMModel`."""
    from ..parallel import ShardedGMMModel, distributed

    if config.stream_events:
        from .streaming import StreamingGMMModel

        return StreamingGMMModel(config)
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
    :class:`~cuda_gmm_mpi_tpu_torch.supervisor.RunSupervisor`. With
    ``config.metrics_port`` the live plane runs for the fit and the trace
    spans light up; an active recorder brings the compile watch.
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
        if config.metrics_port is not None:
            if not tl_spans.active():
                # The live plane and a fit-scoped trace, whose id rides
                # every record. A sequential restart's sub-fit finds the
                # outer fit's trace active and shares its plane (a second
                # endpoint would fight for a fixed port).
                from ..parallel import elastic

                stack.enter_context(tl_exporter.live_plane(
                    config.metrics_port,
                    registry_provider=lambda: telemetry.current().metrics,
                    gauges_provider=elastic.live_gauges,
                    device=config.device))
                rec = telemetry.current()
                tid = stack.enter_context(tl_spans.trace())
                if rec.active:
                    rec.set_context(trace_id=tid)
                    stack.callback(rec.set_context, trace_id=None)
            stack.enter_context(tl_spans.span("fit"))
        if telemetry.current().active and tl_profiling.active() is None:
            # The compile watch rides every active-recorder fit: kernel
            # builds and graph captures as ``compile`` events, the memory
            # watermarks, and ``run_summary.profile``.
            stack.enter_context(tl_profiling.watch(device=config.device))
        if config.autotune != "off":
            # Profile-guided knob resolution (tuning/): once per fit, under
            # the ambient recorder, so the per-knob `tune` events ride this
            # stream. The resolved config comes back with autotune='off':
            # restart and elastic re-entries ride the decisions instead of
            # resolving (and emitting) again per sub-fit.
            from ..tuning import resolve_fit_config

            config = resolve_fit_config(config, data, num_clusters,
                                        log=get_logger(config))
        result = None
        # The pipelined block source this fit makes (io/pipeline.py), kept
        # across an elastic refit and closed on every way out.
        ingest: dict = {}
        try:
            # The elastic retry loop (the JAX package's, order_search.py:
            # 538-560): under ``elastic`` a peer loss shrinks the world
            # over the survivors and refits from the newest checkpoint
            # (resume='auto') instead of propagating to exit 75. A restart
            # sub-fit (``_prepared``) leaves that to its outer fit.
            recovery = None
            while True:
                try:
                    result = _fit_gmm(data, num_clusters,
                                      target_num_clusters, config, model,
                                      verbose, init_means, sample_weight,
                                      _prepared, ingest)
                    return result
                except supervisor.PreemptedError:
                    raise
                except RuntimeError as e:
                    lost = (e if isinstance(e, supervisor.PeerLostError)
                            else supervisor.current().peer_loss_from(e))
                    if lost is None:
                        raise
                    if recovery is None and _prepared is None:
                        recovery = supervisor.ElasticRecovery.maybe(config)
                    if recovery is None:
                        if lost is e:
                            raise
                        raise lost from e
                    config = recovery.recover(lost, config)
                    if recovery.rebuilt and model is not None:
                        # The process group changed: the refit builds its
                        # model (and mesh) over the survivors.
                        if hasattr(model, "release_programs"):
                            model.release_programs()
                        model = None
        finally:
            if ingest.get("source") is not None:
                ingest["source"].close()  # joins the worker; ingest_summary
            # The EM programs read this fit's events in place: free them
            # (and their graphs' memory) with the fit, not with the model.
            built = getattr(result, "model", None)
            for m in (model, None if built is model else built):
                if hasattr(m, "release_programs"):
                    m.release_programs()


def _start_watchdog(config, sup) -> None:
    """The liveness watchdog of a mesh of more than one rank (the JAX
    package's, order_search.py:676-689): with an active supervisor, a
    checkpoint directory and ``peer_timeout_s``, every rank heartbeats
    into ``<checkpoint_dir>/heartbeats`` and watches its peers (an elastic
    refit watches only the sealed membership's survivors)."""
    from ..parallel import elastic

    nproc = elastic.world()[1]
    if (sup.active and config.checkpoint_dir and nproc > 1
            and config.peer_timeout_s > 0):
        sup.start_watchdog(
            os.path.join(os.path.abspath(config.checkpoint_dir),
                         "heartbeats"),
            rank=elastic.original_rank(), nproc=nproc,
            timeout_s=config.peer_timeout_s, peers=elastic.peer_ranks())


def _fit_gmm(data, num_clusters, target_num_clusters, config, model,
             verbose, init_means, sample_weight, _prepared,
             ingest=None) -> GMMResult:
    """fit_gmm's body, under whatever ambient recorder and supervisor."""
    if not (1 <= num_clusters <= config.max_clusters):
        raise ValueError(f"num_clusters must be in [1, {config.max_clusters}],"
                         f" got {num_clusters}")
    if target_num_clusters > num_clusters:
        raise ValueError("target_num_clusters must be <= num_clusters")
    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    verbose = config.enable_print if verbose is None else verbose
    from ..parallel import elastic

    elastic.assert_world_coherent()
    model = model or default_model(config)
    if config.n_init > 1:
        return _fit_with_restarts(data, num_clusters, target_num_clusters,
                                  config, model, verbose, init_means,
                                  sample_weight, ingest)
    diag_only = config.diag_only
    log = get_logger(config)
    rec = telemetry.current()
    # An active recorder times the phases too (run_summary.phase_profile);
    # the table prints only under config.profile.
    timer = PhaseTimer() if (config.profile or rec.active) else None
    phase = timer.phase if timer else _null_phase

    state, chunks, wts, n_events, n_dims, shift = _prepare_fit(
        data, num_clusters, config, model, _prepared, init_means,
        sample_weight, phase, ingest)
    # After the preparation's collectives: the ranks start watching each
    # other together, not a start-up skew apart.
    _start_watchdog(config, supervisor.current())
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462

    sharded = _sharded(model)
    if rec.active:
        rec.set_context(path=("streaming" if config.stream_events
                              else "sharded" if sharded else "in-memory"),
                        mesh=list(model.mesh.shape) if sharded else None)
        _emit_run_start(rec, model, config, n_events, n_dims, num_clusters,
                        target_num_clusters, epsilon)

    ckpt = None
    if config.checkpoint_dir:
        from ..utils.checkpoint import SweepCheckpointer

        # Every rank builds it and calls it alike; rank 0 writes.
        ckpt = SweepCheckpointer(config.checkpoint_dir,
                                 keep=config.checkpoint_keep,
                                 retries=config.checkpoint_retries,
                                 allow_world_change=config.elastic)
    sup = supervisor.current()

    # The counters of a fused sweep that stopped on a fatal word (the
    # host-driven rerun below folds them into its summary).
    fused_fatal_counts = None
    if config.fused_sweep:
        # Checkpoints and the per-K seconds of the phase timer ride the
        # per-K emission; a model without the fused sweep runs the
        # host-driven sweep (the JAX package's blockers).
        want_emit = ckpt is not None or timer is not None
        blockers = []
        maker = getattr(model, "make_fused_sweep", None)
        if maker is None:
            blockers.append("model without fused-sweep support")
        elif want_emit and not getattr(model, "supports_fused_emit", False):
            blockers.append("per-K checkpoint emission on this model"
                            if ckpt is not None else
                            "per-K profile emission on this model")
        if blockers:
            log.warning(
                "fused_sweep disabled (%s requested); using the host-driven "
                "sweep", ", ".join(blockers))
        else:
            fused = maker(with_emit=want_emit, emit_light=ckpt is None,
                          start_k=num_clusters, stop_number=stop_number,
                          target_k=target_num_clusters, num_events=n_events,
                          num_dimensions=n_dims)
            with tl_spans.span("fused_sweep", start_k=int(num_clusters)):
                fused_result = _run_fused_sweep(
                    fused, config, state, chunks, wts, epsilon, num_clusters,
                    n_events, n_dims, shift, verbose, model, ckpt=ckpt,
                    log=log, want_emit=want_emit, timer=timer)
            if isinstance(fused_result, GMMResult):
                return fused_result
            # A counter vector: the fused sweep stopped on a fatal word
            # (recovery='retry'); the host-driven sweep's ladder takes over.
            fused_fatal_counts = np.asarray(fused_result, np.int64)
            log.warning(
                "fused sweep aborted on a fatal numerical fault; "
                "re-running via the host-driven sweep's recovery ladder")

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
            if restored is not None and "fused_log" in restored:
                log.warning("found a fused-sweep checkpoint; the host-driven "
                            "sweep cannot resume it -- starting fresh")
                restored = None
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
                # A streaming stop's position inside a pass (or a stepwise
                # EM step) and its partial accumulator.
                for key in ("stream_pass", "stream_block", "mb_step",
                            "mb_cursor"):
                    if key in restored:
                        resume_em[key] = int(restored[key])
                for key in ("stream_acc", "mb_acc"):
                    if key in restored:
                        resume_em[key] = restored[key]
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
    if fused_fatal_counts is not None:
        # The aborted fused sweep's fault and its host_fallback action.
        health_totals += fused_fatal_counts
        n_recoveries += 1
    # With a supervisor AND checkpoints the EM loop polls the stop flag
    # (and can write an emergency mid-EM sub-step).
    supervised = sup.active and ckpt is not None
    em_walls, em_widths = [], []
    n_rebuckets = 0
    # Non-lexical sweep span: the loop raises through _shutdown_and_raise
    # on a stop, and an un-ended span simply never emits.
    sweep_span = tl_spans.begin("sweep", start_k=int(k))
    sweep_wm = tl_profiling.wm_begin("sweep")
    while k >= stop_number:
        if sup.active and sup.poll_world(where="sweep", k=int(k)):
            # Between Ks every completed K is already durable.
            _shutdown_and_raise(sup, rec, log, ckpt,
                                step=step - 1 if step else None, k=int(k),
                                checkpointed=ckpt is not None and step > 0)
        t0 = time.perf_counter()
        last_k = k <= stop_number
        em_widths.append(int(state.num_clusters_padded))
        rollback = clone_state(state) if recovery_on else None
        # em_k = one K's EM (m_step/constants folded into e_step).
        with tl_spans.span("em_k", k=int(k)), \
                tl_profiling.watermark("em_k"), phase("e_step"):
            if supervised or resume_em is not None:
                # A streaming model also polls after every block.
                streaming = ({"block_stop": (
                    (lambda p, b, _k=int(k): sup.poll_block(
                        k=_k, em_iter=p, block=b)) if sup.active else None)}
                    if getattr(model, "streams", False) else {})
                state, ll, iters, _, stopped, extra = \
                    model.run_em_resumable(
                        state, chunks, wts, epsilon, n_events=n_events,
                        sweep=True, poll_iters=config.preempt_poll_iters,
                        should_stop=((lambda done, _k=int(k): sup.poll_world(
                            where="em", k=_k, em_iter=done))
                            if sup.active else None),
                        resume=resume_em, **streaming)
                resume_em = None
                if stopped:
                    payload = None
                    if sup.lost_peer is None or not (
                            sharded and model.mesh.cluster_group is not None):
                        # (A mesh row's clusters cannot be gathered once a
                        # peer is lost: the completed Ks stay durable.)
                        payload = checkpoint_payload(state)
                        if not math.isfinite(best_ll):
                            # No K has completed: the mid-EM state stands
                            # in (the resumed first K always takes the best
                            # slot anyway).
                            payload["best_state"] = payload["state"]
                        payload.update(extra)
                    _shutdown_and_raise(sup, rec, log, ckpt, step=step,
                                        k=int(k), em_iter=int(iters),
                                        payload=payload)
                if resume_sub_step is not None and ckpt is not None:
                    # The interrupted K completed: its sub-step is
                    # superseded.
                    ckpt.discard_substeps(resume_sub_step)
                    resume_sub_step = None
            else:
                state, ll, iters = model.run_em(state, chunks, wts, epsilon,
                                                n_events=n_events, sweep=True)
            counts = model.last_health
            lls = model.last_lls
            dt = time.perf_counter() - t0  # EM only: run_em ends on a read
        if health.word_is_fatal(health.pack_word(counts)):
            # The observed fault is recorded before recovery replaces the
            # counters with the retried run's.
            health_totals += counts
            _emit_health(rec, k, counts)
            with tl_spans.span("recovery", k=int(k)):
                model, state, ll, iters, counts, lls = health.recover_em(
                    model, config, rollback, chunks, wts, epsilon, k,
                    n_events=n_events, rec=rec, log=log,
                    faulty_counts=counts)
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
        if timer:
            timer.counts["e_step"] += int(iters) - 1  # per-iter averages
        sweep_log.append((k, ll, riss, iters, dt))
        em_walls.append(dt)
        if verbose:
            print(f"K={k}: loglik={ll:.6e} {config.criterion}={riss:.6e} "
                  f"iters={iters} ({dt:.2f}s)")
        if config.enable_debug:
            metrics_line("em_done", k=int(k), loglik=float(ll),
                         score=float(riss), criterion=config.criterion,
                         iters=int(iters), seconds=round(dt, 4))
        if rec.active:
            rec.metrics.count("em_iters", int(iters))
            rec.metrics.gauge("active_k", int(k))
            rec.metrics.series("active_k", int(k))
            _emit_em_iters(rec, k, lls, iters, dt, epsilon, model)
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
        with phase("reduce"):
            next_state, k, min_d, pair = eliminate_and_reduce(
                state, diag_only=diag_only)
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
        width = (bucket_width(k, cur_w, multiple=model.bucket_multiple)
                 if config.sweep_k_buckets == "pow2" else cur_w)
        with (phase("memcpy") if width < cur_w
              else contextlib.nullcontext()):
            if sharded:
                state = model.rebucket_state(state, width)
            elif width < cur_w:
                state = compact_to(state, width)
        if width < cur_w:
            n_rebuckets += 1
            if rec.active:
                rec.metrics.count("rebuckets")
                rec.emit("rebucket", k_active=int(k), from_width=int(cur_w),
                         to_width=int(state.num_clusters_padded))
        if ckpt is not None:
            if rec.active:
                rec.metrics.count("checkpoint_saves")
            with tl_spans.span("checkpoint", step=int(step)), phase("cpu"):
                ckpt.save(step, checkpoint_payload(state))
        step += 1

    tl_spans.end(sweep_span)
    tl_profiling.wm_end(sweep_wm)
    with phase("memcpy"):
        compact_state, n_active = compact(best_state)
    if verbose:
        # Exact reference wording for the default criterion (gaussian.cu:962).
        print(f"Final {config.criterion} score was: {min_rissanen}, "
              f"with {ideal_k} clusters.")
    health_section = health.health_summary(
        health_totals, recoveries=n_recoveries,
        io_retries=ckpt.io_retries if ckpt is not None else 0)
    # A pipelined source is a stream of blocks, not an array: no envelope
    # (the JAX package skips it too).
    envelope = (compute_envelope(model, compact_state, chunks, n_events,
                                 n_active)
                if config.envelope and not hasattr(chunks, "get_block")
                else None)
    _emit_run_summary(
        rec, model, config, timer, sweep_log, n_active, float(min_rissanen),
        float(best_ll), em_walls,
        buckets=dict(mode=config.sweep_k_buckets,
                     em_widths=sorted(set(em_widths), reverse=True),
                     em_compiles=len(set(em_widths)),
                     rebuckets=n_rebuckets),
        health_section=health_section, envelope=envelope)
    return GMMResult(
        state=compact_state.to("cpu"), ideal_num_clusters=n_active,
        min_rissanen=float(min_rissanen), final_loglik=float(best_ll),
        epsilon=epsilon, num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=sweep_log, merges=merges,
        model=model, health=health_section,
        host_range=_host_bounds(n_events, config.chunk_size, model)[:2],
        profile=timer.as_dict() if timer else None,
        profile_report=timer.report() if timer else None,
        envelope=envelope)


def _run_fused_sweep(fused, config, state, chunks, wts, epsilon,
                     num_clusters, n_events, n_dims, shift, verbose, model,
                     ckpt=None, log=None, want_emit=False, timer=None):
    """The fused sweep (models/fused_sweep.py) under the sweep's
    checkpoints, supervisor and recorder: the JAX package's
    ``_run_fused_sweep``. Returns the ``GMMResult``, or the sweep's health
    counters when it stopped on a fatal word under ``recovery='retry'``
    (the caller reruns the host-driven sweep).

    With ``ckpt`` a fused-sweep checkpoint (one that carries ``fused_log``;
    4-column logs are padded to 5) resumes mid-sweep, and every completed
    K is saved as ``<step>.npz`` from the per-K emission; a stop requested
    of the run supervisor takes effect there, after that K's checkpoint
    (exit 75 in the CLI). With emission on (``want_emit``: checkpoints or
    a phase ``timer``) each K's seconds are real (emission arrivals);
    without, they are the sweep's wall over its Ks. The sweep log is
    rebuilt from the device log; the stream carries ``em_done`` per K and
    no ``em_iter`` records (the EM iterations never reach the host). The
    ``timer`` gets each K's whole span as e_step, as in the JAX
    package. On a mesh every rank runs this alike: the stop is agreed over
    the world at each emission (``poll_world``), rank 0 writes the
    checkpoints, and the best state is gathered before it is compacted."""
    rec = telemetry.current()
    resume = None
    if ckpt is not None and config.resume != "never":
        restored = ckpt.restore()
        if restored is not None and _resume_mismatch(restored, config, log):
            restored = None
        if (restored is not None
                and int(restored.get("num_clusters", -1)) == num_clusters):
            if "fused_log" not in restored:
                log.warning("found a host-sweep checkpoint; the fused sweep "
                            "cannot resume it -- starting fresh")
            else:
                state = _place_state(restored["state"], model)
                fused_log = np.asarray(restored["fused_log"])
                if fused_log.shape[1] == 4:
                    # A log without the per-K health word: restored Ks read
                    # as clean.
                    fused_log = np.concatenate(
                        [fused_log, np.zeros((fused_log.shape[0], 1),
                                             fused_log.dtype)], axis=1)
                resume = dict(best_state=_place_state(
                                  restored["best_state"], model),
                              k=int(restored["k"]),
                              step=int(restored["step"]) + 1,
                              best_ll=float(restored["best_ll"]),
                              best_riss=float(restored["best_riss"]),
                              log=fused_log,
                              merges=restored.get("fused_merges"))
                log.info("resumed fused sweep from checkpoint: next K=%d "
                         "(step %d)", resume["k"], resume["step"])
                if rec.active:
                    rec.metrics.count("resumes")
                if verbose:
                    print(f"resumed fused sweep at K={resume['k']}")

    emit_times = {}
    sup = supervisor.current()

    def emit(payload):
        step = int(payload["step"])
        emit_times[step] = time.perf_counter()
        if ckpt is None or payload["done"]:
            return  # a finished sweep returns its result right after
        if rec.active:
            rec.metrics.count("checkpoint_saves")
        ckpt.save_local(step, {
            "state": payload["state"],
            "best_state": payload["best_state"],
            "k": int(payload["next_k"]),
            "best_ll": float(payload["best_ll"]),
            "best_riss": float(payload["best_riss"]),
            "fused_log": np.asarray(payload["log"]),
            "fused_merges": np.asarray(payload["merges"]),
            "num_clusters": int(num_clusters),
            "criterion_code": _CRITERION_CODE[config.criterion],
            "cov_code": _COV_CODE[config.covariance_type],
            "data_shift": np.asarray(shift, np.float64),
        })
        # The fused sweep's only intervention point: this K is durable. On
        # a mesh the ranks agree on the stop here, so all of them stop
        # after this same K.
        if sup.active and sup.poll_world(where="fused_emit",
                                         k=int(payload["next_k"])):
            raise supervisor.PreemptedError(
                "fused sweep stopped at per-K emission",
                reason=sup.stop_reason or "unknown", step=step,
                checkpointed=True)

    t0 = time.perf_counter()
    try:
        out = fused(state, chunks, wts, epsilon, config.min_iters,
                    config.max_iters, resume,
                    emit_cb=emit if want_emit else None)
    except supervisor.PreemptedError:
        if rec.active:
            rec.emit("shutdown", reason=sup.stop_reason or "unknown",
                     checkpointed=bool(ckpt is not None and emit_times))
        sup.raise_stop(step=max(emit_times) if emit_times else None,
                       checkpointed=bool(ckpt is not None and emit_times))
        raise
    best_state, best_ll, best_riss, log_t, steps, counts, merge_t = out
    if _sharded(model):  # the mesh row's clusters, on every rank
        best_state = model.gather_state(best_state)
    best_state = best_state.to("cpu")
    rows = log_t.cpu().numpy()
    steps = int(steps)
    best_ll, best_riss = float(best_ll), float(best_riss)
    health_counts = counts.cpu().numpy().astype(np.int64)
    wall = time.perf_counter() - t0

    word = health.pack_word(health_counts)
    if health.word_is_fatal(word):
        k_fatal = int(rows[steps - 1][0]) if steps else int(num_clusters)
        if rec.active:
            rec.emit("health", k=k_fatal, where="fused_sweep",
                     flags=int(word), flag_names=health.flag_names(word),
                     counters=health.counts_dict(health_counts))
            rec.metrics.count("health_events")
        if config.recovery != "retry":
            raise health.NumericalFaultError(
                f"numerical fault in the fused sweep at K={k_fatal} "
                f"(flags={health.flag_names(word)}) and recovery is "
                f"{config.recovery!r}",
                health.fault_bundle(health_counts, k=k_fatal,
                                    where="fused_sweep", config=config))
        if rec.active:
            rec.emit("recovery", k=k_fatal, attempt=1,
                     action="host_fallback", outcome="rerun",
                     flags=int(word), flag_names=health.flag_names(word))
            rec.metrics.count("recovery_attempts")
        log.warning("fused sweep hit %s at K=%d", health.flag_names(word),
                    k_fatal)
        return health_counts
    per_k = wall / max(steps, 1)
    # Each emitted step's seconds: from the previous arrival (the first
    # from the sweep's start); restored steps keep the amortized per_k.
    step_secs, prev = {}, t0
    for st in sorted(emit_times):
        step_secs[st] = emit_times[st] - prev
        prev = emit_times[st]
    sweep_log = [(int(r[0]), float(r[1]), float(r[2]), int(r[3]),
                  step_secs.get(i, per_k))
                 for i, r in enumerate(rows[:steps])]
    merges = [(int(m[0]), (int(m[1]), int(m[2])), float(m[3]))
              for m in merge_t.cpu().numpy()[:steps] if not np.isnan(m[0])]
    if verbose:
        for k_, ll_, riss_, it_, _ in sweep_log:
            print(f"K={k_}: loglik={ll_:.6e} {config.criterion}={riss_:.6e} "
                  f"iters={it_} (fused)")
    compact_state, n_active = compact(best_state)
    if verbose:
        print(f"Final rissanen score was: {best_riss}, "
              f"with {n_active} clusters.")  # gaussian.cu:962
    profile = profile_report = None
    if timer is not None:
        # Each K's whole span (EM + its order reduction) lands in e_step:
        # the finer split needs host-observed phase boundaries, which one
        # device program does not have.
        for i, dt in sorted(step_secs.items()):
            timer.add("e_step", dt, count=int(rows[i][3]))
        profile = timer.as_dict()
        profile_report = (timer.report() + "\n  (fused sweep: whole-K "
                          "spans attributed to e_step)")
    health_section = health.health_summary(
        health_counts, io_retries=ckpt.io_retries if ckpt is not None else 0)
    envelope = (compute_envelope(model, compact_state, chunks, n_events,
                                 n_active) if config.envelope else None)
    if rec.active:
        for (k_, ll_, riss_, it_, secs_), r in zip(sweep_log, rows[:steps]):
            rec.metrics.count("em_iters", int(it_))
            rec.metrics.series("active_k", int(k_))
            rec.emit("em_done", k=int(k_), loglik=float(ll_),
                     score=float(riss_), criterion=config.criterion,
                     iters=int(it_), seconds=round(float(secs_), 6))
            word_k = int(r[4])
            if word_k:
                rec.emit("health", k=int(k_), where="em", flags=word_k,
                         flag_names=health.flag_names(word_k))
                rec.metrics.count("health_events")
        _emit_run_summary(
            rec, model, config, timer, sweep_log, n_active, best_riss,
            best_ll, [v for _, v in sorted(step_secs.items())],
            health_section=health_section, envelope=envelope)
    return GMMResult(
        state=compact_state, ideal_num_clusters=n_active,
        min_rissanen=best_riss, final_loglik=best_ll, epsilon=epsilon,
        num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=sweep_log, merges=merges,
        model=model, health=health_section, profile=profile,
        profile_report=profile_report, envelope=envelope,
        host_range=_host_bounds(n_events, config.chunk_size, model)[:2])


def _fit_with_restarts(data, num_clusters: int, target_num_clusters: int,
                       config: GMMConfig, model: GMMModel,
                       verbose: bool, init_means=None,
                       sample_weight=None, ingest=None) -> GMMResult:
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
    prepared = _prepare_data(data, config, model, num_clusters, sample_weight,
                             ingest=ingest)
    _start_watchdog(config, supervisor.current())
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
