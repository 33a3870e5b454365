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

Telemetry, checkpointing, supervision, recovery, the fused sweep and
streaming are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Optional

import numpy as np

from ..config import GMMConfig
from ..ops.formulas import convergence_epsilon, model_score
from ..ops.merge import eliminate_and_reduce
from ..ops.seeding import (
    kmeanspp_from_pool, kmeanspp_pool, seed_means_indices,
    seed_state_from_parts,
)
from ..parallel.mesh import shard_chunks
from ..state import GMMState, bucket_width, compact, compact_to
from ..validation import InvalidInputError, validate_finite
from .gmm import GMMModel, chunk_events


@dataclasses.dataclass
class GMMResult:
    """The best (lowest-score) configuration across the sweep.

    ``state`` is compacted (inactive slots dropped) and lives on the CPU;
    ``means`` are in the original data coordinates (the centering shift is
    undone). ``sweep_log`` holds one (num_clusters, loglik, score, em_iters,
    seconds) row per K; ``merges`` one (k_active, (c1, c2), distance) row
    per merge, with c1 < c2 the pair's positions in the compacted order.
    ``init_index`` is the restart that won an ``n_init > 1`` fit (None for
    a single init). ``timings`` holds the host-clock seconds of the batched
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
    """
    if not (1 <= num_clusters <= config.max_clusters):
        raise ValueError(f"num_clusters must be in [1, {config.max_clusters}],"
                         f" got {num_clusters}")
    if target_num_clusters > num_clusters:
        raise ValueError("target_num_clusters must be <= num_clusters")
    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    verbose = config.enable_print if verbose is None else verbose
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

    state, chunks, wts, n_events, n_dims, shift = _prepare_fit(
        data, num_clusters, config, model, _prepared, init_means,
        sample_weight)
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462

    sharded = _sharded(model)
    sweep_log, merges = [], []
    min_rissanen = math.inf
    ideal_k, best_state, best_ll = num_clusters, state, -math.inf
    k = num_clusters
    while k >= stop_number:
        t0 = time.perf_counter()
        last_k = k <= stop_number
        state, ll, iters = model.run_em(state, chunks, wts, epsilon,
                                        n_events=n_events)
        dt = time.perf_counter() - t0  # EM only: run_em ends on a host read
        if sharded:  # the mesh row's clusters, on every rank of the row
            state = model.gather_state(state)
        riss = model_score(ll, k, n_events, n_dims,
                           criterion=config.criterion,
                           covariance_type=config.covariance_type)
        score_ok = math.isfinite(riss)
        sweep_log.append((k, ll, riss, iters, dt))
        if verbose:
            print(f"K={k}: loglik={ll:.6e} {config.criterion}={riss:.6e} "
                  f"iters={iters} ({dt:.2f}s)")
        # gaussian.cu:839; a NaN score compares false both ways and must
        # never capture the best-model slot.
        if score_ok and (k == num_clusters
                         or (riss < min_rissanen and target_num_clusters == 0)
                         or k == target_num_clusters):
            min_rissanen, ideal_k = riss, k
            best_state, best_ll = state, ll
        if last_k:
            break
        # Order reduction (gaussian.cu:857-952).
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
        merges.append((k, pair, min_d))
        state = next_state
        k -= 1
        width = bucket_width(k, state.num_clusters_padded,
                             multiple=model.bucket_multiple)
        if sharded:
            state = model.rebucket_state(state, width)
        elif width < state.num_clusters_padded:
            state = compact_to(state, width)

    compact_state, n_active = compact(best_state)
    if verbose:
        # Exact reference wording for the default criterion (gaussian.cu:962).
        print(f"Final {config.criterion} score was: {min_rissanen}, "
              f"with {ideal_k} clusters.")
    return GMMResult(
        state=compact_state.to("cpu"), ideal_num_clusters=n_active,
        min_rissanen=float(min_rissanen), final_loglik=float(best_ll),
        epsilon=epsilon, num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=sweep_log, merges=merges,
        model=model)


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
    for i in range(config.n_init):
        sub = dataclasses.replace(
            config, n_init=1,
            seed_method=config.seed_method if i == 0 else "kmeans++",
            seed=config.seed + i)
        r = fit_gmm(data, num_clusters, target_num_clusters, config=sub,
                    model=model, verbose=verbose,
                    init_means=init_means if i == 0 else None,
                    _prepared=prepared)
        if verbose:
            print(f"init {i}: {config.criterion}={r.min_rissanen:.6e} "
                  f"K={r.ideal_num_clusters}")
        if (best is None or math.isnan(best.min_rissanen)
                or r.min_rissanen < best.min_rissanen):
            best, best_i = r, i
    best.init_index = best_i
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
