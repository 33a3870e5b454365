"""Model-order search: EM at each K, merge the closest pair, keep the best.

The reference's main loop (``gaussian.cu:479-952``) on one device, with the
data in memory and the sweep driven from the host:

- center the data on its float64 mean and seed the state (``_prepare_fit``);
- for each K, run EM; eliminate empty clusters; scan all pairs and merge the
  closest (ops/merge.py);
- keep the K with the best Rissanen score (gaussian.cu:832-854), skipping a
  non-finite score.

The sweep rebuckets the padded cluster width to the active count's power of
two whenever a merge crosses a bucket boundary (``state.compact_to``), as
the JAX package's default ``sweep_k_buckets='pow2'`` does: EM at k active
clusters pays products at width ~k instead of the starting K.

Telemetry, checkpointing, supervision, recovery, restarts, the fused sweep
and streaming are not ported yet.
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
from ..ops.seeding import seed_means_indices, seed_state_from_parts
from ..state import GMMState, bucket_width, compact, compact_to
from ..validation import validate_finite
from .gmm import GMMModel, chunk_events


@dataclasses.dataclass
class GMMResult:
    """The best (lowest-score) configuration across the sweep.

    ``state`` is compacted (inactive slots dropped) and lives on the CPU;
    ``means`` are in the original data coordinates (the centering shift is
    undone). ``sweep_log`` holds one (num_clusters, loglik, score, em_iters,
    seconds) row per K; ``merges`` one (k_active, (c1, c2), distance) row
    per merge, with c1 < c2 the pair's positions in the compacted order.
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

    @property
    def means(self) -> np.ndarray:
        return np.asarray(self.state.means) + self.data_shift[None, :]


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


def _prepare_fit(data: np.ndarray, num_clusters: int, config: GMMConfig,
                 model: GMMModel):
    """Validate, center, chunk, place and seed. Returns
    (state, chunks, wts, n_events, n_dims, shift)."""
    data = np.ascontiguousarray(data)
    n_events, n_dims = data.shape
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
    chunks_np, wts_np = chunk_events(local, config.chunk_size)
    chunks, wts = model.place(chunks_np), model.place(wts_np)
    # Seed rows in ORIGINAL coordinates: the reference's evenly spaced rows
    # in float32 index math (gaussian.cu:108-123).
    rows = data[seed_means_indices(n_events, num_clusters)]
    state = seed_state_from_parts(
        np.asarray(rows, dtype) - shift[None, :], n_events,
        float(var64.mean()), num_clusters,
        covariance_dynamic_range=config.covariance_dynamic_range,
        dtype=dtype, device=model.device)
    return state, chunks, wts, n_events, n_dims, shift


def fit_gmm(data: np.ndarray, num_clusters: int, target_num_clusters: int = 0,
            config: GMMConfig = GMMConfig(), model: Optional[GMMModel] = None,
            verbose: Optional[bool] = None) -> GMMResult:
    """Full GMM fit with model-order search -- the library entry point.

    Args mirror the reference CLI (gaussian.cu:1111-1178): ``num_clusters``
    is the starting K (1..max_clusters); ``target_num_clusters`` = 0 means
    search all the way down to 1 keeping the best Rissanen score, else stop
    at (and keep) that K. Runs on ``config.device`` ('cuda' by default).
    """
    if not (1 <= num_clusters <= config.max_clusters):
        raise ValueError(f"num_clusters must be in [1, {config.max_clusters}],"
                         f" got {num_clusters}")
    if target_num_clusters > num_clusters:
        raise ValueError("target_num_clusters must be <= num_clusters")
    stop_number = target_num_clusters if target_num_clusters > 0 else 1
    verbose = config.enable_print if verbose is None else verbose
    model = model or GMMModel(config)
    diag_only = config.diag_only

    state, chunks, wts, n_events, n_dims, shift = _prepare_fit(
        data, num_clusters, config, model)
    epsilon = convergence_epsilon(n_events, n_dims, config.epsilon_scale)
    if verbose:
        print(f"epsilon = {epsilon}")  # gaussian.cu:462

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
        riss = model_score(ll, k, n_events, n_dims)
        score_ok = math.isfinite(riss)
        sweep_log.append((k, ll, riss, iters, dt))
        if verbose:
            print(f"K={k}: loglik={ll:.6e} rissanen={riss:.6e} "
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
        width = bucket_width(k, state.num_clusters_padded)
        if width < state.num_clusters_padded:
            state = compact_to(state, width)

    compact_state, n_active = compact(best_state)
    if verbose:
        # Exact reference wording (gaussian.cu:962).
        print(f"Final rissanen score was: {min_rissanen}, "
              f"with {ideal_k} clusters.")
    return GMMResult(
        state=compact_state.to("cpu"), ideal_num_clusters=n_active,
        min_rissanen=float(min_rissanen), final_loglik=float(best_ll),
        epsilon=epsilon, num_events=n_events, num_dimensions=n_dims,
        data_shift=np.asarray(shift), sweep_log=sweep_log, merges=merges,
        model=model)


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
