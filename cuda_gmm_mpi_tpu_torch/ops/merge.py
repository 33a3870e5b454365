"""Cluster-merge machinery for the Rissanen/MDL model-order search.

The reference's host-side L5 layer: ``cluster_distance``
(``gaussian.cu:1203-1208``), ``add_clusters`` (``:1210-1253``), the
``copy_cluster`` compaction (``:1255-1263``) and the empty-cluster
elimination + exhaustive O(K^2) pair scan in main (``:865-907``). The pair
scan is a batched device computation (blocks of rows of merged covariances,
batched Cholesky log-dets) and compaction is a mask update.

Two forms of the order reduction: :func:`eliminate_and_reduce` reads the
pair, the distance and the active count to the host (the host-driven sweep
prints and logs them), and :func:`eliminate_and_reduce_device` returns them
as tensors and never reads the device (the fused sweep, and a CUDA graph
that captures it). Both give the same state bit for bit.

Merge formulas (add_clusters, gaussian.cu:1213-1252), for clusters i, j:
  wt1   = N_i / (N_i + N_j)
  mu_m  = wt1*mu_i + wt2*mu_j
  R_m   = wt1*(R_i + (mu_m-mu_i)(mu_m-mu_i)^T) + wt2*(R_j + (mu_m-mu_j)(mu_m-mu_j)^T)
  pi_m  = pi_i + pi_j          (not renormalized -- reference semantics)
  N_m   = N_i + N_j
  const_m = -D/2 ln(2 pi) - 1/2 ln|R_m|
  distance(i,j) = N_i*const_i + N_j*const_j - N_m*const_m   (:1207)
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import GMMState, lane, stack_states
from .constants import LOG_2PI, chol_inverse_logdet, chol_logdet


def eliminate_empty(state):
    """Mask off active clusters with N < 0.5 (gaussian.cu:865-874)."""
    return state.replace(active=state.active & (state.N >= 0.5))


def _merged_cov_rows(state, rows: torch.Tensor):
    """Merged covariance of each cluster in ``rows`` with every cluster j:
    [len(rows), K, D, D]."""
    N_i, N_j = state.N[rows][:, None], state.N[None, :]
    mu_i, mu_j = state.means[rows][:, None, :], state.means[None, :, :]
    denom = torch.clamp(N_i + N_j, min=1e-30)
    wt1 = (N_i / denom)[..., None]
    wt2 = 1.0 - wt1
    mu_m = wt1 * mu_i + wt2 * mu_j  # [b, K, D]
    d1 = mu_m - mu_i
    d2 = mu_m - mu_j
    R_i = state.R[rows][:, None]
    R_m = (wt1[..., None] * (R_i + d1[..., :, None] * d1[..., None, :])
           + wt2[..., None] * (state.R[None] + d2[..., :, None] * d2[..., None, :]))
    return R_m


def pairwise_merge_distances(state, diag_only: bool = False,
                             row_block: int = 32) -> torch.Tensor:
    """Full [K, K] merge-cost matrix; +inf on invalid pairs.

    Valid pairs are (i, j) with i < j in slot order and both active -- the
    enumeration order of the reference's compacted c1 < c2 scan
    (gaussian.cu:882-894), so first-minimum tie-breaking matches. Rows are
    processed ``row_block`` at a time, bounding the live intermediate to
    [row_block, K, D, D] merged covariances (never the full [K, K, D, D]).
    """
    K, D = state.means.shape
    j = torch.arange(K, device=state.N.device)
    out = []
    for r0 in range(0, K, row_block):
        rows = torch.arange(r0, min(r0 + row_block, K), device=state.N.device)
        R_m = _merged_cov_rows(state, rows)
        b = rows.numel()
        log_det, ok = chol_logdet(R_m.reshape(b * K, D, D), diag_only=diag_only)
        const_m = (-D * 0.5) * LOG_2PI - 0.5 * log_det.reshape(b, K)
        N_i = state.N[rows][:, None]
        N_m = N_i + state.N[None, :]
        dist = (N_i * state.constant[rows][:, None]
                + state.N[None, :] * state.constant[None, :]
                - N_m * const_m)
        valid = (ok.reshape(b, K) & state.active[None, :]
                 & state.active[rows][:, None] & (j[None, :] > rows[:, None]))
        out.append(torch.where(valid, dist, torch.full_like(dist, torch.inf)))
    return torch.cat(out, dim=0)


def argmin_pair(dist: torch.Tensor):
    """First (row-major) minimum of the [K, K] distance matrix -> (i, j)."""
    K = dist.shape[0]
    idx = int(torch.argmin(dist.flatten()))  # first occurrence on ties
    return idx // K, idx % K


def _merged_cluster(state, i, j, diag_only: bool):
    """The merge of clusters i and j (ints or 0-d index tensors), the
    reference's add_clusters (gaussian.cu:1213-1252): (N_m, pi_m, const_m,
    mu_m, R_m, Rinv_m), a non-PD merged covariance reset to the identity
    (its log-determinant then 0)."""
    D = state.means.shape[1]
    at = _at if isinstance(i, torch.Tensor) else lambda t, n: t[n]
    N_i, N_j = at(state.N, i), at(state.N, j)
    denom = torch.clamp(N_i + N_j, min=1e-30)
    wt1 = N_i / denom
    wt2 = 1.0 - wt1
    mu_i, mu_j = at(state.means, i), at(state.means, j)
    mu_m = wt1 * mu_i + wt2 * mu_j
    d1 = mu_m - mu_i
    d2 = mu_m - mu_j
    R_m = (wt1 * (at(state.R, i) + d1[:, None] * d1[None, :])
           + wt2 * (at(state.R, j) + d2[:, None] * d2[None, :]))
    Rinv_m, log_det, ok = chol_inverse_logdet(R_m[None], diag_only=diag_only)
    eye = torch.eye(D, dtype=state.R.dtype, device=state.R.device)
    ok = ok[0]
    R_m = torch.where(ok, R_m, eye)
    Rinv_m = torch.where(ok, Rinv_m[0], eye)
    const_m = (-D * 0.5) * LOG_2PI - 0.5 * torch.where(
        ok, log_det[0], torch.zeros_like(log_det[0]))
    return (N_i + N_j, at(state.pi, i) + at(state.pi, j), const_m, mu_m, R_m,
            Rinv_m)


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor, without reading it to the host
    (indexing with a tensor scalar would)."""
    return t.index_select(0, i.reshape(1))[0]


def merge_pair(state, i: int, j: int, diag_only: bool = False):
    """Merge cluster j into slot i and deactivate j.

    Equivalent to add_clusters + copy_cluster compaction (gaussian.cu:899-907):
    the merged cluster goes to slot i and slot j is masked, which preserves
    the compacted relative order. Rinv and the constant of the merged
    cluster are recomputed here (the next K's initial E-step consumes them).
    """
    N_m, pi_m, const_m, mu_m, R_m, Rinv_m = _merged_cluster(state, i, j,
                                                             diag_only)
    N, pi, constant = state.N.clone(), state.pi.clone(), state.constant.clone()
    means, R, Rinv = state.means.clone(), state.R.clone(), state.Rinv.clone()
    active = state.active.clone()
    N[i], N[j] = N_m, 0.0
    pi[i] = pi_m
    constant[i] = const_m
    means[i], R[i], Rinv[i] = mu_m, R_m, Rinv_m
    active[j] = False
    return state.replace(N=N, pi=pi, constant=constant, means=means, R=R,
                         Rinv=Rinv, active=active)


def reduce_order_step(state, diag_only: bool = False):
    """Pair scan + merge of the closest pair: (new_state, (i, j), min_d).

    If no valid pair exists (``min_d`` is +inf) the state is returned
    unchanged; callers check the distance before decrementing K. The caller
    eliminates empty clusters first (gaussian.cu:865-907).
    """
    dist = pairwise_merge_distances(state, diag_only=diag_only)
    i, j = argmin_pair(dist)
    min_d = float(dist[i, j])
    if min_d == float("inf"):
        return state, (i, j), min_d
    return merge_pair(state, i, j, diag_only=diag_only), (i, j), min_d


def eliminate_and_reduce(state, diag_only: bool = False):
    """Empty-elimination + pair scan + merge.

    Returns ``(new_state, k_active_after_elim, min_distance, pair)`` where
    ``pair`` holds compaction-stable indices: each slot index is remapped to
    its rank among the post-elimination active slots, i.e. the position the
    cluster holds in the compacted layout, matching the reference's
    compacted c1 < c2 scan coordinates (gaussian.cu:882-894).
    """
    state = eliminate_empty(state)
    k_active = state.num_active()
    new_state, (i, j), min_d = reduce_order_step(state, diag_only=diag_only)
    rank = torch.cumsum(state.active.to(torch.int64), 0) - 1
    pair = (int(rank[i]), int(rank[j]))
    return new_state, k_active, min_d, pair


def eliminate_and_reduce_device(state, diag_only: bool = False):
    """:func:`eliminate_and_reduce` without a host read: returns
    ``(new_state, k_active, min_d, pair)`` as tensors (int64 0-d, the
    distance 0-d, int64 [2]). The closest pair's slots are 0-d index
    tensors, the merge is written with ``torch.where`` over the slot axis,
    and where no valid pair exists (``min_d`` is +inf) the eliminated state
    comes back unchanged, as from the host form."""
    state = eliminate_empty(state)
    K = state.num_clusters_padded
    k_active = state.active.sum()
    dist = pairwise_merge_distances(state, diag_only=diag_only).flatten()
    idx = torch.argmin(dist)  # first occurrence on ties
    i, j = idx // K, idx % K
    min_d = _at(dist, idx)
    N_m, pi_m, const_m, mu_m, R_m, Rinv_m = _merged_cluster(
        state, i, j, diag_only)
    slot = torch.arange(K, device=state.N.device)
    at_i = (slot == i) & (min_d != torch.inf)
    at_j = (slot == j) & (min_d != torch.inf)
    new = GMMState(
        N=torch.where(at_j, torch.zeros_like(state.N),
                      torch.where(at_i, N_m, state.N)),
        pi=torch.where(at_i, pi_m, state.pi),
        constant=torch.where(at_i, const_m.to(state.constant.dtype),
                             state.constant),
        avgvar=state.avgvar,
        means=torch.where(at_i[:, None], mu_m, state.means),
        R=torch.where(at_i[:, None, None], R_m, state.R),
        Rinv=torch.where(at_i[:, None, None], Rinv_m, state.Rinv),
        active=state.active & ~at_j)
    rank = torch.cumsum(state.active.to(torch.int64), 0) - 1
    return new, k_active, min_d, torch.stack([_at(rank, i), _at(rank, j)])


def eliminate_and_reduce_batched(states, live=None, diag_only: bool = False):
    """:func:`eliminate_and_reduce` on each lane of a restart-batched state.

    Returns ``(new_states, k_active [R], min_distance [R], pairs)``: the
    lanes' merged states stacked again, numpy vectors of the lanes'
    post-elimination active counts and closest-pair distances, and the
    list of their compaction-stable pairs. Only the lanes where ``live``
    ([R] bool, None = all) is True are scanned; the others come back
    unchanged, with k_active 0, distance +inf and pair None. The caller
    keeps the lanes it does not merge (the JAX package's vmapped
    ``_elim_reduce_batched_jit``, models/restarts.py:201-206).
    """
    R = states.N.shape[0]
    outs = [eliminate_and_reduce(lane(states, r), diag_only=diag_only)
            if live is None or live[r] else (lane(states, r), 0, np.inf, None)
            for r in range(R)]
    new, k_active, min_d, pairs = zip(*outs)
    return (stack_states(new), np.asarray(k_active, np.int64),
            np.asarray(min_d, np.float64), list(pairs))
