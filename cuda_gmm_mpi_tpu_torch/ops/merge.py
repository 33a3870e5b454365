"""Cluster-merge machinery for the Rissanen/MDL model-order search.

The reference's host-side L5 layer: ``cluster_distance``
(``gaussian.cu:1203-1208``), ``add_clusters`` (``:1210-1253``), the
``copy_cluster`` compaction (``:1255-1263``) and the empty-cluster
elimination + exhaustive O(K^2) pair scan in main (``:865-907``). The pair
scan is a batched device computation (blocks of rows of merged covariances,
batched Cholesky log-dets) and compaction is a mask update.

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

import torch

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


def merge_pair(state, i: int, j: int, diag_only: bool = False):
    """Merge cluster j into slot i and deactivate j.

    Equivalent to add_clusters + copy_cluster compaction (gaussian.cu:899-907):
    the merged cluster goes to slot i and slot j is masked, which preserves
    the compacted relative order. Rinv and the constant of the merged
    cluster are recomputed here (the next K's initial E-step consumes them).
    """
    K, D = state.means.shape
    N_i, N_j = state.N[i], state.N[j]
    denom = torch.clamp(N_i + N_j, min=1e-30)
    wt1 = N_i / denom
    wt2 = 1.0 - wt1
    mu_m = wt1 * state.means[i] + wt2 * state.means[j]
    d1 = mu_m - state.means[i]
    d2 = mu_m - state.means[j]
    R_m = (wt1 * (state.R[i] + d1[:, None] * d1[None, :])
           + wt2 * (state.R[j] + d2[:, None] * d2[None, :]))
    Rinv_m, log_det, ok = chol_inverse_logdet(R_m[None], diag_only=diag_only)
    eye = torch.eye(D, dtype=state.R.dtype, device=state.R.device)
    ok = bool(ok[0])
    R_m = R_m if ok else eye
    Rinv_m = Rinv_m[0] if ok else eye
    const_m = (-D * 0.5) * LOG_2PI - 0.5 * (log_det[0] if ok else 0.0)

    N, pi, constant = state.N.clone(), state.pi.clone(), state.constant.clone()
    means, R, Rinv = state.means.clone(), state.R.clone(), state.Rinv.clone()
    active = state.active.clone()
    N[i], N[j] = N_i + N_j, 0.0
    pi[i] = state.pi[i] + state.pi[j]
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
