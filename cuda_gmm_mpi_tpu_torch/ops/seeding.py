"""Initial GMM state from data: the reference's even seeding.

The net effect of the reference's device ``seed_clusters`` kernel
(``gaussian_kernel.cu:269-328``) followed by the host override that re-seeds
the means from the full dataset (``gaussian.cu:108-123``):

  means[c]  = data[floor(c * seed)], seed = (N_events-1)/(K-1)
  R         = identity                                   (:316-320)
  pi        = 1/K                                        (:323)
  N         = N_events / K                               (:324)
  avgvar    = mean_d(Var_d) / COVARIANCE_DYNAMIC_RANGE   (:325)
  constant  = -D/2 ln(2*pi)  (constants_kernel on R=I)

k-means++ seeding is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import GMMState
from .constants import compute_constants


def seed_means_indices(num_events: int, num_clusters: int) -> np.ndarray:
    """Evenly spaced event indices, matching gaussian.cu:110-120 float math:
    the reference multiplies in float32 and truncates (``(int)(c*seed)``)."""
    seed = (num_events - 1.0) / (num_clusters - 1.0) if num_clusters > 1 else 0.0
    idx = (np.arange(num_clusters, dtype=np.float32)
           * np.float32(seed)).astype(np.int64)
    return np.clip(idx, 0, num_events - 1)


def seed_state_from_parts(means_rows, n_events: int, data_var_mean: float,
                          num_clusters: int, covariance_dynamic_range=1e3,
                          dtype=None, device="cpu") -> GMMState:
    """Initial state from the K seed rows (already in fit coordinates) and
    the global per-dimension variance mean."""
    means_rows = np.ascontiguousarray(means_rows)
    dtype = np.dtype(dtype or means_rows.dtype)
    return _build_seed_state(
        torch.as_tensor(means_rows.astype(dtype), device=device), n_events,
        num_clusters, num_clusters,
        float(np.asarray(data_var_mean / covariance_dynamic_range, dtype)))


def seed_clusters(data: torch.Tensor, num_clusters: int,
                  num_clusters_padded: int | None = None,
                  covariance_dynamic_range: float = 1e3) -> GMMState:
    """Initial state from on-device data (padded to ``num_clusters_padded``;
    extra slots inactive). The variance mean uses E[x^2] - E[x]^2 per
    dimension (averageVariance, gaussian_kernel.cu:79-99)."""
    n_events = data.shape[0]
    mean = data.mean(dim=0)
    var = (data * data).mean(dim=0) - mean * mean
    avgvar = var.mean() / covariance_dynamic_range
    idx = torch.as_tensor(seed_means_indices(n_events, num_clusters),
                          device=data.device)
    return _build_seed_state(data.index_select(0, idx), n_events, num_clusters,
                             num_clusters_padded or num_clusters, avgvar)


def _build_seed_state(means_active, n_events, K, Kp, avgvar_val):
    D = means_active.shape[-1]
    dtype, device = means_active.dtype, means_active.device
    means = torch.zeros((Kp, D), dtype=dtype, device=device)
    means[:K] = means_active
    active = torch.arange(Kp, device=device) < K
    zero = torch.zeros(Kp, dtype=dtype, device=device)
    full = lambda v: torch.full((Kp,), v, dtype=dtype, device=device)
    avg = (avgvar_val.expand(Kp) if torch.is_tensor(avgvar_val)
           else full(avgvar_val))
    eye = torch.eye(D, dtype=dtype, device=device).expand(Kp, D, D)
    state = GMMState(
        N=torch.where(active, full(n_events / K), zero),
        pi=torch.where(active, full(1.0 / K), zero),
        constant=zero.clone(),
        avgvar=torch.where(active, avg, zero),
        means=means,
        R=eye.clone(),
        Rinv=eye.clone(),
        active=active,
    )
    # constants_kernel after seeding (gaussian.cu:404)
    return compute_constants(state)
