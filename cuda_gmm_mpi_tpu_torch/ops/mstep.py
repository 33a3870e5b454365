"""M-step: sufficient-statistic accumulation and parameter update.

The torch-ops backend of the reference's ``mstep_N`` (``gaussian_kernel.cu:
551-577``), ``mstep_means`` (``:522-545``) and ``mstep_covariance1``
(``:605-677``). One pass per event chunk produces all statistics at once:

  Nk  = sum_n w[n,k]                       (mstep_N)
  M1  = sum_n w[n,k] x[n]                  (mstep_means; division deferred)
  M2  = sum_n w[n,k] x[n] x[n]^T           (mstep_covariance1's sums, with the
        centering folded out: sum w (x-mu')(x-mu')^T = M2 - Nk mu' mu'^T)

``apply_mstep`` reproduces the reference's host-side division and guards:
  means = M1/Nk if Nk > 0.5 else 0                       (gaussian.cu:614-618)
  cov_sums zeroed when Nk < 1                            (gaussian_kernel.cu:658-668)
  R     = (cov_sum + avgvar*I) / Nk if Nk > 0.5 else I   (gaussian.cu:663-679)
and the two families the reference lacks, as the JAX package updates them:
'spherical' (the diag update, each cluster's variances replaced by their
mean) and 'tied' (one covariance pooled over the clusters).

This path is the parity baseline for the kernels K1/K2 and their yardstick
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .constants import compute_constants
from .estep import expand_features, features, kdot, posteriors, unpack_sym


@dataclasses.dataclass(frozen=True)
class SuffStats:
    """EM sufficient statistics.

    loglik: 0-d sum of per-event log-evidence
    Nk:     [K]     soft counts
    M1:     [K, D]  weighted event sums
    M2:     [K, D, D] weighted outer-product sums ([K, D] under diag_only)
    sanitized: the E-step rows whose log-sum-exp max was non-finite and
            was sanitized (health.SANITIZED_LANES), shaped and typed like
            ``loglik`` so it rides every sum and all_reduce of the
            statistics. Left out, it is a structural zero: the kernel
            routes (K1, K3, K5/K6) return that, as the TPU kernels do
            (fused_stats.py:413-416, 636-637, 813-814 of the JAX package).
    """

    loglik: torch.Tensor
    Nk: torch.Tensor
    M1: torch.Tensor
    M2: torch.Tensor
    sanitized: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.sanitized is None:
            object.__setattr__(self, "sanitized",
                               torch.zeros_like(self.loglik))

    def __add__(self, other: "SuffStats") -> "SuffStats":
        return SuffStats(self.loglik + other.loglik, self.Nk + other.Nk,
                         self.M1 + other.M1, self.M2 + other.M2,
                         self.sanitized + other.sanitized)


def zeros_stats(K: int, D: int, dtype, device, diag_only: bool = False):
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return SuffStats(loglik=z(), Nk=z(K), M1=z(K, D),
                     M2=z(K, D) if diag_only else z(K, D, D))


def chunk_stats(state, x: torch.Tensor, wts: Optional[torch.Tensor] = None,
                *, diag_only: bool = False, quad_mode: str = "expanded",
                matmul_precision: str = "highest", cluster_group=None,
                xouter: Optional[torch.Tensor] = None) -> SuffStats:
    """Fused E+M statistics for one chunk of events.

    ``wts`` is a [B] row of nonnegative per-event weights (0 on padding).
    ``xouter`` optionally supplies the chunk's features of ``quad_mode``
    (the EM loop's ``precompute_features`` hoist). With ``cluster_group``
    the statistics are this rank's cluster shard's and the loglik is the
    same on every rank of the group. M1/M2 go through ``kdot`` at
    ``matmul_precision``; Nk is a plain sum, as in the JAX package."""
    K, D = state.means.shape
    prec = matmul_precision
    if xouter is None and not diag_only and quad_mode != "centered":
        xouter = features(x, quad_mode)
    w, logZ, sanitized = posteriors(
        state, x, diag_only=diag_only, quad_mode=quad_mode,
        matmul_precision=prec, xouter=xouter, cluster_group=cluster_group,
        with_sanitized=True)
    if wts is not None:
        w = w * wts[:, None]
        logZ = logZ * wts
    M1 = kdot(w.T, x, prec)
    if diag_only:
        M2 = kdot(w.T, x * x, prec)
    elif quad_mode == "packed":
        # The upper triangle only, mirrored by one gather: exactly symmetric.
        M2 = unpack_sym(kdot(w.T, xouter, prec), D)
    else:
        if xouter is None:
            xouter = expand_features(x)
        M2 = kdot(w.T, xouter, prec).reshape(K, D, D)
    return SuffStats(loglik=logZ.sum(), Nk=w.sum(dim=0), M1=M1, M2=M2,
                     sanitized=sanitized)


def accumulate_stats(state, data_chunks: torch.Tensor,
                     wts_chunks: Optional[torch.Tensor] = None, *,
                     diag_only: bool = False, quad_mode: str = "expanded",
                     matmul_precision: str = "highest", cluster_group=None,
                     feats_chunks: Optional[torch.Tensor] = None) -> SuffStats:
    """Sum the fused E+M pass over [num_chunks, B, D] event chunks, in chunk
    order; the working set is one chunk's intermediates, so the N x K
    posteriors and N x D^2 features never exist at once (unless
    ``feats_chunks``, [num_chunks, B, F] hoisted features, holds them)."""
    num_chunks, B, D = data_chunks.shape
    K = state.means.shape[0]
    acc = zeros_stats(K, D, data_chunks.dtype, data_chunks.device,
                      diag_only=diag_only)
    for c in range(num_chunks):
        acc = acc + chunk_stats(
            state, data_chunks[c],
            None if wts_chunks is None else wts_chunks[c],
            diag_only=diag_only, quad_mode=quad_mode,
            matmul_precision=matmul_precision, cluster_group=cluster_group,
            xouter=None if feats_chunks is None else feats_chunks[c])
    return acc


def mstep_update(state, stats: SuffStats, *, diag_only: bool = False,
                 covariance_type: Optional[str] = None, cluster_group=None):
    """The division/guard half of :func:`apply_mstep`: (N, means, R).

    For 'full' and 'diag' the kernel K2 (ops/kernels) computes exactly
    these expressions; its plain version is held to equal this function
    bit for bit. ``covariance_type`` (None: 'diag' or 'full' from
    ``diag_only``) adds the JAX package's 'spherical' (needs diag_only) and
    'tied' (needs full statistics; on a sharded cluster axis its pool and
    count are summed and its loading maxed over ``cluster_group``).
    """
    if covariance_type is None:
        covariance_type = "diag" if diag_only else "full"
    dtype = state.R.dtype
    K, D = state.means.shape
    Nk = stats.Nk
    nonempty = Nk > 0.5  # gaussian.cu:614,664
    nk_safe = torch.clamp(Nk, min=1e-30)
    means = torch.where(nonempty[:, None], stats.M1 / nk_safe[:, None],
                        torch.zeros_like(stats.M1))
    eye = torch.eye(D, dtype=dtype, device=Nk.device)
    if diag_only:
        cov_sum = stats.M2 - Nk[:, None] * means * means  # [K, D] diagonal
        cov_sum = torch.where((Nk >= 1.0)[:, None], cov_sum,
                              torch.zeros_like(cov_sum))  # kernel.cu:658-668
        cov_sum = cov_sum + state.avgvar[:, None]  # diagonal loading (:673-675)
        var = torch.where(nonempty[:, None], cov_sum / nk_safe[:, None],
                          torch.ones_like(cov_sum))
        if covariance_type == "spherical":
            # MLE under sigma^2 I: the mean of the per-dim variances; empty
            # clusters stay at var == 1 (the mean of ones).
            var = var.mean(dim=1, keepdim=True) + torch.zeros_like(var)
        R = torch.diag_embed(var)
    elif covariance_type == "tied":
        mmT = means[:, :, None] * means[:, None, :]
        cov_sum = stats.M2 - Nk[:, None, None] * mmT
        cov_sum = torch.where((Nk >= 1.0)[:, None, None], cov_sum,
                              torch.zeros_like(cov_sum))
        R = _tied_covariance(state, Nk, cov_sum, eye, cluster_group)
    else:
        mmT = means[:, :, None] * means[:, None, :]
        cov_sum = stats.M2 - Nk[:, None, None] * mmT
        cov_sum = torch.where((Nk >= 1.0)[:, None, None], cov_sum,
                              torch.zeros_like(cov_sum))
        cov_sum = cov_sum + state.avgvar[:, None, None] * eye[None]
        # empty clusters -> identity (gaussian.cu:669-678)
        R = torch.where(nonempty[:, None, None], cov_sum / nk_safe[:, None, None],
                        eye.expand(K, D, D))
    # Inactive clusters keep inert placeholder params.
    act = state.active
    N = torch.where(act, Nk, torch.zeros_like(Nk))
    means = torch.where(act[:, None], means, torch.zeros_like(means))
    R = torch.where(act[:, None, None], R, eye.expand(K, D, D))
    return N, means, R


def _tied_covariance(state, Nk, cov_sum, eye, cluster_group):
    """The shared covariance of the 'tied' family, broadcast to [K, D, D]:
    the active clusters' centred scatter (zeroed where Nk < 1) pooled and
    divided by the pooled count of the clusters with Nk >= 1 (a cluster in
    the (0.5, 1) dead zone adds neither), loaded once with the largest
    active avgvar; the identity when no cluster counts. On a sharded
    cluster axis the pool and count are summed and the loading maxed over
    ``cluster_group`` (the JAX package's psum/pmax)."""
    K, D = cov_sum.shape[:2]
    act = state.active
    counted = act & (Nk >= 1.0)
    pool = torch.where(act[:, None, None], cov_sum,
                       torch.zeros_like(cov_sum)).sum(dim=0)
    cnt = torch.where(counted, Nk, torch.zeros_like(Nk)).sum()
    avg = torch.where(act, state.avgvar, torch.zeros_like(state.avgvar)).max()
    if cluster_group is not None:
        flat = torch.cat([pool.reshape(-1), cnt.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=cluster_group)
        pool, cnt = flat[:-1].reshape(D, D), flat[-1]
        avg = avg.clone()
        dist.all_reduce(avg, op=dist.ReduceOp.MAX, group=cluster_group)
    shared = torch.where(cnt >= 1.0,
                         (pool + avg * eye) / torch.clamp(cnt, min=1e-30), eye)
    return shared.expand(K, D, D)


def apply_mstep(state, stats: SuffStats, *, diag_only: bool = False,
                cluster_group=None, covariance_type: Optional[str] = None):
    """Parameter update from sufficient statistics, then the constants
    (gaussian.cu:611-701). Returns the new state. On a sharded cluster axis
    (``cluster_group``) each rank updates its own clusters and pi is
    normalised by the global soft count; ``covariance_type`` as in
    :func:`mstep_update`."""
    N, means, R = mstep_update(state, stats, diag_only=diag_only,
                               covariance_type=covariance_type,
                               cluster_group=cluster_group)
    return compute_constants(state.replace(N=N, means=means, R=R),
                             diag_only=diag_only, cluster_group=cluster_group)
