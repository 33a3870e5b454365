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

This path is the parity baseline for the kernels K1/K2 and their yardstick
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .constants import compute_constants
from .estep import expand_features, posteriors


@dataclasses.dataclass(frozen=True)
class SuffStats:
    """EM sufficient statistics.

    loglik: 0-d sum of per-event log-evidence
    Nk:     [K]     soft counts
    M1:     [K, D]  weighted event sums
    M2:     [K, D, D] weighted outer-product sums ([K, D] under diag_only)
    """

    loglik: torch.Tensor
    Nk: torch.Tensor
    M1: torch.Tensor
    M2: torch.Tensor

    def __add__(self, other: "SuffStats") -> "SuffStats":
        return SuffStats(self.loglik + other.loglik, self.Nk + other.Nk,
                         self.M1 + other.M1, self.M2 + other.M2)


def zeros_stats(K: int, D: int, dtype, device, diag_only: bool = False):
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return SuffStats(loglik=z(), Nk=z(K), M1=z(K, D),
                     M2=z(K, D) if diag_only else z(K, D, D))


def chunk_stats(state, x: torch.Tensor, wts: Optional[torch.Tensor] = None,
                *, diag_only: bool = False) -> SuffStats:
    """Fused E+M statistics for one chunk of events.

    ``wts`` is a [B] row of nonnegative per-event weights (0 on padding)."""
    K, D = state.means.shape
    xouter = None if diag_only else expand_features(x)
    w, logZ = posteriors(state, x, diag_only=diag_only, xouter=xouter)
    if wts is not None:
        w = w * wts[:, None]
        logZ = logZ * wts
    M1 = w.T @ x
    if diag_only:
        M2 = w.T @ (x * x)
    else:
        M2 = (w.T @ xouter).reshape(K, D, D)
    return SuffStats(loglik=logZ.sum(), Nk=w.sum(dim=0), M1=M1, M2=M2)


def accumulate_stats(state, data_chunks: torch.Tensor,
                     wts_chunks: Optional[torch.Tensor] = None, *,
                     diag_only: bool = False) -> SuffStats:
    """Sum the fused E+M pass over [num_chunks, B, D] event chunks, in chunk
    order; the working set is one chunk's intermediates, so the N x K
    posteriors and N x D^2 features never exist at once."""
    num_chunks, B, D = data_chunks.shape
    K = state.means.shape[0]
    acc = zeros_stats(K, D, data_chunks.dtype, data_chunks.device,
                      diag_only=diag_only)
    for c in range(num_chunks):
        acc = acc + chunk_stats(
            state, data_chunks[c],
            None if wts_chunks is None else wts_chunks[c],
            diag_only=diag_only)
    return acc


def mstep_update(state, stats: SuffStats, *, diag_only: bool = False):
    """The division/guard half of :func:`apply_mstep`: (N, means, R).

    The kernel K2 (ops/kernels) computes exactly these expressions; its
    plain version is held to equal this function bit for bit.
    """
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
        R = torch.diag_embed(var)
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


def apply_mstep(state, stats: SuffStats, *, diag_only: bool = False):
    """Parameter update from sufficient statistics, then the constants
    (gaussian.cu:611-701). Returns the new state."""
    N, means, R = mstep_update(state, stats, diag_only=diag_only)
    return compute_constants(state.replace(N=N, means=means, R=R),
                             diag_only=diag_only)
