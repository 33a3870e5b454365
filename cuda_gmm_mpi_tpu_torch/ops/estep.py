"""E-step: per-event cluster log-densities, posteriors, log-likelihood.

The reference's ``estep1`` (``gaussian_kernel.cu:383-444``) and ``estep2``
(``:446-512``) as dense torch products (the torch-ops backend):

  expanded quadratic form (data is globally centered at fit time):
    q[n,k] = (x x^T)[n] . Rinv[k] - 2 (Rinv[k] mu[k]) . x[n] + mu[k].Rinv[k].mu[k]
  diagonal (DIAG_ONLY):
    q[n,k] = sum_d (x_d - mu_d)^2 Rinv_dd, expanded the same way

  logp[n,k]   = -0.5*q + constant[k] + ln(pi[k])      (estep1, :442)
  logZ[n]     = logsumexp_k logp[n,k]                 (estep2, :483-494)
  w[n,k]      = exp(logp - logZ)                      (estep2, :499-502)

Inactive clusters get logp = -inf, which makes them exactly inert in the
log-sum-exp. The packed and centered quadratic forms are not ported yet.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def expand_features(x: torch.Tensor) -> torch.Tensor:
    """[B, D] events -> [B, D*D] flattened outer products x x^T.

    Column j*D+i holds x_i * x_j (the layout of the kernel's on-the-fly
    features and of the M2 statistic)."""
    B, D = x.shape
    return (x[:, :, None] * x[:, None, :]).reshape(B, D * D)


def log_densities(state, x: torch.Tensor, *, diag_only: bool = False,
                  xouter: torch.Tensor | None = None) -> torch.Tensor:
    """Unnormalized log posteriors: [B, K] = -0.5*q + constant + ln(pi).

    ``xouter`` optionally supplies the [B, D*D] features so the fused
    statistics pass computes them once per chunk.
    """
    mu, Rinv = state.means, state.Rinv
    K, D = mu.shape
    if diag_only:
        # estep1's DIAG_ONLY branch (gaussian_kernel.cu:430-433)
        a = torch.diagonal(Rinv, dim1=-2, dim2=-1)  # [K, D]
        q = ((x * x) @ a.T
             - 2.0 * (x @ (a * mu).T)
             + (a * mu * mu).sum(dim=-1)[None, :])
    else:
        if xouter is None:
            xouter = expand_features(x)
        b = torch.einsum("kde,ke->kd", Rinv, mu)  # Rinv mu
        c = (b * mu).sum(dim=-1)  # mu^T Rinv mu
        q = (xouter @ Rinv.reshape(K, D * D).T
             - 2.0 * (x @ b.T)
             + c[None, :])
    logp = -0.5 * q + state.constant[None, :] + torch.log(state.pi)[None, :]
    return torch.where(state.active[None, :], logp,
                       torch.full_like(logp, -torch.inf))


def posteriors(state, x: torch.Tensor, *, diag_only: bool = False,
               xouter: torch.Tensor | None = None, cluster_group=None):
    """(w [B, K], logZ [B]): normalized responsibilities and per-event
    evidence, estep2's max-shifted log-sum-exp (gaussian_kernel.cu:481-502).

    A row whose max is non-finite (every cluster inactive, or poisoned
    densities) is sanitized to a zero shift instead of producing inf-inf.

    With ``cluster_group`` (the process group of a sharded cluster axis)
    the log-sum-exp is a two-stage collective: an all_reduce MAX of the
    per-shard maxima, then an all_reduce SUM of the shifted exponential
    sums. ``w`` then covers this rank's clusters only and ``logZ`` is the
    same on every rank of the group. The max is sanitized after the MAX,
    so a shard whose clusters are all inactive is legitimate.
    """
    logp = log_densities(state, x, diag_only=diag_only, xouter=xouter)
    m = logp.max(dim=1, keepdim=True).values
    if cluster_group is not None:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=cluster_group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    expd = torch.exp(logp - m)
    denom = expd.sum(dim=1, keepdim=True)
    if cluster_group is not None:
        dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=cluster_group)
    logZ = (m + torch.log(denom))[:, 0]
    return expd / denom, logZ
