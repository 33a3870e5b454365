"""E-step: per-event cluster log-densities, posteriors, log-likelihood.

The reference's ``estep1`` (``gaussian_kernel.cu:383-444``) and ``estep2``
(``:446-512``) as dense torch products (the torch-ops backend), with the
JAX package's three quadratic forms (``quad_mode``):

  expanded (default; data is globally centered at fit time):
    q[n,k] = (x x^T)[n] . Rinv[k] - 2 (Rinv[k] mu[k]) . x[n] + mu[k].Rinv[k].mu[k]
  packed: the same with the D(D+1)/2 upper-triangle features x_i x_j (i <= j)
    against Rinv's upper triangle, off-diagonal entries doubled
  centered: q[n,k] = (x - mu_k)^T Rinv_k (x - mu_k), staged explicitly
  diagonal (DIAG_ONLY, any quad_mode):
    q[n,k] = sum_d (x_d - mu_d)^2 Rinv_dd, expanded

  logp[n,k]   = -0.5*q + constant[k] + ln(pi[k])      (estep1, :442)
  logZ[n]     = logsumexp_k logp[n,k]                 (estep2, :483-494)
  w[n,k]      = exp(logp - logZ)                      (estep2, :499-502)

Inactive clusters get logp = -inf, which makes them exactly inert in the
log-sum-exp. Every product over the events goes through :func:`kdot` at
the configured ``matmul_precision``; the [K]-sized parameter terms
(Rinv mu, mu^T Rinv mu) stay in full precision, as the TPU kernels form
them.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), held in ``t``'s dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def kdot(a: torch.Tensor, b: torch.Tensor, precision: str = "highest"
         ) -> torch.Tensor:
    """``a @ b`` with the TPU's arithmetic for ``precision`` (the JAX
    package's ``_kdot``, ops/pallas/fused_stats.py), on any device:

    - 'highest': the plain product (fp32 with TF32 off on a card);
    - 'high': bf16_3x, each operand split as xh = bf16(x), xl = bf16(x - xh);
      ah.bh + ah.bl + al.bh, each an fp32 product of bf16-valued operands
      (the dropped al.bl is O(2^-16) relative);
    - 'default': one bf16 pass, bf16(a).bf16(b) in fp32.

    The split applies to float32 operands; float64 products stay float64
    (XLA ignores HIGH/DEFAULT there too)."""
    if precision == "highest" or a.dtype != torch.float32:
        return a @ b
    ah, bh = _bf16(a), _bf16(b)
    if precision == "default":
        return ah @ bh
    if precision != "high":
        raise ValueError(f"unknown matmul_precision: {precision!r}")
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def expand_features(x: torch.Tensor) -> torch.Tensor:
    """[B, D] events -> [B, D*D] flattened outer products x x^T.

    Column j*D+i holds x_i * x_j (the layout of the kernel's on-the-fly
    features and of the M2 statistic)."""
    B, D = x.shape
    return (x[:, :, None] * x[:, None, :]).reshape(B, D * D)


def pack_features(x: torch.Tensor) -> torch.Tensor:
    """[B, D] events -> [B, D(D+1)/2] upper-triangle products x_i * x_j
    (i <= j), in ``torch.triu_indices`` (row-major) order."""
    D = x.shape[-1]
    return torch.cat([x[:, i:] * x[:, i:i + 1] for i in range(D)], dim=1)


@functools.lru_cache(maxsize=None)
def _tri(D: int):
    """(iu0, iu1, fullmap): the upper triangle's row/column indices and a
    [D*D] map from full position (i, j) to its packed index."""
    iu0, iu1 = torch.triu_indices(D, D)
    fullmap = torch.zeros((D, D), dtype=torch.long)
    fullmap[iu0, iu1] = torch.arange(iu0.numel())
    fullmap = torch.maximum(fullmap, fullmap.T).reshape(-1)
    return iu0, iu1, fullmap


def pack_sym_weighted(A: torch.Tensor) -> torch.Tensor:
    """[K, D, D] symmetric -> [K, D(D+1)/2], off-diagonal entries doubled,
    so packed features . packed A is the full quadratic form."""
    iu0, iu1, _ = _tri(A.shape[-1])
    coef = torch.where(iu0 == iu1, 1.0, 2.0).to(A.dtype).to(A.device)
    return A[:, iu0, iu1] * coef


def unpack_sym(P: torch.Tensor, D: int) -> torch.Tensor:
    """[K, D(D+1)/2] packed upper triangle -> [K, D, D] symmetric (one
    gather: both mirrored entries come from the same packed value)."""
    _, _, fullmap = _tri(D)
    return P[:, fullmap.to(P.device)].reshape(P.shape[0], D, D)


def features(x: torch.Tensor, quad_mode: str = "expanded") -> torch.Tensor:
    """The per-event quadratic features of ``quad_mode``: [B, D(D+1)/2]
    packed, or [B, D*D] flattened outer products."""
    return pack_features(x) if quad_mode == "packed" else expand_features(x)


def log_densities(state, x: torch.Tensor, *, diag_only: bool = False,
                  quad_mode: str = "expanded",
                  matmul_precision: str = "highest",
                  xouter: torch.Tensor | None = None) -> torch.Tensor:
    """Unnormalized log posteriors: [B, K] = -0.5*q + constant + ln(pi).

    ``xouter`` optionally supplies the per-event features of ``quad_mode``
    (:func:`features`) so the fused statistics pass computes them once per
    chunk.
    """
    prec = matmul_precision
    mu, Rinv = state.means, state.Rinv
    K, D = mu.shape
    if diag_only:
        # estep1's DIAG_ONLY branch (gaussian_kernel.cu:430-433)
        a = torch.diagonal(Rinv, dim1=-2, dim2=-1)  # [K, D]
        q = (kdot(x * x, a.T, prec)
             - 2.0 * kdot(x, (a * mu).T, prec)
             + (a * mu * mu).sum(dim=-1)[None, :])
    elif quad_mode in ("expanded", "packed"):
        if xouter is None:
            xouter = features(x, quad_mode)
        A = (pack_sym_weighted(Rinv) if quad_mode == "packed"
             else Rinv.reshape(K, D * D))
        # Rinv mu: a [K]-sized parameter product, in full precision at
        # every matmul_precision (as the TPU kernels' _prep_params forms h).
        b = torch.einsum("kde,ke->kd", Rinv, mu)
        c = (b * mu).sum(dim=-1)  # mu^T Rinv mu
        q = kdot(xouter, A.T, prec) - 2.0 * kdot(x, b.T, prec) + c[None, :]
    elif quad_mode == "centered":
        xc = x[None, :, :] - mu[:, None, :]  # [K, B, D]
        t = kdot(xc, Rinv, prec)  # [K, B, D]: (x - mu_k)^T Rinv_k
        q = kdot(t[..., None, :], xc[..., :, None], prec)[..., 0, 0].T
    else:
        raise ValueError(f"unknown quad_mode {quad_mode!r}")
    logp = -0.5 * q + state.constant[None, :] + torch.log(state.pi)[None, :]
    return torch.where(state.active[None, :], logp,
                       torch.full_like(logp, -torch.inf))


def posteriors(state, x: torch.Tensor, *, diag_only: bool = False,
               quad_mode: str = "expanded", matmul_precision: str = "highest",
               xouter: torch.Tensor | None = None, cluster_group=None,
               with_sanitized: bool = False):
    """(w [B, K], logZ [B]): normalized responsibilities and per-event
    evidence, estep2's max-shifted log-sum-exp (gaussian_kernel.cu:481-502).

    A row whose max is non-finite (every cluster inactive, or poisoned
    densities) is sanitized to a zero shift instead of producing inf-inf.
    ``with_sanitized`` also returns the number of such rows (a 0-d tensor
    in ``x``'s dtype, third element): the health lane
    ``SANITIZED_LANES`` (health.py).

    With ``cluster_group`` (the process group of a sharded cluster axis)
    the log-sum-exp is a two-stage collective: an all_reduce MAX of the
    per-shard maxima, then an all_reduce SUM of the shifted exponential
    sums. ``w`` then covers this rank's clusters only and ``logZ`` is the
    same on every rank of the group. The max is sanitized after the MAX,
    so a shard whose clusters are all inactive is legitimate. A collective
    MAX may drop a NaN, so the sanitized count also looks at the local
    maxima: a NaN or +inf there (a local -inf is an all-inactive shard) is
    summed over the group, and every rank counts the single-device run's
    rows (the JAX package's ``posteriors``, ops/estep.py).
    """
    logp = log_densities(state, x, diag_only=diag_only, quad_mode=quad_mode,
                         matmul_precision=matmul_precision, xouter=xouter)
    m_local = logp.max(dim=1, keepdim=True).values
    m = m_local
    if cluster_group is not None:
        m = m_local.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=cluster_group)
    bad = ~torch.isfinite(m)
    if with_sanitized and cluster_group is not None:
        poison = (torch.isnan(m_local) | (m_local == torch.inf)).to(
            torch.int32)
        dist.all_reduce(poison, op=dist.ReduceOp.SUM, group=cluster_group)
        bad_rows = bad | (poison > 0)
    else:
        bad_rows = bad
    m = torch.where(bad, torch.zeros_like(m), m)
    expd = torch.exp(logp - m)
    denom = expd.sum(dim=1, keepdim=True)
    if cluster_group is not None:
        dist.all_reduce(denom, op=dist.ReduceOp.SUM, group=cluster_group)
    logZ = (m + torch.log(denom))[:, 0]
    if with_sanitized:
        return expd / denom, logZ, bad_rows.sum().to(x.dtype)
    return expd / denom, logZ
