"""Per-cluster derived quantities: Rinv, log|R|, the Gaussian log-constant, pi.

The reference's ``constants_kernel`` (``gaussian_kernel.cu:250-259``) and its
helpers ``compute_constants`` (``:196-243``), ``invert`` (``:107-169``) and
``compute_pi`` (``:172-193``), as batched torch linear algebra:

- Inversion and log-determinant use a batched Cholesky factorization
  (``torch.linalg.cholesky_ex``) instead of the reference's unpivoted LU: R
  is symmetric and, thanks to the avgvar diagonal loading, positive definite.
- Natural log everywhere (the reference mixes ln on device with log10 on the
  host merge path, invert_matrix.cpp:61).
- Clusters whose covariance is not positive definite are reset to the
  identity covariance, mirroring the reference's empty-cluster identity
  reset (gaussian.cu:669-678).

Every function here also takes a leading restart axis ([R, K, D, D]
covariances, [R, K] counts): each lane gets what the unbatched call gives.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

LOG_2PI = math.log(2.0 * math.pi)


def _eye_like(R: torch.Tensor) -> torch.Tensor:
    return torch.eye(R.shape[-1], dtype=R.dtype, device=R.device).expand_as(R)


def _chol_ok(R: torch.Tensor):
    """Batched Cholesky factor + per-matrix PD flag."""
    L, info = torch.linalg.cholesky_ex(R)
    ok = (info == 0) & torch.isfinite(L.flatten(-2)).all(dim=-1)
    return L, ok


def _logdet_from_chol(L: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(L, dim1=-2, dim2=-1).abs()
    diag = torch.where(ok[..., None], diag, torch.ones_like(diag))
    return 2.0 * torch.log(diag).sum(dim=-1)


def chol_logdet(R: torch.Tensor, diag_only: bool = False):
    """Batched log-determinant + PD flag, without the inverse (the merge
    scan consumes only log|R| of its candidates). Returns (log_det, ok)."""
    if diag_only:
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        ok = (d > 0).all(dim=-1)
        safe = torch.where(d > 0, d, torch.ones_like(d))
        return torch.log(safe).sum(dim=-1), ok
    L, ok = _chol_ok(R)
    return _logdet_from_chol(L, ok), ok


def chol_inverse_logdet(R: torch.Tensor, diag_only: bool = False):
    """Batched inverse + log-determinant of [..., K, D, D] covariances.

    Returns (Rinv, log_det, ok); ``ok`` is False where the factorization
    failed (non-PD input) and callers reset those clusters. ``diag_only``
    is the DIAG_ONLY fast path (gaussian_kernel.cu:215-223): reciprocal
    diagonal and the log of the diagonal product.
    """
    if diag_only:
        d = torch.diagonal(R, dim1=-2, dim2=-1)
        log_det, ok = chol_logdet(R, diag_only=True)
        safe = torch.where(d > 0, d, torch.ones_like(d))
        return torch.diag_embed(1.0 / safe), log_det, ok
    L, ok = _chol_ok(R)
    log_det = _logdet_from_chol(L, ok)
    eye = _eye_like(R)
    L_safe = torch.where(ok[..., None, None], L, eye)
    # Rinv = L^-T L^-1 via a batched triangular solve against I.
    Linv = torch.linalg.solve_triangular(L_safe, eye, upper=False)
    Rinv = torch.einsum("...ji,...jl->...il", Linv, Linv)
    return Rinv, log_det, ok


def constants(N, R, active, diag_only: bool = False, cluster_group=None):
    """(R, Rinv, constant, pi, ok) of :func:`compute_constants` from the
    updated N [..., K], R [..., K, D, D] and active mask; ``ok`` is False
    where R was not positive definite and was reset to the identity."""
    D = R.shape[-1]
    Rinv, log_det, ok = chol_inverse_logdet(R, diag_only=diag_only)
    eye = _eye_like(R)
    R = torch.where(ok[..., None, None], R, eye)
    Rinv = torch.where(ok[..., None, None], Rinv, eye)
    log_det = torch.where(ok, log_det, torch.zeros_like(log_det))
    constant = (-D * 0.5) * LOG_2PI - 0.5 * log_det
    # Normalised within each lane of a restart-batched state.
    n_total = torch.where(active, N, torch.zeros_like(N)).sum(dim=-1,
                                                             keepdim=True)
    if cluster_group is not None:
        dist.all_reduce(n_total, op=dist.ReduceOp.SUM, group=cluster_group)
    pi = torch.where(N < 0.5, torch.full_like(N, 1e-10),
                     N / torch.clamp(n_total, min=1e-30))
    return R, Rinv, constant, pi, ok


def compute_constants(state, diag_only: bool = False, cluster_group=None):
    """Recompute Rinv, constant and pi from R and N.

    Mirrors constants_kernel (gaussian_kernel.cu:250-259):
      constant[c] = -D/2 * ln(2*pi) - 1/2 * ln|R_c|   (:241)
      pi[c]       = N[c] / sum(N), with a 1e-10 floor when N[c] < 0.5 (:184-189)
    Non-PD covariances are reset to identity before the constant is computed.
    With ``cluster_group`` (the process group of a sharded cluster axis)
    pi's denominator is the global soft count, an all_reduce over it.
    """
    R, Rinv, constant, pi, _ = constants(state.N, state.R, state.active,
                                         diag_only, cluster_group)
    return state.replace(R=R, Rinv=Rinv, constant=constant, pi=pi)
