"""Wrappers of the hand-written Hopper kernels K1 and K2, and their plain
PyTorch versions.

K1 (``fused_stats``, csrc/fused_stats.cu) replaces the TPU kernel
``_fused_stats_kernel``: one pass over the events producing loglik, Nk, M1
and M2. K2 (``mstep``, csrc/mstep.cu) replaces ``_mstep_kernel``: the M-step
epilogue Nk/M1/M2 -> N/means/covariance.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each counts its kernel launches
on a plain integer attribute (``fused_stats.launches``, ``mstep.launches``)
so a run can show that it went through the kernels.

Layouts follow the JAX package: the features' column j*D+i holds x_i*x_j,
``A = Rinv.reshape(K, D*D).T`` is [F, K], and M2 [K, F] reshapes to
[K, D, D]. The kernel path masks inactive clusters with NEG_LARGE and
``log(max(pi, 1e-37))`` (the torch-ops path uses -inf; each mirrors its own
JAX counterpart).
"""

from __future__ import annotations

import functools

import torch

from ..estep import expand_features
from ..mstep import SuffStats

NEG_LARGE = -1e30  # stand-in for -inf: exp() underflows to 0, avoids inf-inf

# The persistent grid of K1: a constant (the H100's SM count), so the
# reduction order -- and therefore every bit of the result -- depends on
# the shapes alone, never on the card.
K1_GRID = 132
# Shared memory of one K1 CTA (the H100's per-block maximum) and the part
# of it given to the tile's [B_t, K_pad] posteriors.
K1_SMEM_BYTES = 232448
K1_POSTERIOR_BYTES = 131072
TILE = 128  # K1's macro-tile width: K is padded to a multiple of it


def _check_precision(precision: str) -> None:
    if precision != "highest":
        raise ValueError(
            f"matmul_precision={precision!r} is not ported to the CUDA "
            "kernels yet: only 'highest' (plain fp32, no TF32) is")


def _check_cuda(*tensors) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous float32 CUDA "
                             f"tensors, got {t.dtype} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# ---------------------------------------------------------------- K1

def _prep_events(data_chunks: torch.Tensor, wts_chunks):
    """Flat [N, D] events + [N] weights, as views of the chunk arrays (no
    padding copy: K1 masks the ragged last tile itself)."""
    c, b, d = data_chunks.shape
    x = data_chunks.reshape(c * b, d)
    if wts_chunks is None:
        wt = torch.ones(c * b, dtype=x.dtype, device=x.device)
    else:
        wt = wts_chunks.reshape(c * b)
    return x.to(torch.float32), wt.to(torch.float32)


def _prep_params(state, d: int, diag_only: bool):
    """Per-cluster terms (A [F, K], h [D, K], g [1, K]) for
    logp = -0.5 (x2.A - 2 x.h) + g, emitted pre-transposed as in JAX's
    ``_prep_params``."""
    K = state.means.shape[0]
    Rinv = state.Rinv.to(torch.float32)
    mu = state.means.to(torch.float32)
    if diag_only:
        A = torch.diagonal(Rinv, dim1=-2, dim2=-1)  # [K, D]
        h = A * mu
    else:
        A = Rinv.reshape(K, d * d)
        h = torch.einsum("kde,ke->kd", Rinv, mu)
    g = (-0.5 * (h * mu).sum(dim=-1)
         + state.constant.to(torch.float32)
         + torch.log(torch.clamp(state.pi.to(torch.float32), min=1e-37)))
    g = torch.where(state.active, g, torch.full_like(g, NEG_LARGE))[None, :]
    return A.T.contiguous(), h.T.contiguous(), g


def fused_stats_plain(x, wt, A, h, g, *, diag: bool):
    """K1's function in plain torch: (ll [1, 1], nk [1, K], m1 [K, D],
    m2 [K, F]) from x [N, D], wt [N], A [F, K], h [D, K], g [1, K]."""
    x2 = x * x if diag else expand_features(x)
    q = x2 @ A
    q = q - 2.0 * (x @ h)
    logp = -0.5 * q + g
    m = torch.clamp(logp.max(dim=1, keepdim=True).values, min=NEG_LARGE)
    e = torch.exp(logp - m)
    s = e.sum(dim=1, keepdim=True)
    w8 = wt[:, None]
    logz = (m + torch.log(s)) * w8
    w = (e / s) * w8
    return (logz.sum().reshape(1, 1), w.sum(dim=0, keepdim=True),
            w.T @ x, w.T @ x2)


def k1_tile(k_pad: int, d: int, block_b: int, diag: bool) -> int:
    """K1's event tile: ``block_b`` lowered until the tile's posteriors fit
    their shared-memory share, to a multiple of 128 (or 64, where K1 then
    uses 64-row tiles)."""
    bt = min(block_b, K1_POSTERIOR_BYTES // (4 * k_pad))
    bt = bt // TILE * TILE if bt >= TILE else 64
    t = d if diag else d * (d + 1) // 2
    fe_pad = -(-(t + d + 1) // TILE) * TILE
    smem = 4 * (bt * k_pad + 4 * 16 * TILE + bt * ((d + 1) | 1) + fe_pad)
    if d > 255 or smem > K1_SMEM_BYTES:
        raise ValueError(f"K1 does not fit D={d}, K_pad={k_pad} "
                         f"({smem} bytes of shared memory)")
    return bt


@functools.lru_cache(maxsize=None)
def _triu(d: int, device: torch.device):
    """Row/column indices of the upper triangle, row-major (i, j), i <= j,
    and whether each pair is off the diagonal."""
    i, j = torch.triu_indices(d, d, device=device)
    return i, j, (i < j)[:, None]


def _packed_a(A: torch.Tensor, d: int) -> torch.Tensor:
    """[D*D, K] -> [D(D+1)/2, K] rows of the upper triangle (row-major
    (i, j), i <= j), off-diagonal rows A[i*D+j] + A[j*D+i]: the operand of
    K1's symmetric-half features x_i*x_j, i <= j. Gathers only, so the
    host never waits for the card."""
    a = A.reshape(d, d, -1)
    i, j, off = _triu(d, A.device)
    return a[i, j] + torch.where(off, a[j, i], 0.0)


def fused_stats(x, wt, A, h, g, *, diag: bool, block_b: int = 512,
                precision: str = "highest"):
    """K1: (ll, nk, m1, m2) as in :func:`fused_stats_plain`. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_stats_plain(x, wt, A, h, g, diag=diag)
    _check_precision(precision)
    _check_cuda(x, wt, A, h, g)
    n, d = x.shape
    f, k = A.shape
    if (wt.shape != (n,) or f != (d if diag else d * d)
            or h.shape != (d, k) or g.shape != (1, k)):
        raise ValueError(
            f"K1 shapes: x {tuple(x.shape)}, wt {tuple(wt.shape)}, A "
            f"{tuple(A.shape)}, h {tuple(h.shape)}, g {tuple(g.shape)}")
    from ._build import library

    k_pad = -(-k // TILE) * TILE
    a_sym = A if diag else _packed_a(A, d)
    t = a_sym.shape[0]
    # A_ext = [A (packed); -2h], padded to K_pad columns whose g is
    # NEG_LARGE (inert, exactly like an inactive cluster).
    a_ext = torch.zeros((t + d, k_pad), dtype=torch.float32, device=x.device)
    a_ext[:t, :k] = a_sym
    a_ext[t:, :k] = -2.0 * h
    g_pad = torch.full((k_pad,), NEG_LARGE, dtype=torch.float32,
                       device=x.device)
    g_pad[:k] = g.reshape(k)
    bt = k1_tile(k_pad, d, block_b, diag)
    grid = min(-(-n // bt), K1_GRID)
    partial = torch.empty((grid, k_pad, t + d + 1), dtype=torch.float32,
                          device=x.device)
    ll_part = torch.empty(grid, dtype=torch.float64, device=x.device)
    ll = torch.empty((1, 1), dtype=torch.float32, device=x.device)
    nk = torch.empty((1, k), dtype=torch.float32, device=x.device)
    m1 = torch.empty((k, d), dtype=torch.float32, device=x.device)
    m2 = torch.empty((k, f), dtype=torch.float32, device=x.device)
    fn = library("fused_stats.cu").gmm_fused_stats
    err = fn(x.data_ptr(), wt.data_ptr(), a_ext.data_ptr(), g_pad.data_ptr(),
             partial.data_ptr(), ll_part.data_ptr(), ll.data_ptr(),
             nk.data_ptr(), m1.data_ptr(), m2.data_ptr(), n, d, k, k_pad,
             int(diag), bt, grid, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "K1 (fused_stats)")
    fused_stats.launches += 1
    return ll, nk, m1, m2


fused_stats.launches = 0


def fused_stats_cuda(state, data_chunks, wts_chunks, *, diag_only=False,
                     block_b: int = 512, precision: str = "highest",
                     n_events=None) -> SuffStats:
    """SuffStats for all chunks through K1: the drop-in for
    ``accumulate_stats`` (``stats_fn`` hook of the EM loop). With
    ``n_events``, only the first ``n_events`` flattened rows go to K1: the
    rest of the chunk grid is zero-weight padding, which adds nothing."""
    c, b, d = data_chunks.shape
    K = state.means.shape[0]
    x, wt = _prep_events(data_chunks, wts_chunks)
    if n_events is not None:
        x, wt = x[:n_events], wt[:n_events]
    A, h, g = _prep_params(state, d, diag_only)
    ll, nk, m1, m2 = fused_stats(x, wt, A, h, g, diag=diag_only,
                                 block_b=block_b, precision=precision)
    dt = data_chunks.dtype
    return SuffStats(loglik=ll[0, 0].to(dt), Nk=nk[0].to(dt), M1=m1.to(dt),
                     M2=(m2 if diag_only else m2.reshape(K, d, d)).to(dt))


# ---------------------------------------------------------------- K2

def mstep_plain(nk, m1, m2, av, act, *, diag: bool):
    """K2's function in plain torch, mirroring JAX's ``_mstep_math`` on
    [K, 1] columns: (n [K, 1], mean [K, D], cov [K, F]). Term for term the
    expressions of ``ops.mstep.mstep_update``, so the two agree bit for bit.
    """
    k, d = m1.shape
    nonempty = nk > 0.5  # gaussian.cu:614,664
    safe = torch.clamp(nk, min=1e-30)
    mean = torch.where(nonempty, m1 / safe, torch.zeros_like(m1))
    if diag:
        cov = m2 - nk * mean * mean  # [K, D] diagonal
        cov = torch.where(nk >= 1.0, cov, torch.zeros_like(cov))
        cov = cov + av
        fallback = torch.ones_like(cov)
        out = torch.where(nonempty, cov / safe, fallback)
    else:
        mm = (mean[:, :, None] * mean[:, None, :]).reshape(k, d * d)
        fallback = torch.eye(d, dtype=m2.dtype, device=m2.device).reshape(
            1, d * d).expand(k, d * d)
        cov = m2 - nk * mm
        cov = torch.where(nk >= 1.0, cov, torch.zeros_like(cov))
        cov = cov + av * fallback
        out = torch.where(nonempty, cov / safe, fallback)
    live = act > 0.5
    return (torch.where(live, nk, torch.zeros_like(nk)),
            torch.where(live, mean, torch.zeros_like(mean)),
            torch.where(live, out, fallback))


def mstep(nk, m1, m2, av, act, *, diag: bool):
    """K2: (n, mean, cov) as in :func:`mstep_plain`. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if m1.device.type == "cpu":
        return mstep_plain(nk, m1, m2, av, act, diag=diag)
    _check_cuda(nk, m1, m2, av, act)
    k, d = m1.shape
    if (m2.shape != (k, d if diag else d * d)
            or any(t.shape != (k, 1) for t in (nk, av, act))):
        raise ValueError(
            f"K2 shapes: nk {tuple(nk.shape)}, m1 {tuple(m1.shape)}, m2 "
            f"{tuple(m2.shape)}, avgvar {tuple(av.shape)}, act "
            f"{tuple(act.shape)}")
    from ._build import library

    n_out = torch.empty((k, 1), dtype=torch.float32, device=m1.device)
    mean = torch.empty((k, d), dtype=torch.float32, device=m1.device)
    cov = torch.empty_like(m2)
    fn = library("mstep.cu").gmm_mstep
    err = fn(nk.data_ptr(), m1.data_ptr(), m2.data_ptr(), av.data_ptr(),
             act.data_ptr(), n_out.data_ptr(), mean.data_ptr(), cov.data_ptr(),
             k, d, int(diag), torch.cuda.current_stream(m1.device).cuda_stream)
    _raise_on(err, "K2 (mstep)")
    mstep.launches += 1
    return n_out, mean, cov


mstep.launches = 0


def _mstep_operands(state, stats, diag_only: bool):
    """K2's [K, 1] / [K, D] / [K, F] float32 operands from a state + stats."""
    K, D = state.means.shape
    f32 = torch.float32
    m2 = stats.M2 if diag_only else stats.M2.reshape(K, D * D)
    return (stats.Nk.to(f32)[:, None].contiguous(),
            stats.M1.to(f32).contiguous(), m2.to(f32).contiguous(),
            state.avgvar.to(f32)[:, None].contiguous(),
            state.active.to(f32)[:, None].contiguous())


def fused_mstep_cuda(state, stats: SuffStats, *, diag_only: bool = False):
    """The division/guard half of ``apply_mstep`` through K2; the caller
    runs ``compute_constants`` on the result, as apply_mstep does."""
    K, D = state.means.shape
    n, mean, cov = mstep(*_mstep_operands(state, stats, diag_only),
                         diag=diag_only)
    dtype = state.R.dtype
    R = torch.diag_embed(cov) if diag_only else cov.reshape(K, D, D)
    return state.replace(N=n[:, 0].to(dtype), means=mean.to(dtype),
                         R=R.to(dtype))
