"""Wrappers of the hand-written Hopper kernels K1-K6, and their plain
PyTorch versions.

K1 (``fused_stats``, csrc/fused_stats.cu) replaces the TPU kernel
``_fused_stats_kernel``: one pass over the events producing loglik, Nk, M1
and M2. At 'highest' with K <= 64, K1, K3 and K3's per-lane-events form run
its narrow route, a 16-, 32- or 64-column tile (``stats_tile``), whose
outputs are the 128-wide route's bit for bit. K2 (``mstep``,
csrc/mstep.cu) replaces ``_mstep_kernel`` and the Cholesky constants after
it: the whole M-step, Nk/M1/M2 -> N, means, R, Rinv, constant and pi, in
one launch. K3 (``fused_stats_batched``) and
K4 (``mstep_batched``) replace ``_fused_stats_batched_kernel`` and
``_mstep_batched_kernel``: the same two functions for R restarts at once,
with a leading restart axis on every per-restart operand. K3 shares K1's
kernel and K4 shares K2's, so each lane is bit-identical to the unbatched
kernel on that lane's operands. K3's per-lane-events form
(``fused_stats_fleet``) reads each lane's own events, a tenant of a
fleet: lane r is bit-identical to K1 on its own rows. K5 (``local_lse``)
and K6 (``stats_logz``) replace ``_local_lse_kernel`` and
``_stats_logz_kernel``, the two passes of the cluster-sharded statistics
(``fused_stats_cuda_sharded``): K5 gives
each event's max and shifted sum over this rank's clusters, two all_reduce
calls over the cluster axis combine them into the global log-evidence, and
K6 accumulates this rank's statistics from it. A shard of at most 64
clusters runs them at 'highest' on a kernel of their own, 64 columns wide,
with several CTAs per SM (``shard_tile``); a wider shard, and every shard at
'high' or 'default', runs K1's kernel in their mode.

Precision: K1's kernel (and so K3) runs all three matmul precisions, as
the TPU kernels do through ``_kdot``. 'highest' (fp32's error class)
forms logp on the fp32 FMA units and the statistics on the tensor cores in
three TF32 passes (each operand split as big + small, the small*small term
dropped, each 8-deep partial added outside the tensor cores, which truncate
their sums). 'high' (bf16_3x) and 'default' (one bf16 pass) run both
products on the tensor cores in bf16 m16n8k16 passes: three (each operand
split as bf16 big + bf16 small, small*small dropped) or one; Nk stays a
plain fp32 sum of the posteriors in every mode. K5/K6 run all three too:
'highest' on the shard kernel (K_s <= 64) or K1's, 'high'/'default' on K1's
bf16 instances for every shard width. The plain versions take
``precision`` and run the same arithmetic through ``ops.estep.kdot``.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. Each counts its kernel launches
on a plain integer attribute (``fused_stats.launches``, ``mstep.launches``,
``fused_stats_batched.launches``, ``mstep_batched.launches``,
``local_lse.launches``, ``stats_logz.launches``, and
``fused_stats_fleet.launches`` for K3's per-lane-events form) so a run can
show that it went through the kernels; the narrow route's launches of K1,
K3 and the per-lane form are also counted on ``fused_stats_narrow``,
``fused_stats_batched_narrow`` and ``fused_stats_fleet_narrow``
(``counts.LaunchCount``); K5 and K6 also count per precision
(``local_lse.precision_launches``, ``stats_logz.precision_launches``,
``collections.Counter`` keyed by the precision's name).

Layouts follow the JAX package: the features' column j*D+i holds x_i*x_j,
``A = Rinv.reshape(K, D*D).T`` is [F, K], and M2 [K, F] reshapes to
[K, D, D]. The kernel path masks inactive clusters with NEG_LARGE and
``log(max(pi, 1e-37))`` (the torch-ops path uses -inf; each mirrors its own
JAX counterpart).
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ...state import lane
from ..constants import constants
from ..estep import expand_features, kdot
from ..mstep import SuffStats
from .counts import LaunchCount, note_launch

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
# K1/K3 at 'highest' with K <= 64: K_pad is the smallest of these widths
# >= K (the narrow route), and the CTAs per SM its instances are compiled
# for (W16_CTAS, W32_CTAS, W64_CTAS in fused_stats.cu).
STATS_WIDTHS = (16, 32, 64)
STATS_CTAS = {16: 3, 32: 2, 64: 1}
# Rows of its phase-1 passes (``stats_rows`` in fused_stats.cu): a smaller
# event tile still takes one whole pass of rows in shared memory.
STATS_ROWS = {16: 256, 32: 128, 64: 128}
# K1 pads the posterior rows and its stage buffers' rows by 8 floats, so
# that phase 3's tensor-core fragment loads are free of bank conflicts.
ROW_PAD = 8
STAGE_DEPTH = 16  # rows of one shared-memory stage (KC in fused_stats.cu)
# K5/K6 on a shard of at most SHARD_TILE clusters: the shard kernel's
# column tile and event tile, and the CTAs per SM each is compiled for
# (K5_CTAS, K6_CTAS in fused_stats.cu). Its persistent grid is K1_GRID x
# the CTAs per SM: a constant of the shapes too.
SHARD_TILE = 64
SHARD_ROWS = 128
SHARD_CTAS = {False: 3, True: 2}  # keyed by stats: K5 3, K6 2
# Shared memory of one SM (the H100's 228 KB), of which each resident CTA
# holds 1 KB for the system; K1_SMEM_BYTES is the most one CTA may ask for.
SM_SMEM_BYTES = 233472
CTA_RESERVED_SMEM = 1024


# The kernels' precision codes (PREC in fused_stats.cu).
PRECISIONS = {"highest": 0, "high": 1, "default": 2}


def _check_cuda(*tensors, dtype=torch.float32) -> None:
    for t in tensors:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kernel inputs must be contiguous {dtype} CUDA "
                             f"tensors, got {t.dtype} on {t.device}")


def _check_k1_shapes(name, x, wt, A, h, g, diag):
    n, d = x.shape
    f, k = A.shape
    if ((wt is not None and wt.shape != (n,)) or f != (d if diag else d * d)
            or h.shape != (d, k) or g.shape != (1, k)):
        raise ValueError(
            f"{name} shapes: x {tuple(x.shape)}, wt "
            f"{None if wt is None else tuple(wt.shape)}, A {tuple(A.shape)}, "
            f"h {tuple(h.shape)}, g {tuple(g.shape)}")


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


def _logp_plain(x, A, h, g, diag: bool, precision: str = "highest"):
    """(logp [N, K], features [N, F]) as the TPU kernels' ``_logp_tile``."""
    x2 = x * x if diag else expand_features(x)
    q = kdot(x2, A, precision)
    q = q - 2.0 * kdot(x, h, precision)
    return -0.5 * q + g, x2


def fused_stats_plain(x, wt, A, h, g, *, diag: bool,
                      precision: str = "highest"):
    """K1's function in plain torch: (ll [1, 1], nk [1, K], m1 [K, D],
    m2 [K, F]) from x [N, D], wt [N], A [F, K], h [D, K], g [1, K]; the
    products at ``precision`` (``kdot``), Nk a plain sum."""
    logp, x2 = _logp_plain(x, A, h, g, diag, precision)
    m = torch.clamp(logp.max(dim=1, keepdim=True).values, min=NEG_LARGE)
    e = torch.exp(logp - m)
    s = e.sum(dim=1, keepdim=True)
    w8 = wt[:, None]
    logz = (m + torch.log(s)) * w8
    w = (e / s) * w8
    return (logz.sum().reshape(1, 1), w.sum(dim=0, keepdim=True),
            kdot(w.T, x, precision), kdot(w.T, x2, precision))


def _fe_pad(d: int, diag: bool) -> int:
    """Columns of the augmented feature row [x2 packed | x | 1], padded to
    TILE (the pair table's length)."""
    t = d if diag else d * (d + 1) // 2
    return -(-(t + d + 1) // TILE) * TILE


def _k1_smem(bt: int, k_pad: int, d: int, diag: bool) -> int:
    """Dynamic shared memory of K1's kernel (``stats_smem`` in
    fused_stats.cu): the posteriors, two A_ext stages (STAGE_DEPTH x K_pad
    on the narrow route), two feature stages, the event tile (on the narrow
    route with its weights, and at least a phase-1 pass of rows in both)
    and the pair table."""
    narrow = k_pad < TILE
    a_stage = k_pad if narrow else TILE + ROW_PAD
    rows = max(bt, STATS_ROWS[k_pad]) if narrow else bt
    return 4 * (rows * (k_pad + ROW_PAD) + 2 * STAGE_DEPTH * a_stage
                + 2 * STAGE_DEPTH * (TILE + ROW_PAD) + rows * ((d + 1) | 1)
                + (bt if narrow else 0) + _fe_pad(d, diag))


def k1_tile(k_pad: int, d: int, block_b: int, diag: bool) -> int:
    """K1's event tile: ``block_b`` lowered until the tile's posteriors fit
    their shared-memory share, to a multiple of 128 (or 64, where K1 then
    uses 64-row tiles)."""
    bt = min(block_b, K1_POSTERIOR_BYTES // (4 * k_pad))
    bt = bt // TILE * TILE if bt >= TILE else 64
    smem = _k1_smem(bt, k_pad, d, diag)
    if d > 255 or smem > K1_SMEM_BYTES:
        raise ValueError(f"K1 does not fit D={d}, K_pad={k_pad} "
                         f"({smem} bytes of shared memory)")
    return bt


class KernelTile(NamedTuple):
    """How a statistics kernel runs (K1, K3 and its per-lane form; K5 or
    K6 on one cluster shard): its K_pad columns, events per tile,
    persistent grid (its most CTAs; fewer when N has fewer tiles), CTAs per
    SM and dynamic shared memory per CTA in bytes."""
    k_pad: int
    bt: int
    grid: int
    ctas_per_sm: int
    smem: int


def wide_tile(k: int, d: int, diag: bool, block_b: int = 512) -> KernelTile:
    """K1's kernel at K padded to a multiple of TILE: K1's tile and grid,
    one CTA per SM (K1/K3 off the narrow route; K5/K6 on a shard wider than
    SHARD_TILE or at 'high'/'default')."""
    k_pad = -(-k // TILE) * TILE
    bt = k1_tile(k_pad, d, block_b, diag)
    return KernelTile(k_pad, bt, K1_GRID, 1, _k1_smem(bt, k_pad, d, diag))


def stats_tile(k: int, d: int, diag: bool, precision: str = "highest",
               block_b: int = 512) -> KernelTile:
    """The tile of K1, K3 and K3's per-lane form at ``k`` clusters. At
    'highest' with k <= 64, the narrow route: K_pad the smallest of
    STATS_WIDTHS >= k, and K1's event tile and grid at K_pad = TILE (so
    the outputs are that route's bit for bit), STATS_CTAS CTAs per SM where
    their shared memory fits (fewer where it does not). Else, and where
    not even one CTA fits (a pass of STATS_ROWS rows over a smaller event
    tile at a large D), :func:`wide_tile`. From the shapes and the
    precision alone."""
    if k > STATS_WIDTHS[-1] or precision != "highest":
        return wide_tile(k, d, diag, block_b)
    k_pad = next(w for w in STATS_WIDTHS if w >= k)
    bt = k1_tile(TILE, d, block_b, diag)
    smem = _k1_smem(bt, k_pad, d, diag)
    if smem > K1_SMEM_BYTES:
        return wide_tile(k, d, diag, block_b)
    ctas = min(STATS_CTAS[k_pad], SM_SMEM_BYTES // (smem + CTA_RESERVED_SMEM))
    return KernelTile(k_pad, bt, K1_GRID, ctas, smem)


def on_shard_kernel(k: int, precision: str) -> bool:
    """Whether K5/K6 on a shard of ``k`` clusters run the shard kernel
    ('highest' only, at most SHARD_TILE clusters) rather than K1's."""
    return k <= SHARD_TILE and precision == "highest"


def shard_tile(k: int, d: int, diag: bool, *, stats: bool,
               block_b: int = 512, precision: str = "highest") -> KernelTile:
    """The tile of K5 (``stats=False``) or K6 (``stats=True``) on a shard of
    ``k`` clusters at ``precision``. On the shard kernel
    (:func:`on_shard_kernel`): K_pad = 64, SHARD_ROWS-event tiles and
    SHARD_CTAS CTAs per SM where their shared memory fits (fewer where it
    does not; ValueError where not even one does). Else
    :func:`wide_tile`. Depends on the shapes and the precision alone,
    so the grid and every bit of the result do too."""
    if not on_shard_kernel(k, precision):
        return wide_tile(k, d, diag, block_b)
    smem = 4 * ((SHARD_ROWS * (SHARD_TILE + ROW_PAD) if stats else 0)
                + 2 * STAGE_DEPTH * SHARD_TILE
                + 2 * STAGE_DEPTH * (TILE + ROW_PAD)
                + SHARD_ROWS * ((d + 1) | 1) + _fe_pad(d, diag))
    ctas = min(SHARD_CTAS[stats],
               SM_SMEM_BYTES // (smem + CTA_RESERVED_SMEM))
    if d > 255 or smem > K1_SMEM_BYTES or ctas < 1:
        raise ValueError(f"{'K6' if stats else 'K5'} does not fit D={d} "
                         f"({smem} bytes of shared memory)")
    return KernelTile(SHARD_TILE, SHARD_ROWS, K1_GRID * ctas, ctas, smem)


@functools.lru_cache(maxsize=None)
def _triu(d: int, device: torch.device):
    """Row/column indices of the upper triangle, row-major (i, j), i <= j,
    and whether each pair is off the diagonal."""
    i, j = torch.triu_indices(d, d, device=device)
    return i, j, (i < j)[:, None]


def _packed_a(A: torch.Tensor, d: int) -> torch.Tensor:
    """[..., D*D, K] -> [..., D(D+1)/2, K] rows of the upper triangle
    (row-major (i, j), i <= j), off-diagonal rows A[i*D+j] + A[j*D+i]: the
    operand of K1's symmetric-half features x_i*x_j, i <= j. Gathers only,
    so the host never waits for the card."""
    a = A.reshape(A.shape[:-2] + (d, d, A.shape[-1]))
    i, j, off = _triu(d, A.device)
    return a[..., i, j, :] + torch.where(off, a[..., j, i, :], 0.0)


def _ext_operands(A, h, g, d: int, diag: bool, width: int = TILE):
    """The kernels' parameter operands, per lane of any leading axes:
    A_ext = [A (packed); -2h] [..., T+D, K_pad] and g [..., K_pad], K
    padded to a multiple of ``width`` (a tile's K_pad: TILE, a narrow W, or
    a shard's SHARD_TILE) with columns whose A_ext is 0 and g NEG_LARGE
    (inert, exactly like an inactive cluster)."""
    lead, k = A.shape[:-2], A.shape[-1]
    k_pad = -(-k // width) * width
    a_sym = A if diag else _packed_a(A, d)
    t = a_sym.shape[-2]
    a_ext = torch.zeros(lead + (t + d, k_pad), dtype=torch.float32,
                        device=A.device)
    a_ext[..., :t, :k] = a_sym
    a_ext[..., t:, :k] = -2.0 * h
    g_pad = torch.full(lead + (k_pad,), NEG_LARGE, dtype=torch.float32,
                       device=A.device)
    g_pad[..., :k] = g.reshape(lead + (k,))
    return a_ext, g_pad, t


def fused_stats(x, wt, A, h, g, *, diag: bool, block_b: int = 512,
                precision: str = "highest"):
    """K1: (ll, nk, m1, m2) as in :func:`fused_stats_plain`. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_stats_plain(x, wt, A, h, g, diag=diag,
                                 precision=precision)
    _check_cuda(x, wt, A, h, g)
    _check_k1_shapes("K1", x, wt, A, h, g, diag)
    d, k = x.shape[1], A.shape[1]
    tile = stats_tile(k, d, diag, precision, block_b)
    a_ext, g_pad, _ = _ext_operands(A, h, g, d, diag, tile.k_pad)
    out = _launch_k1(x, wt, a_ext, g_pad, k, diag, tile, precision)
    note_launch(fused_stats)
    if tile.k_pad < TILE:
        note_launch(fused_stats_narrow)
    return out


def _stats_buffers(lead: tuple, grid: int, k: int, d: int, k_pad: int,
                   t: int, diag: bool, dev):
    """The per-CTA partials [*lead, grid, K_pad, T+D+1] and loglik parts
    [*lead, grid] (float64), and the outputs ll [*lead, 1, 1], nk
    [*lead, 1, K], m1 [*lead, K, D], m2 [*lead, K, F] of K1's kernel."""
    new = functools.partial(torch.empty, dtype=torch.float32, device=dev)
    f = d if diag else d * d
    return (new(lead + (grid, k_pad, t + d + 1)),
            torch.empty(lead + (grid,), dtype=torch.float64, device=dev),
            new(lead + (1, 1)), new(lead + (1, k)), new(lead + (k, d)),
            new(lead + (k, f)))


def _launch_k1(x, wt, a_ext, g_pad, k: int, diag: bool, tile: KernelTile,
               precision: str):
    """K1's kernel on operands padded to ``tile.k_pad`` (the wrapper's
    tile, or, to compare routes, another K_pad's); counts no launch."""
    from ._build import library

    n, d = x.shape
    grid = min(-(-n // tile.bt), tile.grid)
    bufs = _stats_buffers((), grid, k, d, tile.k_pad, a_ext.shape[-2] - d,
                          diag, x.device)
    err = library("fused_stats.cu").gmm_fused_stats(
        x.data_ptr(), wt.data_ptr(), a_ext.data_ptr(), g_pad.data_ptr(),
        *(b.data_ptr() for b in bufs), n, d, k, tile.k_pad, int(diag),
        tile.bt, grid, PRECISIONS[precision],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "K1 (fused_stats)")
    return bufs[2:]


fused_stats.launches = 0
# The narrow route's launches (K_pad 16, 32 or 64) of each of the three
# wrappers, counted beside the wrapper's own.
fused_stats_narrow = LaunchCount()
fused_stats_batched_narrow = LaunchCount()
fused_stats_fleet_narrow = LaunchCount()


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


# ---------------------------------------------------------------- K3

def fused_stats_batched_plain(x, wt, lanes, A, h, g, *, diag: bool,
                              precision: str = "highest"):
    """K3's function in plain torch: K1's plain version on each lane r,
    with the event weights scaled by ``lanes[r]`` (the TPU kernel's folded
    lane mask). x [N, D], wt [N], lanes [R], A [R, F, K], h [R, D, K],
    g [R, 1, K] -> (ll [R, 1, 1], nk [R, 1, K], m1 [R, K, D], m2 [R, K, F])."""
    outs = [fused_stats_plain(x, wt * lanes[r], A[r], h[r], g[r], diag=diag,
                              precision=precision)
            for r in range(A.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def fused_stats_batched(x, wt, lanes, A, h, g, *, diag: bool,
                        block_b: int = 512, precision: str = "highest"):
    """K3: the statistics of R restarts in one launch, as in
    :func:`fused_stats_batched_plain`; a lane whose ``lanes`` entry is 0
    comes out exactly zero. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_stats_batched_plain(x, wt, lanes, A, h, g, diag=diag,
                                         precision=precision)
    _check_cuda(x, wt, lanes, A, h, g)
    n, d = x.shape
    r, f, k = A.shape
    if (wt.shape != (n,) or lanes.shape != (r,)
            or f != (d if diag else d * d)
            or h.shape != (r, d, k) or g.shape != (r, 1, k)):
        raise ValueError(
            f"K3 shapes: x {tuple(x.shape)}, wt {tuple(wt.shape)}, lanes "
            f"{tuple(lanes.shape)}, A {tuple(A.shape)}, h {tuple(h.shape)}, "
            f"g {tuple(g.shape)}")
    # K1's tile and grid: from N, K and D only, never from R, so each lane
    # reduces in K1's order.
    tile = stats_tile(k, d, diag, precision, block_b)
    a_ext, g_pad, _ = _ext_operands(A, h, g, d, diag, tile.k_pad)
    out = _launch_k3(x, wt, lanes, a_ext, g_pad, k, diag, tile, precision)
    note_launch(fused_stats_batched)
    if tile.k_pad < TILE:
        note_launch(fused_stats_batched_narrow)
    return out


def _launch_k3(x, wt, lanes, a_ext, g_pad, k: int, diag: bool,
               tile: KernelTile, precision: str):
    """K3's kernel on operands padded to ``tile.k_pad``, as
    :func:`_launch_k1`."""
    from ._build import library

    n, d = x.shape
    r = a_ext.shape[0]
    grid = min(-(-n // tile.bt), tile.grid)
    bufs = _stats_buffers((r,), grid, k, d, tile.k_pad, a_ext.shape[-2] - d,
                          diag, x.device)
    err = library("fused_stats.cu").gmm_fused_stats_batched(
        x.data_ptr(), wt.data_ptr(), lanes.data_ptr(), a_ext.data_ptr(),
        g_pad.data_ptr(), *(b.data_ptr() for b in bufs), n, d, k, tile.k_pad,
        int(diag), tile.bt, grid, r, PRECISIONS[precision],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "K3 (fused_stats_batched)")
    return bufs[2:]


fused_stats_batched.launches = 0


def fused_stats_cuda_batched(states, data_chunks, wts_chunks, lane_mask=None,
                             *, diag_only=False, block_b: int = 512,
                             precision: str = "highest",
                             n_events=None) -> SuffStats:
    """SuffStats of a restart-batched state through K3: the batched
    ``stats_fn`` hook of ``em_while_loop_batched``. Leaves carry the
    leading R: loglik [R], Nk [R, K], M1 [R, K, D], M2 [R, K, D, D] (or
    [R, K, D]). ``lane_mask`` ([R] bool, None = all live) zeroes frozen
    lanes; ``n_events`` as in :func:`fused_stats_cuda`."""
    c, b, d = data_chunks.shape
    R, K = states.means.shape[:2]
    x, wt = _prep_events(data_chunks, wts_chunks)
    if n_events is not None:
        x, wt = x[:n_events], wt[:n_events]
    # Per lane, so each lane's operands are K1's bit for bit.
    A, h, g = (torch.stack(p) for p in zip(*(
        _prep_params(lane(states, r), d, diag_only) for r in range(R))))
    lanes = (torch.ones(R, dtype=torch.float32, device=x.device)
             if lane_mask is None else lane_mask.to(torch.float32))
    ll, nk, m1, m2 = fused_stats_batched(x, wt, lanes, A, h, g,
                                         diag=diag_only, block_b=block_b,
                                         precision=precision)
    dt = data_chunks.dtype
    return SuffStats(loglik=ll[:, 0, 0].to(dt), Nk=nk[:, 0].to(dt),
                     M1=m1.to(dt),
                     M2=(m2 if diag_only else m2.reshape(R, K, d, d)).to(dt))


# ------------------------------------------------- K3, per-lane events

def fused_stats_fleet_plain(x, wt, n, lanes, A, h, g, *, diag: bool,
                            precision: str = "highest"):
    """K3's per-lane-events form in plain torch: K1's plain version on
    each lane r's own first ``n[r]`` rows, x [R, N_pad, D] and wt [R,
    N_pad], the weights scaled by ``lanes[r]``; A, h, g and the outputs as
    in :func:`fused_stats_batched_plain`."""
    outs = []
    for r in range(A.shape[0]):
        m = int(n[r])
        outs.append(fused_stats_plain(x[r, :m], wt[r, :m] * lanes[r], A[r],
                                      h[r], g[r], diag=diag,
                                      precision=precision))
    return tuple(torch.stack(o) for o in zip(*outs))


def fused_stats_fleet(x, wt, n, lanes, A, h, g, *, diag: bool,
                      block_b: int = 512, precision: str = "highest",
                      max_events=None):
    """K3's per-lane-events form: the statistics of R lanes in one launch,
    lane r over its own events x[r, :n[r]] (a tenant of a fleet, each with
    its own chunk grid), as in :func:`fused_stats_fleet_plain`. ``n`` is
    int32 [R] on the lanes' device; ``max_events`` (the largest n[r], known
    to the caller) bounds the launch grid, else N_pad does. Lane r takes
    K1's tile and grid on its n[r] rows, so it is bit-identical to K1 on
    them; a lane whose ``lanes`` entry is 0 comes out exactly zero. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fused_stats_fleet_plain(x, wt, n, lanes, A, h, g, diag=diag,
                                       precision=precision)
    _check_cuda(x, wt, lanes, A, h, g)
    _check_cuda(n, dtype=torch.int32)
    r, n_pad, d = x.shape
    f, k = A.shape[1:]
    if (A.shape[0] != r or wt.shape != (r, n_pad) or n.shape != (r,)
            or lanes.shape != (r,) or f != (d if diag else d * d)
            or h.shape != (r, d, k) or g.shape != (r, 1, k)):
        raise ValueError(
            f"K3 (per-lane events) shapes: x {tuple(x.shape)}, wt "
            f"{tuple(wt.shape)}, n {tuple(n.shape)}, lanes "
            f"{tuple(lanes.shape)}, A {tuple(A.shape)}, h {tuple(h.shape)}, "
            f"g {tuple(g.shape)}")
    tile = stats_tile(k, d, diag, precision, block_b)
    a_ext, g_pad, _ = _ext_operands(A, h, g, d, diag, tile.k_pad)
    most = n_pad if max_events is None else min(int(max_events), n_pad)
    out = _launch_fleet(x, wt, n, lanes, a_ext, g_pad, k, diag, tile,
                        precision, most)
    note_launch(fused_stats_fleet)
    if tile.k_pad < TILE:
        note_launch(fused_stats_fleet_narrow)
    return out


def _launch_fleet(x, wt, n, lanes, a_ext, g_pad, k: int, diag: bool,
                  tile: KernelTile, precision: str, most: int):
    """K3's per-lane-events form on operands padded to ``tile.k_pad``, as
    :func:`_launch_k1`; ``most`` (the largest n[r]) bounds the grid."""
    from ._build import library

    r, n_pad, d = x.shape
    grid = min(-(-most // tile.bt), tile.grid)
    bufs = _stats_buffers((r,), grid, k, d, tile.k_pad, a_ext.shape[-2] - d,
                          diag, x.device)
    err = library("fused_stats.cu").gmm_fused_stats_fleet(
        x.data_ptr(), wt.data_ptr(), n.data_ptr(), lanes.data_ptr(),
        a_ext.data_ptr(), g_pad.data_ptr(), *(b.data_ptr() for b in bufs),
        n_pad, d, k, tile.k_pad, int(diag), tile.bt, grid, K1_GRID, r,
        PRECISIONS[precision], torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "K3 (fused_stats_fleet)")
    return bufs[2:]


fused_stats_fleet.launches = 0


def fused_stats_cuda_fleet(states, data_chunks, wts_chunks, lane_mask=None,
                           *, diag_only=False, block_b: int = 512,
                           precision: str = "highest", n_events=None,
                           max_events=None) -> SuffStats:
    """SuffStats of a fleet group through K3's per-lane-events form: the
    batched ``stats_fn`` hook of a 'vmap' fleet (``GMMModel.run_em_fleet``).
    ``data_chunks`` [T, C, B, D] and ``wts_chunks`` [T, C, B] hold each
    lane's own chunk grid; ``n_events`` (int32 [T] on the device, None = the
    whole grids) its real events, ``max_events`` their largest.
    ``lane_mask`` and the outputs as in :func:`fused_stats_cuda_batched`."""
    T, C, B, d = data_chunks.shape
    K = states.means.shape[1]
    x = data_chunks.reshape(T, C * B, d).to(torch.float32)
    wt = wts_chunks.reshape(T, C * B).to(torch.float32)
    if n_events is None:
        n_events = torch.full((T,), C * B, dtype=torch.int32,
                              device=x.device)
    A, h, g = (torch.stack(p) for p in zip(*(
        _prep_params(lane(states, r), d, diag_only) for r in range(T))))
    lanes = (torch.ones(T, dtype=torch.float32, device=x.device)
             if lane_mask is None else lane_mask.to(torch.float32))
    ll, nk, m1, m2 = fused_stats_fleet(x, wt, n_events, lanes, A, h, g,
                                       diag=diag_only, block_b=block_b,
                                       precision=precision,
                                       max_events=max_events)
    dt = data_chunks.dtype
    return SuffStats(loglik=ll[:, 0, 0].to(dt), Nk=nk[:, 0].to(dt),
                     M1=m1.to(dt),
                     M2=(m2 if diag_only else m2.reshape(T, K, d, d)).to(dt))


# ---------------------------------------------------------------- K5 / K6

def local_lse_plain(x, A, h, g, *, diag: bool, precision: str = "highest"):
    """K5's function in plain torch: per event, the max m [N, 1] of logp
    over this shard's K_s clusters and the shifted sum s [N, 1] of
    exp(logp - m), from K1's x, A [F, K_s], h [D, K_s], g [1, K_s]; logp's
    products at ``precision`` (the TPU kernel's ``_logp_tile``). An
    all-masked shard gives m = NEG_LARGE and s = K_s."""
    logp, _ = _logp_plain(x, A, h, g, diag, precision)
    m = logp.max(dim=1, keepdim=True).values
    return m, torch.exp(logp - m).sum(dim=1, keepdim=True)


def stats_logz_plain(x, wt, logz, A, h, g, *, diag: bool,
                     precision: str = "highest"):
    """K6's function in plain torch: K1's outputs for this shard's clusters
    with w = exp(logp - logz) * wt from the global log-evidence logz
    [N, 1], and ll = sum logz * wt (the same on every shard); the products
    at ``precision``, Nk a plain sum."""
    logp, x2 = _logp_plain(x, A, h, g, diag, precision)
    w8 = wt[:, None]
    w = torch.exp(logp - logz) * w8
    return ((logz * w8).sum().reshape(1, 1), w.sum(dim=0, keepdim=True),
            kdot(w.T, x, precision), kdot(w.T, x2, precision))


def _shard_operands(A, h, g, d: int, diag: bool, precision: str = "highest"):
    """A_ext and g of one cluster shard, padded to its tile width: 64
    columns on the shard kernel (:func:`on_shard_kernel`), else a multiple
    of TILE."""
    width = SHARD_TILE if on_shard_kernel(A.shape[-1], precision) else TILE
    a_ext, g_pad, _ = _ext_operands(A, h, g, d, diag, width)
    return a_ext, g_pad


def _shard_prep(name, x, wt, A, h, g, diag: bool, precision: str):
    """None for CPU tensors (the caller takes the plain versions); else the
    checks of K5/K6's inputs and the shard's padded operands, built once
    for both kernels."""
    if x.device.type == "cpu":
        return None
    _check_cuda(*(t for t in (x, wt, A, h, g) if t is not None))
    _check_k1_shapes(name, x, wt, A, h, g, diag)
    return _shard_operands(A, h, g, x.shape[1], diag, precision)


def _local_lse_launch(x, ops, k: int, diag: bool, block_b: int,
                      precision: str):
    """K5 on a shard's prepared operands (:func:`_shard_prep`)."""
    from ._build import library

    n, d = x.shape
    a_ext, g_pad = ops
    tile = shard_tile(k, d, diag, stats=False, block_b=block_b,
                      precision=precision)
    grid = min(-(-n // tile.bt), tile.grid)
    m = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    s = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    fn = library("fused_stats.cu").gmm_local_lse
    err = fn(x.data_ptr(), a_ext.data_ptr(), g_pad.data_ptr(), m.data_ptr(),
             s.data_ptr(), n, d, k, tile.k_pad, int(diag), tile.bt, grid,
             PRECISIONS[precision],
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "K5 (local_lse)")
    note_launch(local_lse)
    local_lse.precision_launches[precision] += 1
    return m, s


def _stats_logz_launch(x, wt, logz, ops, k: int, diag: bool, block_b: int,
                       precision: str):
    """K6 on a shard's prepared operands, as :func:`_local_lse_launch`."""
    from ._build import library

    n, d = x.shape
    _check_cuda(logz)
    if logz.shape != (n, 1):
        raise ValueError(f"K6: logz {tuple(logz.shape)} for {n} events")
    a_ext, g_pad = ops
    tile = shard_tile(k, d, diag, stats=True, block_b=block_b,
                      precision=precision)
    f = d if diag else d * d
    t = a_ext.shape[0] - d
    grid = min(-(-n // tile.bt), tile.grid)
    dev = x.device
    partial = torch.empty((grid, tile.k_pad, t + d + 1), dtype=torch.float32,
                          device=dev)
    ll_part = torch.empty(grid, dtype=torch.float64, device=dev)
    ll = torch.empty((1, 1), dtype=torch.float32, device=dev)
    nk = torch.empty((1, k), dtype=torch.float32, device=dev)
    m1 = torch.empty((k, d), dtype=torch.float32, device=dev)
    m2 = torch.empty((k, f), dtype=torch.float32, device=dev)
    fn = library("fused_stats.cu").gmm_stats_logz
    err = fn(x.data_ptr(), wt.data_ptr(), logz.data_ptr(), a_ext.data_ptr(),
             g_pad.data_ptr(), partial.data_ptr(), ll_part.data_ptr(),
             ll.data_ptr(), nk.data_ptr(), m1.data_ptr(), m2.data_ptr(), n, d,
             k, tile.k_pad, int(diag), tile.bt, grid, PRECISIONS[precision],
             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "K6 (stats_logz)")
    note_launch(stats_logz)
    stats_logz.precision_launches[precision] += 1
    return ll, nk, m1, m2


def local_lse(x, A, h, g, *, diag: bool, block_b: int = 512,
              precision: str = "highest"):
    """K5: (m, s) as in :func:`local_lse_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    ops = _shard_prep("K5", x, None, A, h, g, diag, precision)
    if ops is None:
        return local_lse_plain(x, A, h, g, diag=diag, precision=precision)
    return _local_lse_launch(x, ops, A.shape[1], diag, block_b, precision)


local_lse.launches = 0
local_lse.precision_launches = collections.Counter()


def stats_logz(x, wt, logz, A, h, g, *, diag: bool, block_b: int = 512,
               precision: str = "highest"):
    """K6: (ll, nk, m1, m2) as in :func:`stats_logz_plain`. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    ops = _shard_prep("K6", x, wt, A, h, g, diag, precision)
    if ops is None:
        return stats_logz_plain(x, wt, logz, A, h, g, diag=diag,
                                precision=precision)
    return _stats_logz_launch(x, wt, logz, ops, A.shape[1], diag, block_b,
                              precision)


stats_logz.launches = 0
stats_logz.precision_launches = collections.Counter()


def fused_stats_cuda_sharded(state, data_chunks, wts_chunks, *,
                             cluster_group, diag_only: bool = False,
                             block_b: int = 512, precision: str = "highest",
                             n_events=None) -> SuffStats:
    """SuffStats of this rank's cluster shard through K5, two all_reduce
    calls over ``cluster_group`` and K6: the cluster-sharded ``stats_fn``
    hook, the counterpart of the JAX package's
    ``fused_stats_pallas_sharded``. K5 gives each event's local (m, s);
    M = MAX over the shards of m, S = SUM of exp(m - M) * s, logZ =
    M + log(S) (a shard whose clusters are all inactive has m = NEG_LARGE,
    so its exp(m - M) is exactly 0); K6 accumulates the statistics from
    logZ. Only [N, 1] per-event scalars cross ranks. The shard's padded
    operands are built once and read by both kernels. The loglik is the
    same on every rank of the group. ``n_events`` as in
    :func:`fused_stats_cuda`."""
    c, b, d = data_chunks.shape
    K = state.means.shape[0]
    x, wt = _prep_events(data_chunks, wts_chunks)
    if n_events is not None:
        x, wt = x[:n_events], wt[:n_events]
    A, h, g = _prep_params(state, d, diag_only)
    ops = _shard_prep("K5/K6", x, wt, A, h, g, diag_only, precision)
    if ops is None:
        m, s = local_lse_plain(x, A, h, g, diag=diag_only, precision=precision)
    else:
        m, s = _local_lse_launch(x, ops, K, diag_only, block_b, precision)
    big_m = m.clone()
    dist.all_reduce(big_m, op=dist.ReduceOp.MAX, group=cluster_group)
    big_s = torch.exp(m - big_m) * s
    dist.all_reduce(big_s, op=dist.ReduceOp.SUM, group=cluster_group)
    logz = big_m + torch.log(big_s)
    if ops is None:
        ll, nk, m1, m2 = stats_logz_plain(x, wt, logz, A, h, g,
                                          diag=diag_only, precision=precision)
    else:
        ll, nk, m1, m2 = _stats_logz_launch(x, wt, logz, ops, K, diag_only,
                                            block_b, precision)
    dt = data_chunks.dtype
    return SuffStats(loglik=ll[0, 0].to(dt), Nk=nk[0].to(dt), M1=m1.to(dt),
                     M2=(m2 if diag_only else m2.reshape(K, d, d)).to(dt))


# ---------------------------------------------------------------- K2

def mstep_smem(d: int, diag: bool) -> int:
    """Dynamic shared memory of one K2/K4 CTA (``smem_bytes`` in mstep.cu):
    a 16-byte header, D doubles (log L_jj) and the cluster's R and factor
    L, D x D floats each (R's diagonal alone in diag mode)."""
    return 16 + 8 * d + 4 * (d if diag else 2 * d * d)


def mstep_plain(nk, m1, m2, av, act, *, diag: bool):
    """K2's function in plain torch: the whole M-step, from nk [K], m1
    [K, D], m2 [K, F], avgvar [K] and the active mask [K] (bool) to (n [K],
    mean [K, D], R [K, D, D], Rinv [K, D, D], constant [K], pi [K], ok [K]
    bool). The guarded update mirrors JAX's ``_mstep_math`` on [K, 1]
    columns, term for term the expressions of ``ops.mstep.mstep_update``
    (so the two agree bit for bit); then ``ops.constants.compute_constants``'
    arithmetic, whose ``ok`` is False where R was not positive definite and
    was reset to the identity."""
    k, d = m1.shape
    nk_c, av_c, live = nk[:, None], av[:, None], act[:, None]
    nonempty = nk_c > 0.5  # gaussian.cu:614,664
    safe = torch.clamp(nk_c, min=1e-30)
    mean = torch.where(nonempty, m1 / safe, torch.zeros_like(m1))
    if diag:
        cov = m2 - nk_c * mean * mean  # [K, D] diagonal
        cov = torch.where(nk_c >= 1.0, cov, torch.zeros_like(cov))
        cov = cov + av_c
        fallback = torch.ones_like(cov)
        out = torch.where(nonempty, cov / safe, fallback)
    else:
        mm = (mean[:, :, None] * mean[:, None, :]).reshape(k, d * d)
        fallback = torch.eye(d, dtype=m2.dtype, device=m2.device).reshape(
            1, d * d).expand(k, d * d)
        cov = m2 - nk_c * mm
        cov = torch.where(nk_c >= 1.0, cov, torch.zeros_like(cov))
        cov = cov + av_c * fallback
        out = torch.where(nonempty, cov / safe, fallback)
    n = torch.where(act, nk, torch.zeros_like(nk))
    out = torch.where(live, out, fallback)
    R = torch.diag_embed(out) if diag else out.reshape(k, d, d)
    R, Rinv, constant, pi, ok = constants(n, R, act, diag_only=diag)
    return (n, torch.where(live, mean, torch.zeros_like(mean)), R, Rinv,
            constant, pi, ok)


def _mstep_launch(name, nk, m1, m2, av, act, diag: bool):
    """Checks K2's ([K], ... operands) or K4's ([R, K], ...) inputs,
    allocates the outputs and launches the kernel. Returns the outputs of
    :func:`mstep_plain` (with K4's leading R)."""
    _check_cuda(nk, m1, m2, av)
    _check_cuda(act, dtype=torch.bool)
    lead, (k, d) = m1.shape[:-2], m1.shape[-2:]
    if (m2.shape != lead + (k, d if diag else d * d)
            or any(t.shape != lead + (k,) for t in (nk, av, act))):
        raise ValueError(
            f"{name} shapes: nk {tuple(nk.shape)}, m1 {tuple(m1.shape)}, m2 "
            f"{tuple(m2.shape)}, avgvar {tuple(av.shape)}, act "
            f"{tuple(act.shape)}")
    smem = mstep_smem(d, diag)
    if smem > K1_SMEM_BYTES:
        raise ValueError(f"{name} does not fit D={d} ({smem} bytes of "
                         "shared memory)")
    from ._build import library

    new = functools.partial(torch.empty, dtype=torch.float32, device=m1.device)
    outs = (new(lead + (k,)), new(lead + (k, d)), new(lead + (k, d, d)),
            new(lead + (k, d, d)), new(lead + (k,)), new(lead + (k,)),
            torch.empty(lead + (k,), dtype=torch.bool, device=m1.device))
    err = library("mstep.cu").gmm_mstep(
        *(t.data_ptr() for t in (nk, m1, m2, av, act) + outs), k, d,
        int(diag), math.prod(lead),
        torch.cuda.current_stream(m1.device).cuda_stream)
    _raise_on(err, name)
    return outs


def mstep(nk, m1, m2, av, act, *, diag: bool):
    """K2: the whole M-step in one launch, as in :func:`mstep_plain`. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if m1.device.type == "cpu":
        return mstep_plain(nk, m1, m2, av, act, diag=diag)
    outs = _mstep_launch("K2 (mstep)", nk, m1, m2, av, act, diag)
    note_launch(mstep)
    return outs


mstep.launches = 0


def _mstep_operands(state, stats, diag_only: bool):
    """K2's operands (K4's, with a leading R, from a restart-batched state):
    views of the statistics and the state, M2 as [..., K, F]."""
    D = state.means.shape[-1]
    m2 = (stats.M2 if diag_only
          else stats.M2.reshape(stats.M2.shape[:-2] + (D * D,)))
    return stats.Nk, stats.M1, m2, state.avgvar, state.active


def _mstep_state(state, out):
    """The state with K2/K4's outputs (all but ``ok``)."""
    n, mean, R, Rinv, constant, pi, _ = out
    return state.replace(N=n, means=mean, R=R, Rinv=Rinv, constant=constant,
                         pi=pi)


def fused_mstep_cuda(state, stats: SuffStats, *, diag_only: bool = False):
    """``apply_mstep`` through K2: the EM loop's M-step hook on the kernel
    path, one launch per iteration."""
    return _mstep_state(state, mstep(*_mstep_operands(state, stats, diag_only),
                                     diag=diag_only))


# ---------------------------------------------------------------- K4

def mstep_batched_plain(nk, m1, m2, av, act, *, diag: bool):
    """K4's function in plain torch: K2's plain version on each lane of
    [R, K] / [R, K, D] / [R, K, F] operands."""
    outs = [mstep_plain(nk[r], m1[r], m2[r], av[r], act[r], diag=diag)
            for r in range(m1.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def mstep_batched(nk, m1, m2, av, act, *, diag: bool):
    """K4: the M-step of R restarts in one launch, as in
    :func:`mstep_batched_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if m1.device.type == "cpu":
        return mstep_batched_plain(nk, m1, m2, av, act, diag=diag)
    outs = _mstep_launch("K4 (mstep_batched)", nk, m1, m2, av, act, diag)
    note_launch(mstep_batched)
    return outs


mstep_batched.launches = 0


def fused_mstep_cuda_batched(states, stats: SuffStats, *,
                             diag_only: bool = False):
    """:func:`fused_mstep_cuda` for a restart-batched state, through K4."""
    return _mstep_state(states, mstep_batched(
        *_mstep_operands(states, stats, diag_only), diag=diag_only))
