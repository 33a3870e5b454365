"""Wrapper of S1, the serving path's scoring kernel (csrc/score.cu), and its
plain version.

S1 replaces no Pallas kernel. The JAX package's serving executor scores with
the jnp ``posteriors`` (ops/estep.py), compiled per (kind, block, K-bucket,
D); on the card a library product would pick its kernel, and with it each
dot product's order, by the shape of the call, and a row's bits would then
depend on its block and on the K-pad. S1 forms each (event, slot) log
density as one fixed-order loop over the features, accumulated in double
for a float32 model too (so its logp is more exact than a float32 product's),
and the serving contracts (split, coalesced, stacked, K-pad, hot reload: bit
for bit) hold by construction. Its plain version is
``ops.estep.posteriors`` at 'highest'. S1 computes at 'highest' for every
``matmul_precision``: its error against float64 stays inside that class,
which is tighter than the 'high' (2^-17) and 'default' (2^-9) classes.

- :func:`score_operands`: the per-cluster operands in the model's dtype,
  A_ext [T + D, Kb] (the packed upper triangle of Rinv with off-diagonal
  rows doubled, or diag(Rinv) in diag mode; then -2 Rinv mu) and g [Kb] =
  -0.5 mu^T Rinv mu + constant + ln pi, -inf for an inactive slot (the
  masking of ``posteriors``, not K1's NEG_LARGE). 'expanded' and 'packed'
  share them: the kernel forms the same q for both. The centered form
  ('centered', which stages x - mu) holds mu in A_ext's last D rows and
  g = constant + ln pi. :func:`pad_operands`
  widens them to a K-bucket; forming them at the model's own K and then
  padding keeps their bits independent of the bucket (a reduction on the
  card may order its sums by the tensor's shape).
- :func:`score_geometry`: the launch geometry from the shapes alone (a
  thread's register tile, events and slots per CTA, the ring's rows per
  stage and stages, shared bytes, grids, events per scan CTA), on the
  kernel's constants, which csrc/score.cu states.
- :func:`score_launch`: one launch on prepared operands into given outputs
  (CUDA tensors only; two kernels, the logp tiles and the per-event scans,
  with an [N, Kb] scratch for 'assign'), counted once on ``score.launches``
  for the expanded form and on ``centered_form.launches`` for the centered
  one.
- :func:`score`: the function on a state: CPU tensors take the plain
  version, CUDA tensors launch the kernel (no fallback: a failed build or
  launch raises).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..estep import pack_sym_weighted, posteriors
from .counts import LaunchCount, note_launch

KINDS = ("proba", "assign")
QUAD_MODES = ("expanded", "packed", "centered")
MAX_KB = 1024  # widest K-bucket one launch takes (3 Kb serial scan steps)
MAX_D = 255

# csrc/score.cu's constants
TILES = (2, 4, 8)  # a thread's register tile's side (events x slots)
MAX_EV, MAX_KT = 128, 32  # events, slots per CTA, at most
RING_ROWS, STAGES = 32, 3  # A_ext rows per ring stage; stages, at most
SCAN_EV = 32  # events per scan CTA, at most (a lane per event)
SCAN_SMEM = 49152  # a scan CTA's staged logp rows, at most
SMEM_MAX = 232448  # shared memory one CTA may use on an H100
# The wrapper's choice. The expanded form with a full covariance takes the
# widest tile (8 x 8: half the shared-memory bytes per fma of 4 x 4) on
# 128-event CTAs when they number WIDE_CTAS (four per SM of the H100's 132)
# or more; a diagonal one has too few rows to gain from it. A request of at
# most SMALL_ROWS rows (the expanded form's, the centered form's) takes 2 x
# 2 tiles: a thread's chain of rows is then a quarter as long, and the card
# holds enough threads for them. Otherwise 4 x 4. The grid is then grown towards TARGET_CTAS (two per SM) by
# halving the event tile down to MIN_EV, then the slot tile down to MIN_KT:
# each thread issues 16 rows / ev of the ring's copies per fma row and loads
# 16 D / kt x values before its first fma, so neither shrinks further.
TARGET_CTAS, WIDE_CTAS, MIN_EV, MIN_KT = 264, 528, 16, 16
SMALL_ROWS = (1024, 8192)


class Geometry(NamedTuple):
    tile: int  # the register tile's side
    ev: int  # events per CTA
    kt: int  # slots per CTA
    rows: int  # A_ext rows per ring stage
    stages: int
    threads: int  # per CTA: (ev / tile) x (kt / tile)
    smem: int  # dynamic shared bytes per CTA
    grid: tuple  # (event tiles, slot tiles)
    scan_ev: int  # events per scan CTA
    scan_grid: int  # scan CTAs


def _smem(d: int, ev: int, kt: int, rows: int, stages: int, centered: bool,
          itemsize: int) -> int:
    """The x tile and (centered) mu's rows in double, the ring in the
    model's type."""
    return 8 * (d * ev + (d * kt if centered else 0)) + (
        itemsize * stages * rows * kt)


def score_geometry(n: int, d: int, kb: int, diag: bool, centered: bool,
                   itemsize: int) -> Geometry:
    """S1's launch geometry for ``n`` events of ``d`` features at ``kb``
    slots (``itemsize`` 4 or 8 bytes), from the shapes alone."""
    t = d if diag else d * (d + 1) // 2
    nrows = t if centered else t + d  # A_ext rows through the ring
    rows = min(RING_ROWS, nrows)
    stages = STAGES if nrows > rows else 2
    smem = lambda: _smem(d, ev, kt, rows, stages, centered, itemsize)
    ctas = lambda: -(-n // ev) * -(-kb // kt)
    tile, ev = TILES[2], MAX_EV
    kt = min(MAX_KT, -(-kb // tile) * tile)
    if centered or diag or ctas() < WIDE_CTAS or smem() > SMEM_MAX:
        tile = TILES[0] if n <= SMALL_ROWS[centered] else TILES[1]
        kt = min(MAX_KT, -(-kb // tile) * tile)
        while smem() > SMEM_MAX:
            ev //= 2
        while ctas() < TARGET_CTAS:
            if ev > MIN_EV:
                ev //= 2
            elif kt > MIN_KT:
                kt = max(MIN_KT, kt // 2 // tile * tile)
            else:
                break
    # a small request's scan CTAs hold fewer events each, so that more
    # threads share the elementwise passes
    scan_ev = min(SCAN_EV, SCAN_SMEM // ((kb + 1) * itemsize),
                  max(1, -(-n // TARGET_CTAS)))
    return Geometry(tile, ev, kt, rows, stages, (ev // tile) * (kt // tile),
                    smem(), (-(-n // ev), -(-kb // kt)), scan_ev,
                    -(-n // scan_ev))


def score_operands(state, diag_only: bool, centered: bool = False):
    """(A_ext [T + D, Kb], g [Kb]) of ``state`` in its own dtype (see the
    module docstring), contiguous, on the state's device: the expanded
    form's, or with ``centered`` the centered form's."""
    mu, Rinv = state.means, state.Rinv
    if diag_only:
        a = torch.diagonal(Rinv, dim1=-2, dim2=-1)  # [K, D]
    else:
        a = pack_sym_weighted(Rinv)  # [K, D(D+1)/2]
    if centered:
        g = state.constant + torch.log(state.pi)
        tail = mu
    else:
        if diag_only:
            h = a * mu
            c = (a * mu * mu).sum(dim=-1)
        else:
            h = torch.einsum("kde,ke->kd", Rinv, mu)
            c = (h * mu).sum(dim=-1)
        g = -0.5 * c + state.constant + torch.log(state.pi)
        tail = -2.0 * h
    g = torch.where(state.active, g, torch.full_like(g, -torch.inf))
    return torch.cat([a, tail], dim=1).T.contiguous(), g.contiguous()


def pad_operands(a_ext, g, kb: int):
    """S1's operands widened to ``kb`` slots: zero A columns, -inf g (inert
    slots)."""
    k = g.shape[0]
    if kb == k:
        return a_ext, g
    a = torch.zeros((a_ext.shape[0], kb), dtype=a_ext.dtype,
                    device=a_ext.device)
    a[:, :k] = a_ext
    return a, torch.cat([g, torch.full((kb - k,), -torch.inf, dtype=g.dtype,
                                       device=g.device)])


def score_plain(state, x, *, diag_only: bool, quad_mode: str = "expanded",
                kind: str = "proba"):
    """S1's function in plain torch: ``posteriors`` at 'highest', then for
    'assign' the first index of the largest w (int32)."""
    w, logz = posteriors(state, x, diag_only=diag_only, quad_mode=quad_mode,
                         matmul_precision="highest")
    if kind == "assign":
        return torch.argmax(w, dim=1).to(torch.int32), logz
    return w, logz


def _check(x, a_ext, g, diag: bool):
    dt = x.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"S1 takes float32 or float64, got {dt}")
    for t in (x, a_ext, g):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"S1 inputs must be contiguous {dt} CUDA "
                             f"tensors, got {t.dtype} on {t.device}")
    n, d = x.shape
    rows = d if diag else d * (d + 1) // 2
    kb = g.shape[0]
    if a_ext.shape != (rows + d, kb) or g.shape != (kb,):
        raise ValueError(f"S1 shapes: x {tuple(x.shape)}, A_ext "
                         f"{tuple(a_ext.shape)}, g {tuple(g.shape)}")
    if d > MAX_D or kb > MAX_KB:
        raise ValueError(f"S1 takes D <= {MAX_D} and Kb <= {MAX_KB}, got "
                         f"D={d}, Kb={kb}")


def score_launch(x, a_ext, g, logz, *, diag: bool, w=None, labels=None,
                 centered: bool = False):
    """One S1 launch on the current stream: 'proba' into ``w`` [N, Kb] and
    ``logz`` [N] when ``w`` is given, else 'assign' into ``labels`` [N]
    int32 and ``logz``; ``centered`` takes the centered form's operands.
    Raises on a refused launch."""
    _check(x, a_ext, g, diag)
    n, d = x.shape
    kb = g.shape[0]
    assign = w is None
    out = labels if assign else w
    if (out is None or not out.is_cuda or not out.is_contiguous()
            or not logz.is_cuda or logz.dtype != x.dtype
            or logz.shape != (n,)
            or (assign and (labels.dtype != torch.int32
                            or labels.shape != (n,)))
            or (not assign and (w.dtype != x.dtype or w.shape != (n, kb)))):
        raise ValueError("S1 outputs: w [N, Kb] in x's dtype or labels [N] "
                         "int32, and logz [N], contiguous on the card")
    from ._build import library

    geo = score_geometry(n, d, kb, diag, centered, x.element_size())
    # the logp rows: w itself, or for 'assign' a scratch (under a graph's
    # capture it comes from the graph's pool)
    lp = torch.empty((n, kb), dtype=x.dtype, device=x.device) if assign else w
    err = library("score.cu").gmm_score(
        x.data_ptr(), a_ext.data_ptr(), g.data_ptr(), lp.data_ptr(),
        logz.data_ptr(), labels.data_ptr() if assign else 0, n, d, kb,
        int(diag), int(assign), int(centered), int(x.dtype == torch.float64),
        geo.tile, geo.ev, geo.kt, geo.rows, geo.stages, geo.smem,
        geo.scan_ev, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"S1 (score): CUDA error {err} at launch")
    note_launch(centered_form if centered else score)


def score(state, x, *, diag_only: bool, quad_mode: str = "expanded",
          kind: str = "proba"):
    """S1: (w [N, Kb], logZ [N]) for 'proba' or (labels int32 [N], logZ)
    for 'assign', as in :func:`score_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel: the centered form under
    'centered', the expanded form under 'expanded' or 'packed'."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if quad_mode not in QUAD_MODES:
        raise ValueError(f"unknown quad_mode {quad_mode!r}")
    if x.device.type == "cpu":
        return score_plain(state, x, diag_only=diag_only,
                           quad_mode=quad_mode, kind=kind)
    centered = quad_mode == "centered"
    a_ext, g = score_operands(state, diag_only, centered)
    n = x.shape[0]
    logz = torch.empty(n, dtype=x.dtype, device=x.device)
    if kind == "assign":
        labels = torch.empty(n, dtype=torch.int32, device=x.device)
        score_launch(x, a_ext, g, logz, diag=diag_only, labels=labels,
                     centered=centered)
        return labels, logz
    w = torch.empty((n, g.shape[0]), dtype=x.dtype, device=x.device)
    score_launch(x, a_ext, g, logz, diag=diag_only, w=w, centered=centered)
    return w, logz


score.launches = 0
centered_form = LaunchCount()  # the centered form's launches
