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
- :func:`score_launch`: one launch on prepared operands into given outputs
  (CUDA tensors only), counted on ``score.launches`` for the expanded form
  and on ``centered_form.launches`` for the centered one.
- :func:`score`: the function on a state: CPU tensors take the plain
  version, CUDA tensors launch the kernel (no fallback: a failed build or
  launch raises).
"""

from __future__ import annotations

import torch

from ..estep import pack_sym_weighted, posteriors
from .counts import LaunchCount, note_launch

KINDS = ("proba", "assign")
QUAD_MODES = ("expanded", "packed", "centered")
MAX_KB = 1024  # widest K-bucket one launch takes (its logp rows are in smem)
MAX_D = 255


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

    err = library("score.cu").gmm_score(
        x.data_ptr(), a_ext.data_ptr(), g.data_ptr(),
        0 if assign else w.data_ptr(), logz.data_ptr(),
        labels.data_ptr() if assign else 0, n, d, kb, int(diag), int(assign),
        int(centered), int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream)
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
