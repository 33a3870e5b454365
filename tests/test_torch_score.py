"""S1 (csrc/score.cu) on the CPU: its centered form (``quad_mode=
'centered'``), its expanded form's order, and its launch geometry.

- Its plain version, ``score_plain(quad_mode='centered')``
  (``posteriors`` at 'highest'), against the JAX package's ``posteriors``
  in the centered mode, full and diag, float32 and float64: float64 to
  1e-12 relative; float32 w to 1e-5 absolute and logZ to 1e-6 of the
  magnitude of the summed terms (two float32 libraries order each sum
  differently).
- The centered operands evaluated in the kernel's own order (a numpy
  emulation of ``logp_kernel<CENTERED>``: xc = x - mu per (event, slot),
  one term per (i <= j) in row-major order against A's triangle rows,
  accumulated in double, then logp = -0.5 acc + g) against a float64
  reference, on near blobs and on blobs at |x| ~ 170, where the centered
  form keeps what the expanded form loses to cancellation. This holds the
  operand layout the card reads: the doubled off-diagonal rows, mu in the
  last D rows, g = constant + ln pi and -inf for an inactive slot.
- The expanded operands in the kernel's order (x_i x_j per (i <= j), then
  x_d per feature, in double) against the same reference: within float32's
  class on near blobs; at |x| ~ 170 the cancellation the centered form
  avoids, no larger than the plain version's.
- Operands formed at the model's own K and then padded keep their bits at
  every K-bucket (the K-pad contract).
- The wrapper's launch geometry on the constants csrc/score.cu states: the
  shared bytes fit one CTA's 232,448, every event and slot is covered
  once, and a 64-row request at Kb 128 gets at least 32 CTAs.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuda_gmm_mpi_tpu.ops.estep import posteriors as jposteriors
from cuda_gmm_mpi_tpu.state import GMMState as JState
from cuda_gmm_mpi_tpu_torch.ops.estep import posteriors
from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1
from cuda_gmm_mpi_tpu_torch.state import GMMState

LEAVES = ("N", "pi", "constant", "avgvar", "means", "R", "Rinv", "active")
CSRC = Path(s1.__file__).resolve().parents[2] / "csrc" / "score.cu"


def _state(rng, k, d, dtype, center=0.0, spread=4.0, inactive=(1,)):
    """A seeded mixture: SPD precisions, their constants, weights; slots in
    ``inactive`` switched off."""
    means = center + rng.normal(scale=spread, size=(k, d))
    a = rng.normal(size=(k, d, d)) * 0.3
    R = a @ np.swapaxes(a, 1, 2) + np.eye(d)[None] * 0.5
    Rinv = np.linalg.inv(R)
    logdet = np.linalg.slogdet(R)[1]
    constant = -0.5 * d * np.log(2 * np.pi) - 0.5 * logdet
    pi = rng.uniform(0.5, 1.5, size=k)
    pi /= pi.sum()
    active = np.ones(k, bool)
    active[list(inactive)] = False
    leaves = dict(N=pi * 100, pi=pi, constant=constant,
                  avgvar=np.ones(k), means=means, R=R, Rinv=Rinv,
                  active=active)
    return GMMState(**{f: torch.as_tensor(
        v if f == "active" else np.asarray(v, dtype))
        for f, v in leaves.items()})


def _jstate(st):
    return JState(**{f: jnp.asarray(getattr(st, f).numpy()) for f in LEAVES})


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_centered_plain_version_matches_jax_posteriors(dtype, diag):
    rng = np.random.default_rng(21)
    st = _state(rng, 9, 5, dtype)
    x = rng.normal(scale=4.0, size=(300, 5)).astype(dtype)
    w, z = s1.score_plain(st, torch.as_tensor(x), diag_only=diag,
                          quad_mode="centered")
    jw, jz = jposteriors(_jstate(st), jnp.asarray(x), diag_only=diag,
                         quad_mode="centered", matmul_precision="highest")
    jw, jz = np.asarray(jw, np.float64), np.asarray(jz, np.float64)
    if dtype == "float64":
        np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12)
        np.testing.assert_allclose(z.numpy(), jz, rtol=1e-12)
    else:
        np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-5)
        xc = np.abs(x[:, None, :] - st.means.numpy()[None].astype(np.float64))
        terms = (np.einsum("nki,nkj,kij->nk", xc, xc,
                           np.abs(st.Rinv.numpy().astype(np.float64)))
                 + np.abs(st.constant.numpy())
                 + np.abs(np.log(st.pi.numpy().astype(np.float64))))
        assert np.all(np.abs(z.numpy() - jz) <= 1e-6 * terms.max(axis=1))
    assert bool((w[:, ~st.active] == 0).all())


def _emulate(x, a_ext, g, diag):
    """logp_kernel<CENTERED>'s arithmetic in numpy: the terms in the
    kernel's order, in double, then the max/sum/w in the model's dtype."""
    n, d = x.shape
    xs = x.astype(np.float64)
    a = a_ext.astype(np.float64)
    mu = a[-d:]                                  # [D, Kb]
    acc = np.zeros((n, a.shape[1]))
    t = 0
    for i in range(d):
        ci = xs[:, i:i + 1] - mu[i][None]
        for j in (range(i, i + 1) if diag else range(i, d)):
            acc += (ci * (xs[:, j:j + 1] - mu[j][None])) * a[t][None]
            t += 1
    return _scans(acc, g, x.dtype)


def _emulate_expanded(x, a_ext, g, diag):
    """logp_kernel's expanded arithmetic in numpy: from 0, one term
    x_i x_j A[t] per (i <= j) in row-major order (x_d^2 in diag mode), then
    x_d A[T + d] per feature, in double; then the scans."""
    n, d = x.shape
    xs = x.astype(np.float64)
    a = a_ext.astype(np.float64)
    acc = np.zeros((n, a.shape[1]))
    t = 0
    for i in range(d):
        for j in (range(i, i + 1) if diag else range(i, d)):
            acc += (xs[:, i:i + 1] * xs[:, j:j + 1]) * a[t][None]
            t += 1
    for i in range(d):
        acc += xs[:, i:i + 1] * a[t + i][None]
    return _scans(acc, g, x.dtype)


def _scans(acc, g, dt):
    """logp = -0.5 acc + g (-inf where g is), rounded to ``dt``; then
    scan_kernel's max, sum, w and logZ in ``dt``."""
    g64 = g.astype(np.float64)
    lp = np.where(np.isneginf(g64)[None], -np.inf,
                  -0.5 * acc + g64[None]).astype(dt)
    m = lp.max(axis=1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0).astype(dt)
    e = np.exp(lp - m)
    s = e.sum(axis=1, keepdims=True)
    return e / s, (m + np.log(s))[:, 0]


def _reference(st, x, diag):
    """(w, logZ) of the centered form in float64 numpy: the quadratic form
    of each (x - mu_k) against Rinv_k (its diagonal in diag mode)."""
    f = {k: getattr(st, k).numpy().astype(np.float64)
         for k in ("means", "Rinv", "constant", "pi")}
    rinv = f["Rinv"]
    if diag:
        rinv = rinv * np.eye(rinv.shape[-1])[None]
    xc = np.asarray(x, np.float64)[:, None, :] - f["means"][None]
    q = np.einsum("nki,kij,nkj->nk", xc, rinv, xc)
    lp = -0.5 * q + f["constant"][None] + np.log(f["pi"])[None]
    lp = np.where(st.active.numpy()[None], lp, -np.inf)
    m = lp.max(axis=1, keepdims=True)
    e = np.exp(lp - m)
    return e / e.sum(axis=1, keepdims=True), (m + np.log(
        e.sum(axis=1, keepdims=True)))[:, 0]


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_centered_operands_in_the_kernels_order(diag, far):
    """The centered operands, evaluated in the kernel's order, hold the
    float64 reference within float32's class, and at |x| ~ 170 err no more
    than the plain (expanded) torch-ops version does."""
    rng = np.random.default_rng(22)
    center = 170.0 if far else 0.0
    st64 = _state(rng, 12, 6, "float64", center=center, spread=2.0)
    st32 = GMMState(**{f: getattr(st64, f) if f == "active"
                       else getattr(st64, f).float() for f in LEAVES})
    x64 = center + rng.normal(scale=3.0, size=(400, 6))
    x32 = x64.astype(np.float32)
    ref_w, ref_z = _reference(st32, x32, diag)
    a, g = s1.score_operands(st32, diag, centered=True)
    w, z = _emulate(x32, a.numpy(), g.numpy(), diag)
    ew = np.abs(w - ref_w).max()
    ez = np.abs(z - ref_z).max() / np.abs(ref_z).max()
    assert ew <= 1e-5 and ez <= 2 ** -20
    pw, pz = posteriors(st32, torch.as_tensor(x32), diag_only=diag)
    pew = np.abs(pw.numpy() - ref_w).max()
    pez = np.abs(pz.numpy() - ref_z).max() / np.abs(ref_z).max()
    if far:  # the expanded form cancels |x|^2 in float32; centered does not
        assert ew <= max(pew, 1e-6) and ez <= max(pez, 2 ** -23)
    # float64 operands: the emulation equals the reference to 1e-12
    a64, g64 = s1.score_operands(st64, diag, centered=True)
    w64, z64 = _emulate(x64, a64.numpy(), g64.numpy(), diag)
    r64w, r64z = _reference(st64, x64, diag)
    assert np.abs(w64 - r64w).max() <= 1e-12
    assert np.abs(z64 - r64z).max() <= 1e-12 * np.abs(z64).max()
    assert (w[:, ~st32.active.numpy()] == 0).all()


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_expanded_operands_in_the_kernels_order(diag, far):
    """The expanded operands, evaluated in the kernel's order (in double,
    from float32 operands), hold the float64 reference within float32's
    class on near blobs. At |x| ~ 170 they record the cancellation the
    centered form avoids: -2 Rinv mu and g are rounded to float32 at
    magnitudes ~|x|^2, so the error grows past the centered form's (by
    100x at least), yet stays no larger than the plain float32 version's;
    in float64 it grows with |x|^2 (1e-12 x max(1, |x|)^2)."""
    rng = np.random.default_rng(24)
    center = 170.0 if far else 0.0
    st64 = _state(rng, 12, 6, "float64", center=center, spread=2.0)
    st32 = GMMState(**{f: getattr(st64, f) if f == "active"
                       else getattr(st64, f).float() for f in LEAVES})
    x64 = center + rng.normal(scale=3.0, size=(400, 6))
    x32 = x64.astype(np.float32)
    ref_w, ref_z = _reference(st32, x32, diag)
    err = lambda w, z: (np.abs(w - ref_w).max(),
                        np.abs(z - ref_z).max() / np.abs(ref_z).max())
    a, g = s1.score_operands(st32, diag)
    ew, ez = err(*_emulate_expanded(x32, a.numpy(), g.numpy(), diag))
    pw, pz = posteriors(st32, torch.as_tensor(x32), diag_only=diag)
    pew, pez = err(pw.numpy(), pz.numpy())
    if far:
        ac, gc = s1.score_operands(st32, diag, centered=True)
        cew, cez = err(*_emulate(x32, ac.numpy(), gc.numpy(), diag))
        assert ew > 100 * max(cew, 1e-9) and ez > cez
        assert ew <= max(pew, 1e-6) and ez <= max(pez, 2 ** -23)
    else:
        assert ew <= 1e-5 and ez <= 2 ** -20
    a64, g64 = s1.score_operands(st64, diag)
    w64, z64 = _emulate_expanded(x64, a64.numpy(), g64.numpy(), diag)
    r64w, r64z = _reference(st64, x64, diag)
    bar = 1e-12 * max(1.0, center) ** 2
    assert np.abs(w64 - r64w).max() <= bar
    assert np.abs(z64 - r64z).max() <= bar * np.abs(z64).max()
    assert (w64[:, ~st64.active.numpy()] == 0).all()


@pytest.mark.parametrize("centered", [False, True],
                         ids=["expanded", "centered"])
def test_operands_keep_their_bits_at_every_k_bucket(centered):
    rng = np.random.default_rng(23)
    st = _state(rng, 9, 5, "float32")
    a, g = s1.score_operands(st, False, centered)
    for kb in (16, 32, 128):
        pa, pg = s1.pad_operands(a, g, kb)
        assert torch.equal(pa[:, :9], a) and torch.equal(pg[:9], g)
        assert not pa[:, 9:].any() and bool(torch.isneginf(pg[9:]).all())


def test_geometry_constants_are_the_kernel_source_s():
    src = CSRC.read_text()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    tiles = re.search(r"constexpr int TILES\[3\] = \{(.*?)\};", src).group(1)
    assert tuple(int(v) for v in tiles.split(",")) == s1.TILES
    assert (const("MAX_EV"), const("MAX_KT")) == (s1.MAX_EV, s1.MAX_KT)
    assert (const("RING_ROWS"), const("STAGES")) == (s1.RING_ROWS,
                                                     s1.STAGES)
    assert (const("SCAN_EV"), const("SCAN_SMEM")) == (s1.SCAN_EV,
                                                      s1.SCAN_SMEM)
    assert const("SMEM_MAX") == s1.SMEM_MAX == 232448


def _once(tiles, tile, per, total):
    """Whether tile u's thread groups (``tile // per`` of ``per`` indices
    each, from u * tile) cover each of [0, total) exactly once, the
    indices past ``total`` masked as the kernels mask them, with no tile
    wholly past it."""
    idx = (np.arange(tiles)[:, None, None] * tile
           + np.arange(tile // per)[None, :, None] * per
           + np.arange(per)[None, None, :]).ravel()
    idx = idx[idx < total]
    return (tile % per == 0 and (tiles - 1) * tile < total
            and np.array_equal(np.sort(idx), np.arange(total)))


@pytest.mark.parametrize("kb", [1, 16, 128, 1024])
@pytest.mark.parametrize("d", [1, 5, 24, 64, 255])
def test_geometry_fits_and_covers_every_event_and_slot_once(d, kb):
    """``score_geometry`` on csrc/score.cu's constants: its shared bytes
    (the x tile in double, mu's rows in the centered form, the ring) are
    at most 232,448; the logp CTAs' register tiles cover every event and
    every slot once, the ring every A_ext row, the scan CTAs every event;
    a 64-row request at Kb 128 launches at least 32 logp CTAs."""
    for n, diag, centered, itemsize in itertools.product(
            (1, 64, 4097, 65536), (False, True), (False, True), (4, 8)):
        geo = s1.score_geometry(n, d, kb, diag, centered, itemsize)
        t = d if diag else d * (d + 1) // 2
        a_rows = t if centered else t + d
        assert geo.smem <= s1.SMEM_MAX == 232448
        assert geo.smem == (8 * d * geo.ev
                            + (8 * d * geo.kt if centered else 0)
                            + itemsize * geo.stages * geo.rows * geo.kt)
        assert 1 <= geo.scan_ev <= s1.SCAN_EV
        assert geo.scan_ev * (kb + 1) * itemsize <= s1.SCAN_SMEM
        tl = geo.tile
        assert tl in s1.TILES[:2] or (tl == s1.TILES[2]
                                      and not (centered or diag))
        # ev a multiple of tile^2 keeps each thread's ring column fixed
        assert s1.MIN_EV <= geo.ev <= s1.MAX_EV and geo.ev % (tl * tl) == 0
        assert geo.threads <= 1024
        assert tl <= geo.kt <= s1.MAX_KT and geo.kt % tl == 0
        assert 1 <= geo.rows <= min(s1.RING_ROWS, a_rows)
        assert 2 <= geo.stages <= s1.STAGES
        assert geo.threads == (geo.ev // tl) * (geo.kt // tl) <= (
            s1.MAX_EV // tl) * (s1.MAX_KT // tl)
        assert _once(geo.grid[0], geo.ev, tl, n)
        assert _once(geo.grid[1], geo.kt, tl, kb)
        chunks = -(-a_rows // geo.rows)
        assert _once(chunks, geo.rows, 1, a_rows)
        assert _once(geo.scan_grid, geo.scan_ev, 1, n)
        if n == 64 and kb == 128:
            assert geo.grid[0] * geo.grid[1] >= 32
        if n == 65536 and kb >= 128 and d <= 64 and not (centered or diag):
            assert tl == s1.TILES[2]  # large requests take the wide tile
