"""S1's centered form (csrc/score.cu, ``quad_mode='centered'``) on the CPU.

- Its plain version, ``score_plain(quad_mode='centered')``
  (``posteriors`` at 'highest'), against the JAX package's ``posteriors``
  in the centered mode, full and diag, float32 and float64: float64 to
  1e-12 relative; float32 w to 1e-5 absolute and logZ to 1e-6 of the
  magnitude of the summed terms (two float32 libraries order each sum
  differently).
- The centered operands evaluated in the kernel's own order (a numpy
  emulation of ``score_kernel<CENTERED>``: xc = x - mu per (event, slot),
  one term per (i <= j) in row-major order against A's triangle rows,
  accumulated in double, then logp = -0.5 acc + g) against a float64
  reference, on near blobs and on blobs at |x| ~ 170, where the centered
  form keeps what the expanded form loses to cancellation. This holds the
  operand layout the card reads: the doubled off-diagonal rows, mu in the
  last D rows, g = constant + ln pi and -inf for an inactive slot.
- Operands formed at the model's own K and then padded keep their bits at
  every K-bucket (the K-pad contract).
"""

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
    """score_kernel<CENTERED>'s arithmetic in numpy: the terms in the
    kernel's order, in double, then the max/sum/w in the model's dtype."""
    n, d = x.shape
    dt = x.dtype
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
