"""K2/K4's plain versions -- the whole M-step, the guarded update and the
Cholesky constants -- against the JAX package on CPU, at small shapes.

Every case holds the guards the kernel is held to on the card: an empty cluster
(Nk = 0), a dead-zone one (Nk = 0.7), a covariance that is not positive
definite (an M2 whose guarded update has a negative eigenvalue), a NaN in
M2 (below the diagonal, where a lower Cholesky factorization reads it) and
an inactive cluster.

Tolerances. At float32 the reference is JAX's ``fused_mstep_pallas`` in
interpret mode followed by JAX's ``compute_constants``: N, means, R and pi
within 1e-6, ``ok`` equal. Rinv and constant come from two float32
Cholesky factorizations (LAPACK through torch, XLA's through JAX), which
differ by ~cond(R) x 2^-24: a cluster of these cases with cond(R) = 89 is
2.4e-6 normwise from float64 in the port and 8.6e-7 in JAX, 1.8e-5 apart
in absolute terms. So they are held to the class of
tests/test_torch_ops.py::test_apply_mstep_matches_jax (rtol 1e-5, atol
1e-5 x max(1, max|ref|)). At float64 the Pallas kernel's wrapper, which
casts to float32 whatever the state's dtype, is replaced by the kernel's
math (``_mstep_math``) run at float64, followed by ``compute_constants``,
and every field is held at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops import constants as j_constants
from cuda_gmm_mpi_tpu.ops import mstep as j_mstep
from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import (
    _mstep_math, fused_mstep_pallas,
)
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, apply_mstep
from cuda_gmm_mpi_tpu_torch.state import lane, stack_states

from .test_torch_ops import make_state_np, to_jax

FIELDS = ("N", "means", "R", "Rinv", "constant", "pi")
F32_TIGHT = ("N", "means", "R", "pi")
EMPTY, DEAD, NON_PD, NAN = 0, 1, 2, 3  # the forced clusters; the last is inactive
SHAPES = [(8, 4), (12, 6)]  # (K, D)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def guard_case(rng, k, d, diag, np_dtype):
    """(state dict, stats dict) with the forced clusters above."""
    s = make_state_np(rng, k, d, np_dtype, inactive=(k - 1,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(2, 96, d)).astype(np_dtype)
    st = j_mstep.accumulate_stats(to_jax(s), jnp.asarray(chunks), None,
                                  diag_only=diag)
    nk = np.array(st.Nk)
    m1, m2 = np.array(st.M1), np.array(st.M2)
    nk[EMPTY], nk[DEAD] = 0.0, 0.7
    mu = m1[NON_PD] / nk[NON_PD]
    if diag:
        m2[NON_PD] = nk[NON_PD] * (mu * mu)
        m2[NON_PD, 0] -= nk[NON_PD]  # variance -1 + avgvar / Nk < 0
        m2[NAN, 1] = np.nan
    else:
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lam = np.ones(d)
        lam[-1] = -1.0  # the update's eigenvalues ~ lam + avgvar / Nk
        m2[NON_PD] = nk[NON_PD] * (np.outer(mu, mu) + (q * lam) @ q.T)
        m2[NAN, 3, 1] = np.nan
    return s, dict(loglik=np.asarray(st.loglik), Nk=nk, M1=m1, M2=m2)


def torch_stats(stats, dtype):
    return SuffStats(**{k: torch.tensor(v, dtype=dtype)
                        for k, v in stats.items()})


def plain_out(s, stats, diag, dtype):
    """mstep_plain's outputs on the case."""
    state = state_from_numpy(s)
    ops = fs._mstep_operands(state, torch_stats(stats, dtype), diag)
    return fs.mstep_plain(*ops, diag=diag)


def jax_update(s, stats, diag, dtype_name):
    """JAX's updated state (N, means, R) before the constants."""
    js = to_jax(s)
    if dtype_name == "float32":
        jstats = j_mstep.SuffStats(**{n: jnp.asarray(v)
                                      for n, v in stats.items()})
        return fused_mstep_pallas(js, jstats, diag_only=diag, interpret=True)
    k, d = stats["M1"].shape
    col = lambda v: jnp.asarray(v)[:, None]
    n, mean, cov = _mstep_math(
        col(stats["Nk"]), jnp.asarray(stats["M1"]),
        jnp.asarray(stats["M2"].reshape(k, -1)), col(s["avgvar"]),
        col(s["active"].astype(np.float64)), diag)
    R = (jnp.einsum("kd,de->kde", cov, jnp.eye(d)) if diag
         else cov.reshape(k, d, d))
    return js.replace(N=n[:, 0], means=mean, R=R)


def close(ours, ref, rtol, scaled=True, name=""):
    ref = np.asarray(ref)
    atol = rtol * max(1.0, float(np.abs(ref).max())) if scaled else rtol
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=rtol, atol=atol,
                               err_msg=name)


def f32_close(name, ours, ref):
    """A float32 M-step field against JAX's (the module docstring's rule)."""
    if name in F32_TIGHT:
        close(ours, ref, 1e-6, scaled=False, name=name)
    else:
        close(ours, ref, 1e-5, name=name)


@pytest.mark.parametrize("k,d", SHAPES)
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mstep_plain_matches_jax(rng, k, d, diag, dtype_name):
    np_dtype, dtype = DTYPES[dtype_name]
    s, stats = guard_case(rng, k, d, diag, np_dtype)
    out = dict(zip(FIELDS + ("ok",), plain_out(s, stats, diag, dtype)))
    updated = jax_update(s, stats, diag, dtype_name)
    _, _, ok = j_constants.chol_inverse_logdet(updated.R, diag_only=diag)
    theirs = j_constants.compute_constants(updated, diag_only=diag)
    np.testing.assert_array_equal(out["ok"].numpy(), np.asarray(ok))
    assert not out["ok"][NON_PD] and not out["ok"][NAN]
    assert bool(out["ok"][[EMPTY, DEAD, k - 1]].all())
    for name in FIELDS:
        ref = np.asarray(getattr(theirs, name))
        if dtype_name == "float64":
            close(out[name], ref, 1e-12, name=name)
        else:
            f32_close(name, out[name], ref)
    eye = np.eye(d)
    for c in (EMPTY, NON_PD, NAN, k - 1):
        np.testing.assert_array_equal(out["R"][c].numpy(), eye)
    np.testing.assert_array_equal(out["Rinv"][k - 1].numpy(), eye)
    assert float(out["pi"][k - 1]) == float(np.asarray(1e-10, np_dtype))


@pytest.mark.parametrize("k,d", SHAPES)
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mstep_plain_equals_apply_mstep(rng, k, d, diag, dtype_name):
    """The plain version is the port's torch-ops M-step bit for bit."""
    np_dtype, dtype = DTYPES[dtype_name]
    s, stats = guard_case(rng, k, d, diag, np_dtype)
    out = plain_out(s, stats, diag, dtype)
    ref = apply_mstep(state_from_numpy(s), torch_stats(stats, dtype),
                      diag_only=diag)
    for name, a in zip(FIELDS, out):
        assert torch.equal(a, getattr(ref, name)), name


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_mstep_batched_plain_lanes_equal_unbatched(rng, diag):
    """Each lane of K4's plain version (R = 3) is K2's plain version on
    that lane's operands, and the batched hook's state is apply_mstep's."""
    k, d = 10, 5
    cases = [guard_case(rng, k, d, diag, np.float32) for _ in range(3)]
    states = stack_states([state_from_numpy(s) for s, _ in cases])
    stats = stack_states([torch_stats(st, torch.float32) for _, st in cases])
    ops = fs._mstep_operands(states, stats, diag)
    out = fs.mstep_batched(*ops, diag=diag)
    new = fs.fused_mstep_cuda_batched(states, stats, diag_only=diag)
    for r in range(3):
        one = fs.mstep(*(o[r] for o in ops), diag=diag)
        for a, b in zip(out, one):
            assert torch.equal(a[r], b)
        ref = apply_mstep(lane(states, r), lane(stats, r), diag_only=diag)
        for name in FIELDS:
            assert torch.equal(getattr(new, name)[r], getattr(ref, name)), name
