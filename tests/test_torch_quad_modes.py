"""The port's quadratic forms 'packed' and 'centered', the feature hoist
(``precompute_features``) and their routing, against the JAX package on CPU.

Tolerances: float64 to 1e-12 relative (the float64 class of
tests/test_torch_ops.py); float32 to the tests/test_pallas.py class
(loglik 1e-5, Nk 1e-5, M1 1e-4, M2 1e-4 + 1e-3), the reassociation error of
two float32 implementations. The hoisted features are the inline path's
own values, held to 1e-12 at float64 and 1e-6 relative at float32 (not to
bit-identity: the JAX package's own bit-identity test of its hoist fails
in this repository's runs).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.gmm import GMMModel as JModel
from cuda_gmm_mpi_tpu.ops import estep as j_estep
from cuda_gmm_mpi_tpu.ops import mstep as j_mstep
from cuda_gmm_mpi_tpu.ops.seeding import seed_clusters_host
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import (
    GMMModel, chunk_events, em_while_loop,
)
from cuda_gmm_mpi_tpu_torch.ops import estep as t_estep
from cuda_gmm_mpi_tpu_torch.ops import mstep as t_mstep
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.ops.kernels import resolve_estep_backend

from .conftest import make_blobs
from .test_torch_ops import DTYPES, assert_stats, close, make_state_np, to_jax

MODES = ["packed", "centered"]


def test_packing_helpers_match_jax(rng):
    x = rng.normal(size=(7, 5))
    A = rng.normal(size=(3, 5, 5))
    A = A + np.transpose(A, (0, 2, 1))
    np.testing.assert_array_equal(
        t_estep.pack_features(torch.as_tensor(x)).numpy(),
        np.asarray(j_estep.pack_features(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_estep.pack_sym_weighted(torch.as_tensor(A)).numpy(),
        np.asarray(j_estep.pack_sym_weighted(jnp.asarray(A))))
    P = rng.normal(size=(3, 15))
    np.testing.assert_array_equal(
        t_estep.unpack_sym(torch.as_tensor(P), 5).numpy(),
        np.asarray(j_estep.unpack_sym(jnp.asarray(P), 5)))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("mode", MODES)
def test_log_densities_and_posteriors_match_jax(rng, mode, diag, dtype_name):
    dtype, tol = DTYPES[dtype_name]
    s = make_state_np(rng, 5, 4, dtype, inactive=(1,), diag=diag)
    x = rng.normal(scale=2.0, size=(64, 4)).astype(dtype)
    kw = dict(diag_only=diag, quad_mode=mode)
    lp = t_estep.log_densities(state_from_numpy(s), torch.as_tensor(x),
                               **kw).numpy()
    jlp = np.asarray(j_estep.log_densities(to_jax(s), jnp.asarray(x), **kw))
    live = np.isfinite(jlp)
    assert (np.isfinite(lp) == live).all()
    w, logz = t_estep.posteriors(state_from_numpy(s), torch.as_tensor(x),
                                 **kw)
    jw, jlogz = j_estep.posteriors(to_jax(s), jnp.asarray(x), **kw)
    rtol = tol or 1e-5
    close(lp[live], jlp[live], rtol, rtol * np.abs(jlp[live]).max(), "logp")
    close(logz.numpy(), jlogz, rtol, 0.0, "logZ")
    close(w.numpy(), jw, rtol, tol or 1e-6, "w")


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("mode", MODES)
def test_accumulate_stats_matches_jax(rng, mode, diag, dtype_name):
    dtype, _ = DTYPES[dtype_name]
    s = make_state_np(rng, 5, 4, dtype, inactive=(3,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(3, 48, 4)).astype(dtype)
    wts = np.ones((3, 48), dtype)
    wts[-1, 30:] = 0.0
    kw = dict(diag_only=diag, quad_mode=mode)
    ours = t_mstep.accumulate_stats(state_from_numpy(s),
                                    torch.as_tensor(chunks),
                                    torch.as_tensor(wts), **kw)
    theirs = j_mstep.accumulate_stats(to_jax(s), jnp.asarray(chunks),
                                      jnp.asarray(wts), **kw)
    assert_stats(ours, theirs, dtype_name)
    if not diag:  # a packed M2 is mirrored from one value: exactly symmetric
        assert torch.equal(ours.M2, ours.M2.transpose(1, 2))


@pytest.mark.parametrize("mode", MODES)
def test_em_loop_matches_jax_float64(rng, mode):
    """The EM loop in each quad mode at float64 against the JAX loop: the
    same iteration count, loglik, means and R to rtol 1e-9 (the EM-loop
    class of tests/test_torch_em.py)."""
    data, _ = make_blobs(rng, n=600, d=3, k=3, dtype=np.float64)
    chunks, wts = chunk_events(data, 128)
    jstate = seed_clusters_host(data, 4)
    eps = convergence_epsilon(*data.shape)
    kw = dict(min_iters=3, max_iters=40, dtype="float64", chunk_size=128,
              quad_mode=mode)
    j_state, j_ll, j_iters = JModel(JConfig(**kw)).run_em(
        jstate, jnp.asarray(chunks), jnp.asarray(wts), eps)
    t_state, t_ll, t_iters = GMMModel(GMMConfig(device="cpu", **kw)).run_em(
        state_from_numpy(jstate), torch.as_tensor(chunks),
        torch.as_tensor(wts), eps)
    assert t_iters == int(j_iters)
    np.testing.assert_allclose(t_ll, float(j_ll), rtol=1e-9)
    ours = state_to_numpy(t_state)
    for name in ("means", "R"):
        np.testing.assert_allclose(ours[name], np.asarray(getattr(j_state, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("dtype_name,rtol", [("float64", 1e-12),
                                              ("float32", 1e-6)])
@pytest.mark.parametrize("mode", ["expanded", "packed"])
def test_feature_hoist_matches_inline(rng, mode, dtype_name, rtol):
    """em_while_loop with precompute_features (the [C, B, F] features built
    once) against the inline path: the same iterations, loglik, means and
    R to the stated tolerance."""
    dtype = DTYPES[dtype_name][0]
    data, _ = make_blobs(rng, n=500, d=3, k=3, dtype=dtype)
    chunks, wts = (torch.as_tensor(a) for a in chunk_events(data, 128))
    state = state_from_numpy(seed_clusters_host(data.astype(np.float64), 4))
    state = state.replace(**{f: getattr(state, f).to(chunks.dtype)
                             for f in ("N", "pi", "constant", "avgvar",
                                       "means", "R", "Rinv")})
    eps = convergence_epsilon(*data.shape)
    run = functools.partial(em_while_loop, state, chunks, wts, eps, 2, 30,
                            quad_mode=mode)
    s0, ll0, it0 = run()
    s1, ll1, it1 = run(precompute_features=True)
    assert it0 == it1
    np.testing.assert_allclose(ll1, ll0, rtol=rtol)
    for name in ("means", "R"):
        np.testing.assert_allclose(getattr(s1, name).numpy(),
                                   getattr(s0, name).numpy(), rtol=rtol,
                                   atol=rtol, err_msg=name)


def test_feature_hoist_fit_matches_inline():
    """fit_gmm (main path and batched restarts) with precompute_features
    against the same fits without: the same K and merge pairs, final
    loglik within 1e-6."""
    data, _ = make_blobs(np.random.default_rng(5), n=400, d=3, k=3,
                         dtype=np.float32)
    kw = dict(device="cpu", min_iters=3, max_iters=3, chunk_size=128)
    for extra in ({}, {"n_init": 2, "restart_batch_size": 2}):
        a = fit_gmm(data, 5, 2, config=GMMConfig(**kw, **extra))
        b = fit_gmm(data, 5, 2, config=GMMConfig(precompute_features=True,
                                                 **kw, **extra))
        assert a.ideal_num_clusters == b.ideal_num_clusters
        assert [m[1] for m in a.merges] == [m[1] for m in b.merges]
        np.testing.assert_allclose(b.final_loglik, a.final_loglik, rtol=1e-6)


@pytest.mark.parametrize("kw,msg", [
    (dict(diag_only=True), "full-covariance"),
    (dict(quad_mode="centered"), "expanded"),
    (dict(estep_backend="cuda"), "CUDA kernels"),
], ids=["diag", "centered", "cuda"])
def test_precompute_features_guards(kw, msg):
    """The JAX package's guards (config.py:437-456); 'cuda' stands in for
    its use_pallas='always'."""
    with pytest.raises(ValueError, match=msg):
        GMMConfig(precompute_features=True, **kw)
    with pytest.raises(ValueError, match="quad_mode"):
        GMMConfig(quad_mode="triangular")
    if "estep_backend" not in kw:  # the JAX package raises alike
        with pytest.raises(ValueError):
            JConfig(precompute_features=True, **kw)


def test_routing_of_quad_modes_and_precisions():
    """'centered' (full covariance) routes to torch ops with its reason under
    'auto' and raises under 'cuda'; 'packed' and every precision stay on the
    kernels; diag ignores the quad mode, as the torch-ops diag path does."""
    cuda = functools.partial(GMMConfig, device="cuda")
    backend, reason = resolve_estep_backend(cuda(quad_mode="centered"))
    assert backend == "torch" and "centered" in reason
    with pytest.raises(ValueError, match="centered"):
        resolve_estep_backend(cuda(quad_mode="centered", estep_backend="cuda"))
    assert resolve_estep_backend(cuda(quad_mode="packed"))[0] == "cuda"
    assert resolve_estep_backend(cuda(quad_mode="centered",
                                      diag_only=True))[0] == "cuda"
    for prec in ("high", "default"):
        assert resolve_estep_backend(cuda(matmul_precision=prec))[0] == "cuda"
