"""The port's EM loop against the JAX package's, on CPU.

At float64 both loops must run the same number of iterations and agree on
loglik, means and R to rtol 1e-9. That is looser than the single-op 1e-12 of
tests/test_torch_ops.py because a last-bit difference in one iteration is
carried and amplified through every later one.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.gmm import GMMModel as JModel
from cuda_gmm_mpi_tpu.models.gmm import chunk_events as j_chunk_events
from cuda_gmm_mpi_tpu.ops.pallas.fused_stats import fused_stats_pallas
from cuda_gmm_mpi_tpu.ops.seeding import seed_clusters_host
from cuda_gmm_mpi_tpu_torch import health
from cuda_gmm_mpi_tpu_torch.config import GMMConfig
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import GMMModel, chunk_events
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs

from .conftest import make_blobs


def _setup(rng, dtype, diag):
    data, _ = make_blobs(rng, n=600, d=3, k=3, dtype=dtype)
    chunks, wts = chunk_events(data, 128)
    np.testing.assert_array_equal(chunks, j_chunk_events(data, 128)[0])
    state = seed_clusters_host(data, 4)  # the JAX seeding: one shared state
    if diag:
        from cuda_gmm_mpi_tpu.ops.constants import compute_constants

        state = compute_constants(state, diag_only=True)
    return data, chunks, wts, state


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_em_loop_matches_jax_float64(rng, diag):
    data, chunks, wts, jstate = _setup(rng, np.float64, diag)
    eps = convergence_epsilon(*data.shape)
    kw = dict(min_iters=3, max_iters=40, dtype="float64", chunk_size=128,
              diag_only=diag)
    j_state, j_ll, j_iters = JModel(JConfig(**kw)).run_em(
        jstate, jnp.asarray(chunks), jnp.asarray(wts), eps)
    model = GMMModel(GMMConfig(device="cpu", **kw))
    assert model.estep_backend == "torch"
    t_state, t_ll, t_iters = model.run_em(
        state_from_numpy(jstate), torch.as_tensor(chunks),
        torch.as_tensor(wts), eps)
    assert t_iters == int(j_iters)
    assert 3 <= t_iters < 40  # converged between the bounds
    np.testing.assert_allclose(t_ll, float(j_ll), rtol=1e-9)
    ours = state_to_numpy(t_state)
    for name in ("means", "R", "N"):
        np.testing.assert_allclose(ours[name], np.asarray(getattr(j_state, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_em_loop_through_kernel_hooks_matches_pallas(rng, diag):
    """The EM loop with K1/K2 on its stats_fn/mstep_fn hooks (their plain
    versions on CPU) against the JAX loop on the Pallas kernel in interpret
    mode, float32, fixed 4 iterations (test_pallas.py's EM tolerance)."""
    data, chunks, wts, jstate = _setup(rng, np.float32, diag)
    eps = convergence_epsilon(*data.shape)
    cfg = JConfig(min_iters=4, max_iters=4, chunk_size=128, dtype="float32",
                  diag_only=diag)
    pallas = functools.partial(fused_stats_pallas, diag_only=diag, block_b=64,
                               interpret=True)
    j_state, j_ll, _ = JModel(cfg, stats_fn=pallas).run_em(
        jstate, jnp.asarray(chunks), jnp.asarray(wts), eps)

    model = GMMModel(
        GMMConfig(min_iters=4, max_iters=4, chunk_size=128, device="cpu",
                  diag_only=diag),
        stats_fn=functools.partial(fs.fused_stats_cuda, diag_only=diag),
        mstep_fn=functools.partial(fs.fused_mstep_cuda, diag_only=diag))
    t_state, t_ll, t_iters = model.run_em(
        state_from_numpy(jstate), torch.as_tensor(chunks),
        torch.as_tensor(wts), eps)
    assert t_iters == 4
    np.testing.assert_allclose(t_ll, float(j_ll), rtol=1e-4)
    np.testing.assert_allclose(state_to_numpy(t_state)["means"],
                               np.asarray(j_state.means), rtol=1e-3, atol=1e-3)


def test_fit_and_memberships_match_jax_float64(rng):
    """fit_gmm (sweep 5 -> 2) and the memberships recomputed from its
    result, against the JAX package on the same data."""
    from cuda_gmm_mpi_tpu.models.order_search import compute_memberships as j_memb
    from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
    from cuda_gmm_mpi_tpu_torch.models import compute_memberships, fit_gmm

    data, _ = make_blobs(rng, n=400, d=3, k=3, dtype=np.float32)
    kw = dict(min_iters=5, max_iters=5, dtype="float64", chunk_size=128)
    jr = j_fit(data, 5, 2, config=JConfig(**kw))
    cfg = GMMConfig(device="cpu", **kw)
    tr = fit_gmm(data, 5, 2, config=cfg)
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(compute_memberships(tr, data, cfg),
                               j_memb(jr, data, JConfig(**kw)),
                               rtol=1e-9, atol=1e-12)
    chunks, _ = chunk_events(data.astype(np.float64) - tr.data_shift, 128)
    w = tr.model.memberships(tr.state, torch.as_tensor(chunks))
    np.testing.assert_array_equal(w[:len(data)],
                                  compute_memberships(tr, data, cfg))


def test_stop_predicate_runs_on_through_nan(rng):
    """~(|change| <= eps): a NaN change never reads as converged. Since the
    health counters (health.py) the fatal nonfinite_loglik lane stops the
    loop at the iteration the NaN appears, as the JAX package's loop does,
    instead of iterating the poison to max_iters; the counters name it."""
    data, chunks, wts, jstate = _setup(rng, np.float64, False)
    calls = []

    def nan_stats(state, c, w):
        from cuda_gmm_mpi_tpu_torch.ops.mstep import accumulate_stats

        st = accumulate_stats(state, c, w)
        calls.append(1)
        return st if len(calls) == 1 else st.__class__(
            torch.tensor(float("nan"), dtype=torch.float64), st.Nk, st.M1, st.M2)

    model = GMMModel(GMMConfig(device="cpu", dtype="float64", min_iters=1,
                               max_iters=5, chunk_size=128),
                     stats_fn=nan_stats)
    _, ll, iters = model.run_em(state_from_numpy(jstate),
                                torch.as_tensor(chunks), torch.as_tensor(wts),
                                convergence_epsilon(*data.shape))
    assert iters == 1 and np.isnan(ll)
    assert model.last_health[health.NONFINITE_LOGLIK] == 1
    assert health.word_is_fatal(health.pack_word(model.last_health))
