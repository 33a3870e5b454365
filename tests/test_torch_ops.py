"""The port's torch-ops backend against the JAX package, op by op, on CPU.

Both packages get the same seeded inputs (numpy, through
``cuda_gmm_mpi_tpu_torch.interop``). Tolerances: float64 matches to 1e-12
relative (the float64 class of the reference's own tests); float32 to the
tests/test_pallas.py class (loglik 1e-5, Nk 1e-5, M1 1e-4, M2 1e-4 + 1e-3
absolute), the reassociation error of two float32 implementations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.ops import constants as j_constants
from cuda_gmm_mpi_tpu.ops import estep as j_estep
from cuda_gmm_mpi_tpu.ops import merge as j_merge
from cuda_gmm_mpi_tpu.ops import mstep as j_mstep
from cuda_gmm_mpi_tpu.ops import seeding as j_seeding
from cuda_gmm_mpi_tpu.state import GMMState as JState
from cuda_gmm_mpi_tpu.state import compact as j_compact
from cuda_gmm_mpi_tpu.state import compact_to as j_compact_to
from cuda_gmm_mpi_tpu.state import zeros_state as j_zeros_state
from cuda_gmm_mpi_tpu_torch.interop import FIELDS, state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.ops import constants as t_constants
from cuda_gmm_mpi_tpu_torch.ops import estep as t_estep
from cuda_gmm_mpi_tpu_torch.ops import formulas as t_formulas
from cuda_gmm_mpi_tpu_torch.ops import merge as t_merge
from cuda_gmm_mpi_tpu_torch.ops import mstep as t_mstep
from cuda_gmm_mpi_tpu_torch.ops import seeding as t_seeding
from cuda_gmm_mpi_tpu_torch.state import compact as t_compact
from cuda_gmm_mpi_tpu_torch.state import compact_to as t_compact_to
from cuda_gmm_mpi_tpu_torch.state import zeros_state as t_zeros_state

DTYPES = {"float64": (np.float64, 1e-12), "float32": (np.float32, None)}
F32_TOL = {"loglik": (1e-5, 0.0), "Nk": (1e-5, 1e-5), "M1": (1e-4, 1e-4),
           "M2": (1e-4, 1e-3)}


def make_state_np(rng, k, d, dtype=np.float64, inactive=(), diag=False):
    """A random well-conditioned state as a dict of numpy arrays."""
    a = rng.normal(size=(k, d, d)) * 0.3
    R = a @ np.transpose(a, (0, 2, 1)) + np.eye(d)
    if diag:
        R = np.stack([np.diag(np.diag(r)) for r in R])
    means = rng.normal(scale=3.0, size=(k, d))
    N = np.abs(rng.normal(size=k)) * 100 + 1
    active = np.ones(k, bool)
    active[list(inactive)] = False
    return dict(
        N=N.astype(dtype), pi=(N / N.sum()).astype(dtype),
        constant=(-d * 0.5 * np.log(2 * np.pi)
                  - 0.5 * np.linalg.slogdet(R)[1]).astype(dtype),
        avgvar=rng.uniform(0.01, 0.1, size=k).astype(dtype),
        means=means.astype(dtype), R=R.astype(dtype),
        Rinv=np.linalg.inv(R).astype(dtype), active=active)


def to_jax(d):
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def jax_to_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def close(ours, theirs, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=rtol, atol=atol, err_msg=name)


def assert_stats(ours, theirs, dtype_name, scale=1.0):
    for name in ("loglik", "Nk", "M1", "M2"):
        a = getattr(ours, name).numpy()
        b = np.asarray(getattr(theirs, name))
        if dtype_name == "float64":
            close(a, b, 1e-12, 1e-12 * scale * max(1.0, np.abs(b).max()), name)
        else:
            rtol, atol = F32_TOL[name]
            close(a, b, rtol, atol, name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_log_densities_and_posteriors_match_jax(rng, diag, dtype_name):
    dtype, _ = DTYPES[dtype_name]
    k, d, n = 5, 4, 200
    s = make_state_np(rng, k, d, dtype, inactive=(1,), diag=diag)
    x = rng.normal(scale=2.0, size=(n, d)).astype(dtype)
    lp_t = t_estep.log_densities(state_from_numpy(s), torch.as_tensor(x),
                                 diag_only=diag).numpy()
    lp_j = np.asarray(j_estep.log_densities(to_jax(s), jnp.asarray(x),
                                            diag_only=diag))
    assert np.array_equal(np.isneginf(lp_t), np.isneginf(lp_j))
    assert np.isneginf(lp_t[:, 1]).all()
    fin = np.isfinite(lp_j)
    rtol = 1e-12 if dtype_name == "float64" else 1e-5
    close(lp_t[fin], lp_j[fin], rtol, rtol * np.abs(lp_j[fin]).max())
    w_t, z_t = t_estep.posteriors(state_from_numpy(s), torch.as_tensor(x),
                                  diag_only=diag)
    w_j, z_j = j_estep.posteriors(to_jax(s), jnp.asarray(x), diag_only=diag)
    close(w_t.numpy(), w_j, rtol, rtol)
    close(z_t.numpy(), z_j, rtol, rtol * np.abs(np.asarray(z_j)).max())


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_accumulate_stats_matches_jax(rng, diag, dtype_name):
    dtype, _ = DTYPES[dtype_name]
    k, d, c, b = 6, 3, 4, 64
    s = make_state_np(rng, k, d, dtype, inactive=(2,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(c, b, d)).astype(dtype)
    wts = rng.uniform(0.5, 2.0, size=(c, b)).astype(dtype)
    wts[-1, 40:] = 0.0  # padded tail
    ours = t_mstep.accumulate_stats(state_from_numpy(s),
                                    torch.as_tensor(chunks),
                                    torch.as_tensor(wts), diag_only=diag)
    theirs = j_mstep.accumulate_stats(to_jax(s), jnp.asarray(chunks),
                                      jnp.asarray(wts), diag_only=diag)
    assert_stats(ours, theirs, dtype_name)
    assert float(ours.Nk[2]) == 0.0


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_apply_mstep_matches_jax(rng, diag, dtype_name):
    """Including the guards: an empty lane (Nk=0), one in the (0.5, 1) dead
    zone, an inactive slot, and a nonzero variance floor."""
    dtype, _ = DTYPES[dtype_name]
    k, d, c, b = 6, 4, 2, 128
    s = make_state_np(rng, k, d, dtype, inactive=(5,), diag=diag)
    chunks = rng.normal(scale=2.0, size=(c, b, d)).astype(dtype)
    st = j_mstep.accumulate_stats(to_jax(s), jnp.asarray(chunks), None,
                                  diag_only=diag)
    nk = np.asarray(st.Nk).copy()
    nk[3], nk[4] = 0.0, 0.7
    stats_np = dict(loglik=np.asarray(st.loglik), Nk=nk,
                    M1=np.asarray(st.M1), M2=np.asarray(st.M2))
    ours = t_mstep.apply_mstep(
        state_from_numpy(s),
        t_mstep.SuffStats(**{k_: torch.tensor(v) for k_, v in stats_np.items()}),
        diag_only=diag)
    theirs = j_mstep.apply_mstep(
        to_jax(s), j_mstep.SuffStats(**{k_: jnp.asarray(v)
                                        for k_, v in stats_np.items()}),
        diag_only=diag)
    o, t = state_to_numpy(ours), jax_to_numpy(theirs)
    rtol = 1e-12 if dtype_name == "float64" else 1e-5
    for name in ("N", "means", "R", "Rinv", "constant", "pi"):
        close(o[name], t[name], rtol, rtol * max(1.0, np.abs(t[name]).max()),
              name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_compute_constants_matches_jax(rng, diag):
    """Including a non-PD covariance (reset to identity) and N < 0.5."""
    k, d = 5, 4
    s = make_state_np(rng, k, d, inactive=(4,), diag=diag)
    s["R"][1] = -np.eye(d)  # not positive definite
    s["N"][2] = 0.3
    o = state_to_numpy(t_constants.compute_constants(state_from_numpy(s),
                                                     diag_only=diag))
    t = jax_to_numpy(j_constants.compute_constants(to_jax(s),
                                                   diag_only=diag))
    for name in ("R", "Rinv", "constant", "pi"):
        close(o[name], t[name], 1e-12, 1e-14, name)
    np.testing.assert_array_equal(o["R"][1], np.eye(d))
    assert o["pi"][2] == np.float64(1e-10)


def test_seeding_matches_jax(rng):
    """Even seeding (float32 index math) and the seeded state."""
    for n, k in ((1000, 7), (999_999, 100), (5, 1)):
        np.testing.assert_array_equal(
            t_seeding.seed_means_indices(n, k),
            np.asarray(j_seeding.seed_means_indices(n, k)))
    data = rng.normal(scale=3.0, size=(301, 5))
    ours = t_seeding.seed_clusters(torch.as_tensor(data), 6,
                                   num_clusters_padded=8)
    theirs = j_seeding.seed_clusters(jnp.asarray(data), 6,
                                     num_clusters_padded=8)
    o, t = state_to_numpy(ours), jax_to_numpy(theirs)
    for name in o:
        close(o[name], t[name], 1e-12, 1e-14, name)
    rows = data[:4]
    ours = t_seeding.seed_state_from_parts(rows, 301, 2.5, 4, dtype=np.float32)
    theirs = j_seeding.seed_state_from_parts(rows, 301, 2.5, 4,
                                             dtype=np.float32)
    o, t = state_to_numpy(ours), jax_to_numpy(theirs)
    for name in o:
        close(o[name], t[name], 1e-6, 1e-6, name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_merge_ops_match_jax(rng, diag):
    """Pair scan (row blocks smaller than K), first-minimum argmin, merge,
    and the fused eliminate-and-reduce with its compaction-stable pair."""
    k, d = 9, 3
    s = make_state_np(rng, k, d, inactive=(4,), diag=diag)
    s["N"][6] = 0.2  # eliminated as empty
    dist_t = t_merge.pairwise_merge_distances(state_from_numpy(s),
                                              diag_only=diag, row_block=4)
    dist_j = np.asarray(j_merge.pairwise_merge_distances(
        to_jax(s), diag_only=diag, row_block=4))
    assert np.array_equal(np.isinf(dist_t.numpy()), np.isinf(dist_j))
    fin = np.isfinite(dist_j)
    close(dist_t.numpy()[fin], dist_j[fin], 1e-12,
          1e-12 * np.abs(dist_j[fin]).max())
    assert t_merge.argmin_pair(dist_t) == tuple(
        int(v) for v in j_merge.argmin_pair(jnp.asarray(dist_j)))
    tie = torch.full((4, 4), torch.inf, dtype=torch.float64)
    tie[1, 3] = tie[2, 3] = 1.0
    assert t_merge.argmin_pair(tie) == (1, 3)

    new_t, k_t, d_t, pair_t = t_merge.eliminate_and_reduce(
        state_from_numpy(s), diag_only=diag)
    new_j, k_j, d_j, pair_j = j_merge.eliminate_and_reduce(to_jax(s),
                                                           diag_only=diag)
    assert k_t == int(k_j) == 7
    assert pair_t == tuple(int(v) for v in np.asarray(pair_j))
    close(d_t, float(d_j), 1e-12)
    o, t = state_to_numpy(new_t), jax_to_numpy(new_j)
    for name in o:
        close(o[name], t[name], 1e-12, 1e-12, name)


def test_compaction_matches_jax(rng):
    z_t = state_to_numpy(t_zeros_state(3, 2, dtype=torch.float64))
    z_j = jax_to_numpy(j_zeros_state(3, 2, dtype=jnp.float64))
    for name in z_t:
        np.testing.assert_array_equal(z_t[name], z_j[name])
    s = make_state_np(rng, 8, 3, inactive=(1, 4, 5))
    o, n_o = t_compact(state_from_numpy(s))
    t, n_t = j_compact(to_jax(s))
    assert n_o == n_t == 5
    for name, v in state_to_numpy(o).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(t, name)))
    o = state_to_numpy(t_compact_to(state_from_numpy(s), 6))
    t = j_compact_to(to_jax(s), 6)
    for name, v in o.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(t, name)))


def test_formulas_match_jax():
    from cuda_gmm_mpi_tpu.ops import formulas as j_formulas

    for n, d, k in ((2000, 5, 4), (1_000_000, 24, 96)):
        assert (t_formulas.convergence_epsilon(n, d)
                == j_formulas.convergence_epsilon(n, d))
        assert (t_formulas.rissanen_score(-1.5e4, k, n, d)
                == j_formulas.rissanen_score(-1.5e4, k, n, d))
