"""Weighted events in the port, against replicated rows and the JAX
package, on the CPU (tests/test_sample_weight.py's cases, less its
fused-sweep one, which waits for the fused sweep's port).

The weights replace the 0/1 mask of the events' weight row, and every
statistic multiplies the posteriors and the log-evidence by it, so an
integer weight w equals w copies of the event: the whole EM trajectory
matches a fit on the replicated rows (the init pinned with ``init_means``;
``covariance_dynamic_range=1e30`` takes the avgvar loading, which is seeded
from the unweighted variance, out of the comparison).
"""

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import GaussianMixture as JGaussianMixture
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.validation import InvalidInputError

from .conftest import make_blobs

EXACT = dict(dtype="float64", center_data=False,
             covariance_dynamic_range=1e30)


@pytest.mark.parametrize("cov_type", ["full", "diag", "spherical", "tied"])
def test_integer_weights_equal_replication(rng, cov_type):
    k, d, n = 3, 3, 500
    centers = rng.normal(scale=8.0, size=(k, d))
    data = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    w = rng.integers(0, 4, size=n).astype(np.float64)
    kw = dict(min_iters=6, max_iters=6, chunk_size=128, device="cpu",
              covariance_type=cov_type, **EXACT)
    gw = GaussianMixture(k, target_components=k, means_init=centers,
                         **kw).fit(data, sample_weight=w)
    gr = GaussianMixture(k, target_components=k, means_init=centers,
                         **kw).fit(np.repeat(data, w.astype(int), axis=0))
    np.testing.assert_allclose(gw.weights_, gr.weights_, rtol=1e-10)
    np.testing.assert_allclose(gw.means_, gr.means_, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(gw.covariances_, gr.covariances_, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(gw.loglik_, gr.loglik_, rtol=1e-10)


def test_weighted_fit_matches_jax(rng):
    """A weighted sweep (K 4 -> 2, fractional weights) against the JAX
    package's: the same K and scores, parameters to 1e-12."""
    data, _ = make_blobs(rng, n=300, d=2, k=2, dtype=np.float64)
    w = rng.uniform(0.2, 3.0, size=len(data))
    kw = dict(min_iters=3, max_iters=3, chunk_size=64, dtype="float64")
    jr = j_fit(data, 4, 2, config=JConfig(**kw), sample_weight=w)
    tr = fit_gmm(data, 4, 2, config=GMMConfig(device="cpu", **kw),
                 sample_weight=w)
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    np.testing.assert_allclose(tr.final_loglik, jr.final_loglik, rtol=1e-12)
    np.testing.assert_allclose([r[2] for r in tr.sweep_log],
                               [r[2] for r in jr.sweep_log], rtol=1e-12)
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tr.covariances, jr.covariances, rtol=1e-12,
                               atol=1e-12)


def test_weighted_loglik_matches_replication(rng):
    data, _ = make_blobs(rng, n=300, d=2, k=2, dtype=np.float64)
    w = rng.integers(1, 3, size=len(data)).astype(np.float64)
    cfg = GMMConfig(device="cpu", min_iters=3, max_iters=3, chunk_size=64,
                    **EXACT)
    centers = data[:2]
    rw = fit_gmm(data, 2, 2, cfg, init_means=centers, sample_weight=w)
    rr = fit_gmm(np.repeat(data, w.astype(int), axis=0), 2, 2, cfg,
                 init_means=centers)
    np.testing.assert_allclose(rw.final_loglik, rr.final_loglik, rtol=1e-10)


def test_sample_weight_validation(rng):
    """The JAX package's checks and exception types."""
    data, _ = make_blobs(rng, n=100, d=2, k=2, dtype=np.float64)
    cfg = GMMConfig(device="cpu", min_iters=1, max_iters=1, chunk_size=64,
                    dtype="float64")
    jcfg = JConfig(min_iters=1, max_iters=1, chunk_size=64, dtype="float64")
    bad = np.ones(len(data))
    bad[3] = np.nan
    cases = [(np.ones(7), ValueError, "sample_weight must be"),
             (np.full(len(data), -1.0), InvalidInputError, "nonnegative"),
             (bad, InvalidInputError, "finite"),
             (np.full(len(data), 1.0 / len(data)), InvalidInputError,
              "multiplicities")]
    for w, exc, match in cases:
        with pytest.raises(exc, match=match):
            fit_gmm(data, 2, 2, cfg, sample_weight=w)
        with pytest.raises(ValueError, match=match):
            j_fit(data, 2, 2, jcfg, sample_weight=w)
    with pytest.raises(ValueError, match="sample_weight must be"):
        chunk_events(data, 64, sample_weight=np.ones(3))


def test_fractional_weights_scale_statistics(rng):
    """Halving every weight leaves the fixed point where it was."""
    data, _ = make_blobs(rng, n=400, d=2, k=2, dtype=np.float64)
    centers = data[:2]
    kw = dict(min_iters=5, max_iters=5, chunk_size=128, device="cpu", **EXACT)
    g1 = GaussianMixture(2, target_components=2, means_init=centers,
                         **kw).fit(data, sample_weight=np.ones(len(data)))
    gh = GaussianMixture(2, target_components=2, means_init=centers,
                         **kw).fit(data, sample_weight=np.full(len(data), 0.5))
    np.testing.assert_allclose(gh.means_, g1.means_, rtol=1e-9)
    np.testing.assert_allclose(gh.weights_, g1.weights_, rtol=1e-9)


def test_weighted_restarts_match_jax(rng, capsys):
    """``sample_weight`` on every restart lane of the batched path, and
    ``init_means`` on restart 0 only: the JAX package's scores per init,
    winner and fit. Two inits: on these blobs every k-means++ restart
    reaches one optimum, where a third init would tie the second to the
    last bits and leave the first-best rule's pick to rounding."""
    data, _ = make_blobs(rng, n=240, d=2, k=3, dtype=np.float64)
    w = rng.integers(1, 4, size=len(data)).astype(np.float64)
    centers = data[:3]
    kw = dict(min_iters=3, max_iters=3, chunk_size=64, dtype="float64",
              n_init=2, restart_batch_size=2, enable_print=True)
    inits = lambda out: [line for line in out.splitlines()
                         if line.startswith("init ") and ":" in line[:8]]
    jg = JGaussianMixture(3, 3, means_init=centers, **kw).fit(
        data, sample_weight=w)
    j_inits = inits(capsys.readouterr().out)
    tg = GaussianMixture(3, 3, means_init=centers, device="cpu", **kw).fit(
        data, sample_weight=w)
    assert inits(capsys.readouterr().out) == j_inits and len(j_inits) == 2
    assert j_inits[0] != j_inits[1]  # init 0 seeded from means_init
    assert tg.result_.init_index == jg.result_.init_index
    np.testing.assert_allclose(tg.loglik_, jg.loglik_, rtol=1e-12)
    np.testing.assert_allclose(tg.means_, jg.means_, rtol=1e-12, atol=1e-12)
