"""The port's ``GaussianMixture`` on the CPU: tests/test_estimator.py's
round trips (less the serving registry, which waits for the serving
slice), held against the JAX package's estimator where both run, plus:

- every covariance family at float64: the JAX estimator's K, merge pairs
  and fitted attributes to 1e-12;
- each of the four criteria picks the JAX package's K;
- ``sample()`` draws the JAX estimator's samples from the same parameters,
  carried across by ``interop.fitted_estimator``, and both score them alike;
- the scikit-learn oracle of tests/test_sklearn_oracle.py: with matched
  initialization and no regularization, the parameters after N EM
  iterations equal sklearn's for every family.
"""

import warnings

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import GaussianMixture as JGaussianMixture
from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig
from cuda_gmm_mpi_tpu_torch.interop import fitted_estimator, state_to_numpy
from cuda_gmm_mpi_tpu_torch.io.readers import read_summary
from cuda_gmm_mpi_tpu_torch.io.writers import write_summary
from cuda_gmm_mpi_tpu_torch.models.order_search import fit_gmm

from .conftest import make_blobs
from .test_torch_covariance_types import jax_fit_with_pairs

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(7)
    centers = rng.normal(scale=10.0, size=(3, 3))
    labels = rng.integers(0, 3, size=600)
    data = (centers[labels] + rng.normal(size=(600, 3))).astype(np.float32)
    gm = GaussianMixture(6, target_components=3, min_iters=12, max_iters=12,
                         chunk_size=128, **CPU)
    gm.fit(data)
    return gm, data, labels


def test_fit_attributes(fitted):
    gm, data, _ = fitted
    assert gm.n_components_ == 3
    assert gm.weights_.shape == (3,)
    np.testing.assert_allclose(gm.weights_.sum(), 1.0, rtol=1e-4)
    assert gm.means_.shape == (3, 3)
    assert gm.covariances_.shape == (3, 3, 3)
    assert np.isfinite(gm.loglik_) and np.isfinite(gm.rissanen_)


def test_predict_recovers_blobs(fitted):
    gm, data, labels = fitted
    pred = gm.predict(data)
    assert pred.shape == (600,)
    agree = sum(np.unique(pred[labels == c], return_counts=True)[1].max()
                for c in range(3))
    assert agree / len(labels) > 0.95


def test_from_summary_roundtrip(fitted, tmp_path):
    gm, data, _ = fitted
    path = str(tmp_path / "model.summary")
    write_summary(path, gm.result_)
    gm2 = GaussianMixture.from_summary(path, chunk_size=128, **CPU)
    assert gm2.n_components_ == gm.n_components_
    np.testing.assert_allclose(gm2.means_, gm.means_, atol=5e-4)
    np.testing.assert_allclose(gm2.weights_, gm.weights_, atol=1e-5)
    np.testing.assert_array_equal(gm2.predict(data), gm.predict(data))
    np.testing.assert_allclose(gm2.predict_proba(data),
                               gm.predict_proba(data), atol=5e-3)
    # The JAX estimator reads the same file into the same model.
    jg = JGaussianMixture.from_summary(path, chunk_size=128)
    np.testing.assert_allclose(gm2.predict_proba(data),
                               jg.predict_proba(data), rtol=1e-5, atol=1e-6)


def test_sklearn_params_interop(fitted):
    gm, _, _ = fitted
    clone = GaussianMixture(**gm.get_params())
    assert clone.n_components == gm.n_components
    assert clone.config == gm.config
    clone.set_params(n_components=4, min_iters=2, max_iters=2)
    assert clone.n_components == 4 and clone.config.min_iters == 2
    with pytest.raises(ValueError, match="unknown parameter"):
        clone.set_params(bogus=1)
    gd = GaussianMixture(3, covariance_type="diag", **CPU)
    gd.set_params(covariance_type="full")
    assert (gd.config.covariance_type, gd.config.diag_only) == ("full", False)
    gd.set_params(covariance_type="spherical")
    assert (gd.config.covariance_type, gd.config.diag_only) == (
        "spherical", True)
    gd.set_params(diag_only=False)
    assert (gd.config.covariance_type, gd.config.diag_only) == ("full", False)
    gd.set_params(diag_only=True)
    assert gd.config.covariance_type == "diag"


def test_from_summary_family_guards(fitted, tmp_path):
    """A model whose covariances break the requested family is refused:
    diag (off-diagonals), spherical (unequal variances), tied (clusters
    that differ); each family's own model loads under it."""
    gm, data, _ = fitted
    path = str(tmp_path / "full.summary")
    write_summary(path, gm.result_)
    with pytest.raises(ValueError, match="off-diagonals"):
        GaussianMixture.from_summary(path, diag_only=True, **CPU)
    with pytest.raises(ValueError, match="spherical"):
        GaussianMixture.from_summary(path, covariance_type="spherical", **CPU)
    with pytest.raises(ValueError, match="tied"):
        GaussianMixture.from_summary(path, covariance_type="tied", **CPU)
    for family in ("spherical", "tied"):
        own = GaussianMixture(2, target_components=2, covariance_type=family,
                              min_iters=5, max_iters=5, chunk_size=128,
                              **CPU).fit(data)
        fpath = str(tmp_path / f"{family}.summary")
        write_summary(fpath, own.result_)
        back = GaussianMixture.from_summary(fpath, covariance_type=family,
                                            **CPU)
        assert back.n_components_ == own.n_components_


def test_fit_predict_forwards_sample_weight(rng):
    centers = np.array([[-8.0, -8.0], [8.0, 8.0]])
    labels = rng.integers(0, 2, 400)
    X = (centers[labels] + rng.normal(size=(400, 2))).astype(np.float32)
    w = rng.uniform(0.1, 4.0, size=400).astype(np.float32)
    kw = dict(target_components=2, min_iters=8, max_iters=8, chunk_size=128,
              **CPU)
    ref = GaussianMixture(2, **kw).fit(X, sample_weight=w)
    gm = GaussianMixture(2, **kw)
    assert gm.fit_predict(X, sample_weight=w).shape == (400,)
    np.testing.assert_array_equal(gm.means_, ref.means_)
    unw = GaussianMixture(2, **kw).fit(X)
    assert np.abs(unw.means_ - gm.means_).max() > 0
    with pytest.warns(UserWarning, match="ignores y"):
        GaussianMixture(2, **kw).fit(X, labels)


def test_means_init(rng):
    centers = rng.normal(scale=8.0, size=(3, 4))
    data = centers[rng.integers(0, 3, 600)] + rng.normal(size=(600, 4))
    gm = GaussianMixture(3, target_components=3, means_init=centers,
                         min_iters=8, max_iters=8, chunk_size=128,
                         dtype="float64", **CPU).fit(data)
    np.testing.assert_allclose(gm.means_, centers, atol=0.5)
    with pytest.raises(ValueError, match="init_means"):
        fit_gmm(data, 3, 3, GMMConfig(min_iters=1, max_iters=1,
                                      chunk_size=128, dtype="float64", **CPU),
                init_means=centers[:2])


def test_read_summary_fuzz_no_crash(tmp_path, rng):
    p = tmp_path / "fuzz.summary"
    fragments = ["Cluster #0\n", "Probability: 0.5\n", "N: nope\n",
                 "Means: 1.0 2.0 \n", "R Matrix:\n", "1.0 0.0 \n",
                 "\n", "::::\n", "Probability: \n", "Means:\n",
                 "R Matrix:\nx y\n"]
    for _ in range(30):
        n = rng.integers(1, 8)
        p.write_text("".join(
            fragments[i] for i in rng.integers(0, len(fragments), n)))
        try:
            read_summary(str(p))
        except ValueError:
            pass


def test_from_summary_malformed(tmp_path):
    p = tmp_path / "bad.summary"
    p.write_text("this is not a model\n")
    with pytest.raises(ValueError, match="well-formed"):
        read_summary(str(p))
    p.write_text("Cluster #0\nProbability: 0.5\nN: 10.0\n"
                 "Means: 1.000 2.000 \n\nR Matrix:\n1.000 0.000 \n")
    with pytest.raises(ValueError, match="R blocks"):
        read_summary(str(p))


def test_fit_predict_and_n_iter(fitted):
    gm, data, _ = fitted
    assert gm.n_iter_ == 12
    gm2 = GaussianMixture(3, target_components=3, min_iters=6, max_iters=6,
                          chunk_size=128, **CPU)
    pred = gm2.fit_predict(data)
    assert pred.shape == (len(data),)
    np.testing.assert_array_equal(pred, gm2.predict(data))


def test_predict_proba_normalized(fitted):
    gm, data, _ = fitted
    w = gm.predict_proba(data[:100])
    assert w.shape == (100, 3)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-4)


def test_score_samples_matches_loglik(fitted):
    gm, data, _ = fitted
    z = gm.score_samples(data)
    np.testing.assert_allclose(z.sum(), gm.loglik_, rtol=1e-4)
    assert gm.score(data) == pytest.approx(z.mean(), rel=1e-6)


def test_sample_statistics(fitted):
    gm, _, _ = fitted
    xs, ys = gm.sample(20000, seed=0)
    assert xs.shape == (20000, 3) and ys.shape == (20000,)
    assert ys.min() >= 0 and ys.max() < gm.n_components_
    global_mean = (gm.weights_[:, None] * gm.means_).sum(axis=0)
    np.testing.assert_allclose(xs.mean(axis=0), global_mean, atol=0.2)
    for c in range(gm.n_components_):
        if (ys == c).sum() > 1000:
            np.testing.assert_allclose(xs[ys == c].mean(axis=0),
                                       gm.means_[c], atol=0.3)


def test_sample_equals_jax_on_carried_parameters(fitted):
    """A JAX fit's parameters carried across by ``interop``: both
    estimators draw the same samples from the same seed and give them the
    same memberships and log evidence."""
    _, data, _ = fitted
    jg = JGaussianMixture(4, target_components=3, min_iters=6, max_iters=6,
                          chunk_size=128, dtype="float64").fit(
        data.astype(np.float64))
    tg = fitted_estimator(jg.result_.state, jg.result_.data_shift,
                          dtype="float64", chunk_size=128, **CPU)
    assert tg.n_components_ == jg.n_components_ == 3
    xs, ys = tg.sample(5000, seed=3)
    jxs, jys = jg.sample(5000, seed=3)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    np.testing.assert_allclose(tg.score_samples(xs), jg.score_samples(xs),
                               rtol=1e-12)
    np.testing.assert_allclose(tg.predict_proba(xs), jg.predict_proba(xs),
                               rtol=1e-10, atol=1e-12)
    back = state_to_numpy(tg.result_.state)
    np.testing.assert_array_equal(back["R"], np.asarray(jg.result_.state.R))


def test_order_search_selects_k():
    data, _ = make_blobs(np.random.default_rng(3), n=800, d=2, k=3,
                         dtype=np.float32)
    gm = GaussianMixture(6, min_iters=10, max_iters=10, chunk_size=256,
                         **CPU).fit(data)
    assert 1 <= gm.n_components_ <= 6
    assert len(gm.result_.sweep_log) > 1


def test_unfitted_raises():
    with pytest.raises(RuntimeError):
        GaussianMixture(2, **CPU).predict(np.zeros((4, 2), np.float32))


def test_config_exclusivity():
    with pytest.raises(ValueError):
        GaussianMixture(2, config=GMMConfig(), min_iters=5)


def test_default_device_is_the_card():
    assert GaussianMixture(2).config.device == "cuda"


def test_bic_aic(fitted):
    from cuda_gmm_mpi_tpu_torch.ops.formulas import n_free_params

    gm, data, _ = fitted
    n, d = data.shape
    ll = float(np.sum(gm.score_samples(data)))
    p = n_free_params(gm.n_components_, d)
    np.testing.assert_allclose(gm.bic(data), -2 * ll + p * np.log(n),
                               rtol=1e-12)
    np.testing.assert_allclose(gm.aic(data), -2 * ll + 2 * p, rtol=1e-12)
    gm1 = GaussianMixture(1, 1, config=gm.config).fit(data)
    assert gm1.bic(data) > gm.bic(data)


def test_bic_counts_diagonal_params(fitted):
    from cuda_gmm_mpi_tpu_torch.ops.formulas import n_free_params

    _, data, _ = fitted
    n, d = data.shape
    gm = GaussianMixture(3, 3, min_iters=6, max_iters=6, chunk_size=128,
                         diag_only=True, **CPU).fit(data)
    ll = float(np.sum(gm.score_samples(data)))
    p = n_free_params(3, d, diag_only=True)
    assert p == 3 * (1 + 2 * d) - 1
    np.testing.assert_allclose(gm.bic(data), -2 * ll + p * np.log(n),
                               rtol=1e-12)


@pytest.mark.parametrize("ct", ["full", "diag", "spherical", "tied"])
def test_families_match_jax_estimator(tmp_path, ct):
    """float64, K 6 -> 3: the JAX estimator's K, merge pairs and fitted
    attributes to 1e-12; inference on new rows too."""
    data, _ = make_blobs(np.random.default_rng(41), n=600, d=3, k=3,
                         dtype=np.float64)
    kw = dict(covariance_type=ct, min_iters=6, max_iters=6, chunk_size=128,
              dtype="float64")
    jr, pairs = jax_fit_with_pairs(tmp_path, data, 6, 3, **kw)
    jg = JGaussianMixture(6, 3, **kw)
    jg.result_, jg._model = jr, jr.model
    tg = GaussianMixture(6, 3, **kw, **CPU).fit(data)
    assert tg.n_components_ == jg.n_components_
    assert [m[1] for m in tg.result_.merges] == pairs
    assert tg.n_iter_ == jg.n_iter_
    for attr in ("weights_", "means_", "covariances_", "rissanen_",
                 "loglik_"):
        np.testing.assert_allclose(getattr(tg, attr), getattr(jg, attr),
                                   rtol=1e-12, atol=1e-12, err_msg=attr)
    new = data[::7] + 0.25
    np.testing.assert_allclose(tg.predict_proba(new), jg.predict_proba(new),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tg.score_samples(new), jg.score_samples(new),
                               rtol=1e-12)
    np.testing.assert_allclose(tg.bic(new), jg.bic(new), rtol=1e-12)
    np.testing.assert_allclose(tg.aic(new), jg.aic(new), rtol=1e-12)


@pytest.mark.parametrize("criterion", ["rissanen", "bic", "aic", "aicc"])
def test_criteria_pick_jax_k(criterion):
    """The search down to K = 1 under each criterion: the JAX package's
    scores per K and its chosen K."""
    data, _ = make_blobs(np.random.default_rng(43), n=400, d=2, k=3,
                         dtype=np.float64)
    kw = dict(criterion=criterion, min_iters=5, max_iters=5, chunk_size=128,
              dtype="float64")
    jg = JGaussianMixture(6, **kw).fit(data)
    tg = GaussianMixture(6, **kw, **CPU).fit(data)
    assert tg.n_components_ == jg.n_components_
    np.testing.assert_allclose([r[2] for r in tg.result_.sweep_log],
                               [r[2] for r in jg.result_.sweep_log],
                               rtol=1e-12)
    np.testing.assert_allclose(tg.rissanen_, jg.rissanen_, rtol=1e-12)


def _sk_precisions_init(cov_type, k, d):
    return {"full": np.broadcast_to(np.eye(d), (k, d, d)).copy(),
            "tied": np.eye(d), "diag": np.ones((k, d)),
            "spherical": np.ones(k)}[cov_type]


def _sk_covariances(sk, cov_type, k, d):
    c = sk.covariances_
    if cov_type == "full":
        return c
    if cov_type == "tied":
        return np.broadcast_to(c, (k, d, d))
    if cov_type == "diag":
        return np.stack([np.diag(row) for row in c])
    return np.stack([np.eye(d) * v for v in c])


@pytest.mark.parametrize("cov_type", ["full", "diag", "spherical", "tied"])
def test_em_trajectory_matches_sklearn(rng, cov_type):
    sk_mixture = pytest.importorskip("sklearn.mixture")
    k, d, n, iters = 3, 4, 1500, 7
    centers = rng.normal(scale=6.0, size=(k, d))
    data = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    sk = sk_mixture.GaussianMixture(
        n_components=k, covariance_type=cov_type, max_iter=iters, tol=0.0,
        reg_covar=0.0, means_init=centers, weights_init=np.full(k, 1.0 / k),
        precisions_init=_sk_precisions_init(cov_type, k, d))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # tol=0 never "converges"
        sk.fit(data)
    gm = GaussianMixture(
        k, target_components=k, means_init=centers, covariance_type=cov_type,
        min_iters=iters, max_iters=iters, chunk_size=512, dtype="float64",
        covariance_dynamic_range=1e30, **CPU).fit(data)
    np.testing.assert_allclose(gm.weights_, sk.weights_, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(gm.means_, sk.means_, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(gm.covariances_,
                               _sk_covariances(sk, cov_type, k, d),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(gm.score_samples(data), sk.score_samples(data),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(gm.bic(data), sk.bic(data), rtol=1e-9)
    np.testing.assert_allclose(gm.aic(data), sk.aic(data), rtol=1e-9)
