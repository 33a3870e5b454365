"""The 'spherical' and 'tied' covariance families of the port against the
JAX package, on the CPU (tests/test_covariance_types.py's cases, less its
fused-sweep ones, which wait for the fused sweep's port).

- The config's coupling of ``covariance_type`` and ``diag_only``.
- ``apply_mstep``: spherical and tied against JAX's on the same
  statistics, float64 to 1e-12, plus the families' structure and tied's
  degenerate guards (a dead-zone cluster neither scatters nor counts; an
  all-empty pool falls back to the identity).
- A fit per new family against JAX ``fit_gmm`` at float64: the same K,
  merge pairs (the JAX side's from its telemetry stream) and parameters.
- Monotone loglik under the constraints; tied on a (1, 2) cluster-sharded
  gloo world against one process; ``n_free_params`` per family.

'spherical' runs the diag statistics and 'tied' the full ones; both run
the torch-ops M-step, as in the JAX package (K2 takes full and diag).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.ops.mstep import SuffStats as JStats
from cuda_gmm_mpi_tpu.ops.mstep import apply_mstep as j_apply
from cuda_gmm_mpi_tpu.ops.mstep import chunk_stats as j_chunk_stats
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.ops.formulas import n_free_params
from cuda_gmm_mpi_tpu_torch.ops.kernels import make_mstep_fn
from cuda_gmm_mpi_tpu_torch.ops.mstep import SuffStats, apply_mstep

from .conftest import make_blobs
from .test_torch_ops import make_state_np, to_jax
from .torch_mesh_worker import run_cases, spawn_world

FAMILIES = ("full", "diag", "spherical", "tied")


def jax_fit_with_pairs(tmp_path, data, k0, target, **cfg):
    """JAX ``fit_gmm`` and its merge pairs, read from its telemetry."""
    metrics = tmp_path / "jax_merges.jsonl"
    r = j_fit(data, k0, target,
              config=JConfig(metrics_file=str(metrics), **cfg))
    pairs = [tuple(e["pair"]) for e in map(json.loads,
                                           metrics.read_text().splitlines())
             if e.get("event") == "merge"]
    metrics.unlink()
    return r, pairs


def test_config_coupling():
    assert GMMConfig(diag_only=True).covariance_type == "diag"
    assert GMMConfig(covariance_type="diag").diag_only is True
    assert GMMConfig(covariance_type="spherical").diag_only is True
    assert GMMConfig(covariance_type="tied").diag_only is False
    with pytest.raises(ValueError, match="tied"):
        GMMConfig(covariance_type="tied", diag_only=True)
    with pytest.raises(ValueError, match="covariance_type"):
        GMMConfig(covariance_type="oblong")
    with pytest.raises(ValueError, match="criterion"):
        GMMConfig(criterion="hqc")
    for ct in FAMILIES:
        for diag in (False, True):
            if ct == "tied" and diag:
                continue
            ours = GMMConfig(covariance_type=ct, diag_only=diag)
            theirs = JConfig(covariance_type=ct, diag_only=diag)
            assert (ours.covariance_type, ours.diag_only) == (
                theirs.covariance_type, theirs.diag_only)
    # Their M-step is torch ops: no K2 hook for them, on any device.
    for ct in ("spherical", "tied"):
        assert make_mstep_fn(GMMConfig(covariance_type=ct)) is None
    assert make_mstep_fn(GMMConfig(covariance_type="diag")) is not None


def _stats(rng, k, d, n, diag, inactive=()):
    """A state (numpy) and JAX statistics of n events under it."""
    s = make_state_np(rng, k, d, np.float64, inactive=inactive, diag=diag)
    x = rng.normal(scale=2.0, size=(n, d))
    return s, j_chunk_stats(to_jax(s), jnp.asarray(x), diag_only=diag)


def _both(s, stats, **kw):
    """apply_mstep of both packages on the same state and statistics."""
    ours = apply_mstep(state_from_numpy(s), SuffStats(*(
        torch.as_tensor(np.array(getattr(stats, f)))
        for f in ("loglik", "Nk", "M1", "M2"))), **kw)
    return ours, j_apply(to_jax(s), stats, **kw)


def _close(ours, theirs, fields=("N", "means", "R", "Rinv", "constant",
                                 "pi")):
    for f in fields:
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(theirs, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)


def test_spherical_mstep_matches_jax(rng):
    s, stats = _stats(rng, 4, 5, 400, True)
    sph, j_sph = _both(s, stats, diag_only=True, covariance_type="spherical")
    _close(sph, j_sph)
    diag, _ = _both(s, stats, diag_only=True)
    var_diag = np.diagonal(diag.R.numpy(), axis1=1, axis2=2)
    var_sph = np.diagonal(sph.R.numpy(), axis1=1, axis2=2)
    np.testing.assert_allclose(
        var_sph,
        np.broadcast_to(var_diag.mean(axis=1, keepdims=True), var_sph.shape),
        rtol=1e-12)
    assert np.ptp(var_sph, axis=1).max() == 0.0
    assert torch.equal(sph.means, diag.means)


def test_tied_mstep_matches_jax(rng):
    k, d = 3, 4
    s, stats = _stats(rng, k, d, 500, False)
    tied, j_tied = _both(s, stats, covariance_type="tied")
    _close(tied, j_tied)
    R = tied.R.numpy()
    for c in range(1, k):
        np.testing.assert_array_equal(R[c], R[0])
    Nk = np.asarray(stats.Nk)
    mu = np.asarray(stats.M1) / Nk[:, None]
    scatter = (np.asarray(stats.M2)
               - Nk[:, None, None] * mu[:, :, None] * mu[:, None, :])
    expect = (scatter.sum(0) + s["avgvar"].max() * np.eye(d)) / Nk.sum()
    np.testing.assert_allclose(R[0], expect, rtol=1e-10, atol=1e-12)


def test_tied_degenerate_guards(rng):
    """A dead-zone cluster (0.5 < Nk < 1) neither scatters nor counts; an
    inactive cluster neither; all clusters empty gives the identity."""
    k, d = 4, 4
    s, stats = _stats(rng, k, d, 300, False, inactive=(3,))
    Nk = np.asarray(stats.Nk).copy()
    Nk[2] = 0.7
    dz = dataclasses.replace(stats, Nk=jnp.asarray(Nk))
    tied, j_tied = _both(s, dz, covariance_type="tied")
    _close(tied, j_tied)
    live = Nk[:2]
    mu = np.asarray(stats.M1)[:2] / live[:, None]
    scatter = (np.asarray(stats.M2)[:2]
               - live[:, None, None] * mu[:, :, None] * mu[:, None, :])
    avg = s["avgvar"][:3].max()
    expect = (scatter.sum(0) + avg * np.eye(d)) / live.sum()
    np.testing.assert_allclose(tied.R.numpy()[0], expect, rtol=1e-10,
                               atol=1e-12)
    empty = dataclasses.replace(stats, Nk=jnp.zeros_like(stats.Nk))
    t0, j0 = _both(s, empty, covariance_type="tied")
    _close(t0, j0)
    np.testing.assert_array_equal(t0.R.numpy()[0], np.eye(d))


@pytest.mark.parametrize("ct", ["spherical", "tied"])
def test_fit_matches_jax(rng, tmp_path, ct):
    """fit_gmm per new family, K 5 -> 2 at float64: the JAX package's K,
    merge pairs, score and parameters (full and diag: tests/test_torch_em.py
    and tests/test_torch_estimator.py)."""
    data, _ = make_blobs(rng, n=600, d=3, k=3, dtype=np.float64)
    kw = dict(covariance_type=ct, min_iters=6, max_iters=6, chunk_size=128,
              dtype="float64")
    jr, pairs = jax_fit_with_pairs(tmp_path, data, 5, 2, **kw)
    tr = fit_gmm(data, 5, 2, config=GMMConfig(device="cpu", **kw))
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    assert [m[1] for m in tr.merges] == pairs and len(pairs) == 3
    np.testing.assert_allclose(tr.final_loglik, jr.final_loglik, rtol=1e-12)
    np.testing.assert_allclose(tr.min_rissanen, jr.min_rissanen, rtol=1e-12)
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tr.covariances, jr.covariances, rtol=1e-12,
                               atol=1e-12)
    cov = tr.covariances
    if ct == "spherical":
        for c in range(tr.ideal_num_clusters):
            np.testing.assert_array_equal(cov[c], np.diag(np.diag(cov[c])))
            assert np.ptp(np.diag(cov[c])) == 0.0
    elif ct == "tied":
        for c in range(1, tr.ideal_num_clusters):
            np.testing.assert_array_equal(cov[c], cov[0])


def test_monotone_loglik_under_constraints(rng):
    data, _ = make_blobs(rng, n=800, d=3, k=3, dtype=np.float64)
    for ct in ("spherical", "tied"):
        lls = [fit_gmm(data, 3, 3, config=GMMConfig(
            device="cpu", covariance_type=ct, min_iters=iters,
            max_iters=iters, chunk_size=256, dtype="float64")).final_loglik
            for iters in (2, 6, 12)]
        assert lls[0] <= lls[1] + 1e-9 <= lls[2] + 2e-9, (ct, lls)


TIED = dict(covariance_type="tied", min_iters=5, max_iters=5, chunk_size=64,
            dtype="float64")


def _tied_data():
    return make_blobs(np.random.default_rng(31), n=640, d=3, k=4,
                      dtype=np.float64)[0]


@pytest.fixture(scope="module")
def tied_mesh(tmp_path_factory):
    return spawn_world(run_cases, 2, tmp_path_factory.mktemp("world"), [(
        "fit_case", dict(data=_tied_data(), k0=4, target=2,
                         mesh_shape=(1, 2), **TIED))])


def test_tied_cluster_sharded_matches_one_process(tied_mesh):
    """Tied pools across the cluster axis (all_reduce SUM of the pool and
    count, MAX of the loading): a (1, 2) world gives one process's fit."""
    one = fit_gmm(_tied_data(), 4, 2, config=GMMConfig(device="cpu", **TIED))
    for (r,) in tied_mesh:
        assert r["k"] == one.ideal_num_clusters
        assert r["merges"] == [m[1] for m in one.merges]
        np.testing.assert_allclose(r["final_loglik"], one.final_loglik,
                                   rtol=1e-9)
        np.testing.assert_allclose(r["means"], one.means, rtol=1e-8,
                                   atol=1e-10)


def test_n_free_params_by_family():
    k, d = 5, 4
    assert n_free_params(k, d) == k * (1 + d + d * (d + 1) / 2) - 1
    assert n_free_params(k, d, covariance_type="diag") == k * (1 + 2 * d) - 1
    assert n_free_params(k, d, covariance_type="spherical") == k * (2 + d) - 1
    assert n_free_params(k, d, covariance_type="tied") == (
        k * (1 + d) + d * (d + 1) / 2 - 1)
    assert n_free_params(k, d, diag_only=True) == k * (1 + 2 * d) - 1


@pytest.mark.parametrize("ct", ["spherical", "tied"])
def test_batched_restarts_match_jax(ct):
    """The new families in the batched restart loop (K3's plain version
    for the statistics, the torch-ops M-step lane by lane: K4 takes full
    and diag): the JAX package's winner, K, score and means at float64."""
    data, _ = make_blobs(np.random.default_rng(37), n=360, d=3, k=3,
                         dtype=np.float64)
    kw = dict(covariance_type=ct, min_iters=4, max_iters=4, chunk_size=128,
              dtype="float64", n_init=2, restart_batch_size=2)
    jr = j_fit(data, 4, 3, config=JConfig(**kw))
    tr = fit_gmm(data, 4, 3, config=GMMConfig(device="cpu", **kw))
    assert tr.init_index == jr.init_index
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    np.testing.assert_allclose(tr.min_rissanen, jr.min_rissanen, rtol=1e-12)
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tr.covariances, jr.covariances, rtol=1e-12,
                               atol=1e-12)
