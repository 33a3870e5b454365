"""The port's batched restarts (--n-init, k-means++ seeding) against the JAX
package, on CPU.

Seeding must give the very same indices (both packages draw from numpy's
default_rng). Single operations match the JAX package at float64 to 1e-12;
EM loops to 1e-9, because a last-bit difference in one iteration is carried
through every later one. The batched sweep is fixed-width while the
sequential path rebuckets the padded width at small K, so the two paths
of the port agree to the tolerances of tests/test_batched_restarts.py, not
bit for bit.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.gmm import GMMModel as JModel
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.ops import constants as j_constants
from cuda_gmm_mpi_tpu.ops import seeding as j_seeding
from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy, state_to_numpy
from cuda_gmm_mpi_tpu_torch.models.gmm import chunk_events
from cuda_gmm_mpi_tpu_torch.models.restarts import resolve_restart_batch_size
from cuda_gmm_mpi_tpu_torch.ops import constants as t_constants
from cuda_gmm_mpi_tpu_torch.ops import seeding as t_seeding
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.ops.merge import (
    eliminate_and_reduce, eliminate_and_reduce_batched,
)
from cuda_gmm_mpi_tpu_torch.state import lane, stack_states

from .conftest import make_blobs
from .test_torch_cli import blob_csv  # noqa: F401  (fixture)
from .test_torch_ops import FIELDS, jax_to_numpy, make_state_np, to_jax


def _jstack(states):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def _tstack(dicts):
    return stack_states([state_from_numpy(d) for d in dicts])


# ------------------------------------------------------------- seeding


@pytest.mark.parametrize("max_sample", [64, 4096], ids=["pool<N", "pool>N"])
@pytest.mark.parametrize("seed", range(4))
def test_kmeanspp_indices_equal_jax(seed, max_sample):
    data = np.random.default_rng(100 + seed).normal(size=(1000, 3))
    ours = t_seeding.kmeanspp_indices(data, 6, seed=seed,
                                      max_sample=max_sample)
    np.testing.assert_array_equal(
        ours, j_seeding.kmeanspp_indices(data, 6, seed=seed,
                                         max_sample=max_sample))


def test_seed_states_batched_matches_jax(rng):
    rows = rng.normal(size=(3, 5, 4))
    ours = t_seeding.seed_states_batched(rows, 1000, 2.5, 5,
                                         covariance_dynamic_range=1e3,
                                         dtype=np.float64)
    theirs = j_seeding.seed_states_batched(rows, 1000, 2.5, 5,
                                           covariance_dynamic_range=1e3,
                                           dtype=np.float64)
    assert ours.N.shape == (3, 5) and ours.num_clusters_padded == 5
    ours = state_to_numpy(ours)
    for name in FIELDS:
        np.testing.assert_allclose(ours[name], np.asarray(getattr(theirs, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_batched_constants_per_lane_and_against_jax_vmap(rng, diag):
    """compute_constants on [R, K, ...] states: each lane equals the
    unbatched call bit for bit (pi normalised within the lane, a non-PD
    cluster reset per lane), and the whole matches jax.vmap at float64."""
    lanes = [make_state_np(rng, 6, 4, inactive=inact, diag=diag)
             for inact in ((), (1,), (0, 5))]
    lanes[1]["R"][3] = -np.eye(4)  # not positive definite: reset to I
    ours = t_constants.compute_constants(_tstack(lanes), diag_only=diag)
    for r, s in enumerate(lanes):
        one = t_constants.compute_constants(state_from_numpy(s),
                                            diag_only=diag)
        for name in ("R", "Rinv", "constant", "pi"):
            assert torch.equal(getattr(lane(ours, r), name),
                               getattr(one, name)), (r, name)
    theirs = jax.vmap(functools.partial(j_constants.compute_constants,
                                        diag_only=diag))(
        _jstack([to_jax(s) for s in lanes]))
    ours_np = state_to_numpy(ours)
    for name in ("R", "Rinv", "constant", "pi"):
        np.testing.assert_allclose(ours_np[name],
                                   np.asarray(getattr(theirs, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


# ------------------------------------------------------------- EM loop


def _em_setup(rng, diag):
    data, _ = make_blobs(rng, n=600, d=3, k=3)
    chunks, wts = chunk_events(data, 128)
    lanes = [j_seeding.seed_clusters_host(data, 4, seed_method="kmeans++",
                                          seed=s) for s in range(3)]
    if diag:
        lanes = [j_constants.compute_constants(s, diag_only=True)
                 for s in lanes]
    return data, chunks, wts, [jax_to_numpy(s) for s in lanes]


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_run_em_batched_matches_jax_float64(rng, diag):
    """Torch-ops batched loop against the JAX package's vmapped loop, with
    per-lane bounds: the same iterations per lane, loglik and means to
    1e-9."""
    data, chunks, wts, lanes = _em_setup(rng, diag)
    # A tenth of the usual epsilon: the lanes converge at different counts.
    eps = convergence_epsilon(*data.shape) * 0.1
    hi = np.array([40, 5, 40])
    kw = dict(min_iters=3, max_iters=40, dtype="float64", chunk_size=128,
              diag_only=diag)
    j_states, j_ll, j_iters = JModel(JConfig(**kw)).run_em_batched(
        _jstack([to_jax(s) for s in lanes]), jnp.asarray(chunks),
        jnp.asarray(wts), eps, min_iters=3, max_iters=hi)
    model = GMMModel(GMMConfig(device="cpu", **kw))
    t_states, t_ll, t_iters = model.run_em_batched(
        _tstack(lanes), torch.as_tensor(chunks), torch.as_tensor(wts), eps,
        min_iters=3, max_iters=hi)
    np.testing.assert_array_equal(t_iters, np.asarray(j_iters))
    assert t_iters[1] == 5 and 5 < t_iters[0] < 40 and 5 < t_iters[2] < 40
    np.testing.assert_allclose(t_ll, np.asarray(j_ll), rtol=1e-9)
    ours = state_to_numpy(t_states)
    for name in ("means", "R", "N"):
        np.testing.assert_allclose(ours[name],
                                   np.asarray(getattr(j_states, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_run_em_batched_freeze_out(rng):
    """A max_iters=0 lane passes through untouched, with no loglik; every
    other lane equals its own run_em bit for bit."""
    data, chunks, wts, lanes = _em_setup(rng, False)
    eps = convergence_epsilon(*data.shape)
    model = GMMModel(GMMConfig(device="cpu", dtype="float64", min_iters=3,
                               max_iters=12, chunk_size=128))
    c, w = torch.as_tensor(chunks), torch.as_tensor(wts)
    states = _tstack(lanes)
    out, ll, iters = model.run_em_batched(states, c, w, eps,
                                          max_iters=np.array([12, 0, 12]))
    assert iters[1] == 0 and np.isnan(ll[1])
    for name in FIELDS:
        assert torch.equal(getattr(lane(out, 1), name),
                           getattr(lane(states, 1), name)), name
    for r in (0, 2):
        s, l1, it = model.run_em(state_from_numpy(lanes[r]), c, w, eps)
        assert it == iters[r] and l1 == ll[r]
        for name in FIELDS:
            assert torch.equal(getattr(lane(out, r), name),
                               getattr(s, name)), (r, name)


def test_eliminate_and_reduce_batched_is_per_lane(rng):
    lanes = [make_state_np(rng, 6, 3, inactive=inact)
             for inact in ((), (2,))]
    lanes[1]["N"][4] = 0.1  # an empty cluster to eliminate
    new, k_active, min_d, pairs = eliminate_and_reduce_batched(
        _tstack(lanes))
    for r, s in enumerate(lanes):
        ns, k, d, pair = eliminate_and_reduce(state_from_numpy(s))
        assert (k, pair) == (k_active[r], pairs[r]) and d == min_d[r]
        for name in FIELDS:
            assert torch.equal(getattr(lane(new, r), name), getattr(ns, name))
    assert list(k_active) == [6, 4]
    # A lane outside ``live`` is not scanned and comes back unchanged.
    new, k_active, min_d, pairs = eliminate_and_reduce_batched(
        _tstack(lanes), np.array([False, True]))
    assert (k_active[0], min_d[0], pairs[0]) == (0, np.inf, None)
    for name in FIELDS:
        assert torch.equal(getattr(lane(new, 0), name),
                           torch.as_tensor(lanes[0][name]))


# ------------------------------------------------------------- the fit


def _restart_data():
    data, _ = make_blobs(np.random.default_rng(3), n=900, d=3, k=4,
                         spread=3.0)
    return data


RESTART_KW = dict(n_init=3, seed=0, min_iters=6, max_iters=6,
                  chunk_size=256, dtype="float64")


def test_single_kmeanspp_fit_matches_jax_float64():
    """seed_method='kmeans++' for one fit: the seed rows come from the
    un-centred data and the fit matches the JAX package's."""
    data = _restart_data()
    kw = dict(seed_method="kmeans++", seed=5, min_iters=6, max_iters=6,
              chunk_size=256, dtype="float64")
    jr = j_fit(data, 6, 3, config=JConfig(**kw))
    tr = fit_gmm(data, 6, 3, config=GMMConfig(device="cpu", **kw))
    assert tr.init_index is None and jr.init_index is None
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tr.final_loglik, jr.final_loglik, rtol=1e-9)


@pytest.mark.parametrize("batch_size", [3, 2], ids=["one-batch", "ragged"])
def test_batched_restarts_match_sequential(batch_size):
    """Batched (one batch of 3, or 2 + a ragged 1) against one fit per
    init: the same winner, K and merge pairs, and scores to the tolerances
    of tests/test_batched_restarts.py."""
    data = _restart_data()
    kw = dict(device="cpu", **RESTART_KW)
    seq = fit_gmm(data, 6, 0, config=GMMConfig(restart_batch_size=1, **kw))
    bat = fit_gmm(data, 6, 0, config=GMMConfig(restart_batch_size=batch_size,
                                               **kw))
    assert seq.init_index == bat.init_index == 2  # not the even init
    assert bat.ideal_num_clusters == seq.ideal_num_clusters
    assert [m[1] for m in bat.merges] == [m[1] for m in seq.merges]
    np.testing.assert_allclose(bat.min_rissanen, seq.min_rissanen, rtol=1e-10)
    np.testing.assert_allclose(bat.final_loglik, seq.final_loglik, rtol=1e-10)
    np.testing.assert_allclose(bat.means, seq.means, rtol=1e-8, atol=1e-8)
    assert [r[0] for r in bat.sweep_log] == [r[0] for r in seq.sweep_log]
    for b, s in zip(bat.sweep_log, seq.sweep_log):
        np.testing.assert_allclose(b[1], s[1], rtol=1e-9)
    assert sorted(bat.timings) == ["em", "merge", "prepare", "seed"]
    assert min(bat.timings.values()) > 0.0
    if batch_size == 3:  # one batch: its EM seconds are the sweep_log's
        assert bat.timings["em"] == sum(r[4] for r in bat.sweep_log)


def test_batched_restarts_match_jax_float64(tmp_path):
    """The port's batched fit against the JAX package's: the same winner,
    K and merge pairs (the JAX side's from its telemetry stream), and the
    best score to 1e-9."""
    data = _restart_data()
    metrics = tmp_path / "jax.jsonl"
    jr = j_fit(data, 6, 0, config=JConfig(restart_batch_size=3,
                                          metrics_file=str(metrics),
                                          **RESTART_KW))
    tr = fit_gmm(data, 6, 0, config=GMMConfig(restart_batch_size=3,
                                              device="cpu", **RESTART_KW))
    assert tr.init_index == jr.init_index
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    np.testing.assert_allclose(tr.min_rissanen, jr.min_rissanen, rtol=1e-9)
    jax_pairs = [tuple(r["pair"])
                 for r in map(json.loads, metrics.read_text().splitlines())
                 if r.get("event") == "merge" and r.get("init") == jr.init_index]
    assert [m[1] for m in tr.merges] == jax_pairs
    np.testing.assert_allclose(tr.means, jr.means, rtol=1e-8, atol=1e-8)


def test_restart_batch_size_resolution(monkeypatch):
    data = np.zeros((1000, 3))
    resolve = lambda **kw: resolve_restart_batch_size(
        GMMConfig(device="cpu", **kw), data, 8)
    assert resolve(n_init=1, restart_batch_size=4) == 1
    assert resolve(n_init=3, restart_batch_size=8) == 3
    assert resolve(n_init=4) == 4  # the host budget admits all four
    monkeypatch.setenv("GMM_RESTART_MEM_BYTES", "1")
    assert resolve(n_init=4) == 1
    assert resolve(n_init=4, restart_batch_size=3) == 3
    with pytest.raises(ValueError, match="n_init"):
        GMMConfig(n_init=0)
    with pytest.raises(ValueError, match="seed_method"):
        GMMConfig(seed_method="random")


# ------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("batch_size", ["3", "1"],
                         ids=["batched", "sequential"])
def test_cli_n_init_byte_identical_to_jax(blob_csv, tmp_path, capsys,  # noqa: F811
                                          batch_size):
    args = ["8", blob_csv, None, "4", "--device=cpu", "--dtype=float64",
            "--min-iters=10", "--max-iters=10", "--n-init", "3",
            "--restart-batch-size", batch_size]
    for main, out in ((jax_main, "j"), (torch_main, "t")):
        args[2] = str(tmp_path / out)
        assert main(args) == 0
    for ext in (".summary", ".results"):
        assert ((tmp_path / ("t" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes()), ext
