"""The port's out-of-core EM (models/streaming.py) on the CPU, against the
port's in-memory fit and the JAX package's streaming fit.

Inputs are numpy-seeded blobs; both packages run at float64. The streaming
fit adds the same per-chunk statistics in the same order as the in-memory
path, so the two agree to summation-order noise (rtol 1e-12, the same K
and merge pairs); against the JAX package's streaming fit the same bound
holds. Stepwise EM (``em_mode='minibatch'``) is held to the JAX package's
stepwise fit at rtol 1e-12 and to full EM within the health tolerance
(``health_regression_scale x convergence_epsilon``), the JAX test's bar.
The data mesh runs in one gloo world of 2 CPU ranks
(tests/torch_mesh_worker.py) against the JAX package's ``mesh=(2, 1)``
streaming fit at rtol 1e-9 (as tests/test_torch_multihost.py).
Ported from tests/test_streaming.py, tests/test_health.py (poison_block)
and tests/test_preemption.py.
"""

import json
import os

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu import supervisor as j_supervisor
from cuda_gmm_mpi_tpu.testing import faults as j_faults
from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch import supervisor
from cuda_gmm_mpi_tpu_torch.health import NumericalFaultError
from cuda_gmm_mpi_tpu_torch.io import FileSource, write_bin
from cuda_gmm_mpi_tpu_torch.models.restarts import resolve_restart_batch_size
from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.testing import faults

from .torch_mesh_worker import run_cases, spawn_world

KW = dict(min_iters=5, max_iters=5, chunk_size=128, dtype="float64")


def _blobs(seed, n, d=3, k=3, spread=8.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=spread, size=(k, d))
    return c[rng.integers(0, k, n)] + rng.normal(size=(n, d))


DATA = _blobs(0, 1100)


def _cfg(**kw):
    return GMMConfig(device="cpu", **kw)


def _jax_pairs(metrics):
    return [tuple(r["pair"]) for r in map(json.loads,
                                          metrics.read_text().splitlines())
            if r.get("event") == "merge"]


def _same_fit(a, b, rtol):
    assert a.ideal_num_clusters == b.ideal_num_clusters
    np.testing.assert_allclose(a.final_loglik, b.final_loglik, rtol=rtol)
    np.testing.assert_allclose(np.asarray(a.means), np.asarray(b.means),
                               rtol=1e-10, atol=1e-12)
    for (k1, ll1, *_), (k2, ll2, *_) in zip(a.sweep_log, b.sweep_log):
        assert k1 == k2
        np.testing.assert_allclose(ll1, ll2, rtol=rtol)


@pytest.mark.parametrize("case", ["full", "diag-weighted"])
def test_streaming_fit_matches_in_memory_and_jax(tmp_path, case):
    """rtol 1e-12 against the port's in-memory fit and the JAX package's
    streaming fit, with the same K and merge pairs: full covariance, and
    diagonal with integer sample weights in {1, 2}."""
    kw = dict(KW, diag_only=case != "full")
    w = (np.random.default_rng(5).integers(1, 3, DATA.shape[0]).astype(
        np.float64) if case != "full" else None)
    r_mem = fit_gmm(DATA, 5, 2, _cfg(**kw), sample_weight=w)
    r_str = fit_gmm(DATA, 5, 2, _cfg(stream_events=True, **kw),
                    sample_weight=w)
    assert isinstance(r_str.model, StreamingGMMModel)
    assert r_str.model.estep_backend == "torch"  # float64 on the CPU
    _same_fit(r_str, r_mem, 1e-12)
    assert [m[1] for m in r_str.merges] == [m[1] for m in r_mem.merges]
    metrics = tmp_path / "jax.jsonl"
    r_jax = j_fit(DATA, 5, 2, JConfig(stream_events=True,
                                      metrics_file=str(metrics), **kw),
                  sample_weight=w)
    _same_fit(r_str, r_jax, 1e-12)
    assert [tuple(m[1]) for m in r_str.merges] == _jax_pairs(metrics)


def test_streaming_estimator_and_fused_sweep_fallback():
    """``GaussianMixture(stream_events=True)`` fits on the streaming model
    and predicts chunk by chunk from the host; ``fused_sweep`` falls back
    to the host-driven sweep with the same fit."""
    gm = GaussianMixture(3, target_components=3, stream_events=True,
                         device="cpu", **KW).fit(DATA)
    assert isinstance(gm._model, StreamingGMMModel)
    ref = GaussianMixture(3, target_components=3, device="cpu",
                          **KW).fit(DATA)
    np.testing.assert_allclose(gm.means_, ref.means_, rtol=1e-12)
    np.testing.assert_allclose(gm.predict_proba(DATA), ref.predict_proba(DATA),
                               rtol=1e-10, atol=1e-12)
    plain = fit_gmm(DATA, 3, 2, _cfg(stream_events=True, **KW))
    fused = fit_gmm(DATA, 3, 2, _cfg(stream_events=True, fused_sweep=True,
                                     **KW))
    assert fused.final_loglik == plain.final_loglik


def test_streaming_config_guards():
    with pytest.raises(ValueError, match="cluster mesh axis"):
        GMMConfig(stream_events=True, mesh_shape=(4, 2))
    GMMConfig(stream_events=True, mesh_shape=(8, 1))
    with pytest.raises(ValueError, match="precompute_features"):
        GMMConfig(stream_events=True, precompute_features=True)
    with pytest.raises(ValueError, match="unknown ingest"):
        GMMConfig(ingest="mmap")
    with pytest.raises(ValueError, match="streaming block loop"):
        GMMConfig(ingest="pipelined")
    with pytest.raises(ValueError, match="ingest_queue_depth"):
        GMMConfig(stream_events=True, ingest="pipelined",
                  ingest_queue_depth=0)
    with pytest.raises(ValueError, match="unknown em_mode"):
        GMMConfig(em_mode="sgd")
    with pytest.raises(ValueError, match="stepwise EM loop"):
        GMMConfig(em_mode="minibatch")
    for bad in (dict(minibatch_alpha=0.5), dict(minibatch_alpha=1.01)):
        with pytest.raises(ValueError, match="minibatch_alpha"):
            GMMConfig(stream_events=True, em_mode="minibatch", **bad)
    with pytest.raises(ValueError, match="minibatch_t0"):
        GMMConfig(stream_events=True, minibatch_t0=-1.0)
    with pytest.raises(ValueError, match="minibatch_size"):
        GMMConfig(stream_events=True, minibatch_size=-5)
    # The port honours the kernel request (the JAX package refuses
    # use_pallas='always' here, whose streaming path runs no kernel).
    GMMConfig(stream_events=True, estep_backend="cuda")
    with pytest.raises(ValueError, match="FileSource"):
        fit_gmm(DATA, 3, 3, _cfg(stream_events=True, ingest="pipelined",
                                 **KW))
    # Restarts run one after another: no single EM program to batch.
    assert resolve_restart_batch_size(
        _cfg(stream_events=True, n_init=4, restart_batch_size=4), DATA,
        3) == 1


def test_minibatch_matches_jax_and_full_em(tmp_path):
    """Stepwise EM over a pipelined file: rtol 1e-12 against the JAX
    package's stepwise fit, and within 10 x convergence_epsilon of full EM
    at a matched gamma sum (tests/test_ingest.py:251-266)."""
    n, d, k = 4096, 3, 4
    x = _blobs(3, n, d, k, spread=9.0).astype(np.float32)
    path = str(tmp_path / "ev.bin")
    write_bin(path, x)
    kw = dict(chunk_size=256, dtype="float64", stream_events=True, seed=3)
    mb = dict(min_iters=340, max_iters=340, em_mode="minibatch",
              minibatch_size=1024, ingest="pipelined", **kw)
    r_mb = fit_gmm(FileSource(path), k, k, _cfg(**mb))
    r_full = fit_gmm(FileSource(path), k, k,
                     _cfg(min_iters=12, max_iters=12, **kw))
    assert abs(r_mb.final_loglik - r_full.final_loglik) <= \
        10.0 * convergence_epsilon(n, d)
    from cuda_gmm_mpi_tpu.io import FileSource as JFileSource

    # The step sequence against the JAX package's, over 60 steps (the
    # wrap-around of the 4-block minibatches over the 16 blocks included).
    short = dict(mb, min_iters=60, max_iters=60)
    r_short = fit_gmm(FileSource(path), k, k, _cfg(**short))
    r_jax = j_fit(JFileSource(path), k, k, JConfig(**short))
    np.testing.assert_allclose(r_short.final_loglik, r_jax.final_loglik,
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(r_short.means),
                               np.asarray(r_jax.means), rtol=1e-10)


@pytest.fixture(scope="module")
def clean_loglik():
    return fit_gmm(DATA, 5, 2, _cfg(stream_events=True, **KW)).final_loglik


def test_poison_block_contained_like_jax(clean_loglik):
    """An all-NaN block 0 (``poison_block``) is observed and the recovery
    ladder's first rung streams clean data: the JAX package's recovery
    (the same rungs, counters and loglik); with recovery off it raises."""
    spec = {"poison_block": {"block": 0}}
    with faults.use(spec) as plan:
        r = fit_gmm(DATA, 5, 2, _cfg(stream_events=True, **KW))
    assert plan.fired["poison_block"] == 1
    assert r.health["recoveries"] >= 1 and r.health["fatal"]
    np.testing.assert_allclose(r.final_loglik, clean_loglik, rtol=1e-4)
    with j_faults.use(spec):
        rj = j_fit(DATA, 5, 2, JConfig(stream_events=True, **KW))
    assert r.health["recoveries"] == rj.health["recoveries"]
    assert r.health["flags"] == rj.health["flags"]
    np.testing.assert_allclose(r.final_loglik, rj.final_loglik, rtol=1e-12)
    with faults.use(spec):
        with pytest.raises(NumericalFaultError, match="nonfinite_loglik"):
            fit_gmm(DATA, 5, 2, _cfg(stream_events=True, recovery="off",
                                     **KW))


def _substeps(ck):
    d = os.path.join(ck, "sweep")
    return sorted(f for f in os.listdir(d)
                  if ".iter" in f and f.endswith(".npz")) if os.path.isdir(
                      d) else []


def _sup():
    return supervisor.RunSupervisor(install_signals=False)


@pytest.mark.parametrize("mode", ["pass", "minibatch"])
def test_preempt_mid_pass_and_minibatch_resume(tmp_path, mode):
    """A stop at pass 2, block 3 (or at stepwise step 3) writes the partial
    accumulator (or the decay state) into the sub-step; the resumed fit ==
    the uninterrupted one."""
    x = _blobs(4, 3072).astype(np.float32)
    path = str(tmp_path / "ev.bin")
    write_bin(path, x)
    kw = dict(min_iters=5, max_iters=5, chunk_size=256, dtype="float64",
              stream_events=True, ingest="pipelined", preempt_poll_iters=2,
              seed=7)
    spec = {"preempt": {"iter": 2, "block": 3}}
    keys = {"stream_pass", "stream_block", "stream_acc.Nk", "stream_acc.M2"}
    if mode == "minibatch":
        kw.update(min_iters=10, max_iters=10, em_mode="minibatch",
                  minibatch_size=512)
        spec = {"preempt": {"iter": 3}}
        keys = {"mb_step", "mb_cursor", "mb_acc.Nk", "mb_acc.M1",
                "mb_acc.M2"}
    ck_ref, ck = str(tmp_path / "ref"), str(tmp_path / "ck")
    with supervisor.use(_sup()):
        ref = fit_gmm(FileSource(path), 4, 4, _cfg(checkpoint_dir=ck_ref,
                                                   **kw))
    with pytest.raises(supervisor.PreemptedError) as ei:
        with faults.use(spec), supervisor.use(_sup()):
            fit_gmm(FileSource(path), 4, 4, _cfg(checkpoint_dir=ck, **kw))
    assert ei.value.checkpointed
    subs = _substeps(ck)
    assert len(subs) == 1
    with np.load(os.path.join(ck, "sweep", subs[0])) as z:
        assert keys <= set(z.files)
        if mode == "pass":
            assert int(z["stream_pass"]) == 2 and int(z["stream_block"]) == 4
        else:
            assert int(z["mb_step"]) == 3
    with supervisor.use(_sup()):
        res = fit_gmm(FileSource(path), 4, 4, _cfg(checkpoint_dir=ck, **kw))
    assert res.final_loglik == ref.final_loglik
    assert res.min_rissanen == ref.min_rissanen
    np.testing.assert_array_equal(res.means, ref.means)
    assert _substeps(ck) == []


def test_jax_stream_acc_checkpoint_resumed_by_the_port(tmp_path):
    """The JAX package stops mid-pass (its ``stream_acc`` sub-step); the
    port resumes it and ends where JAX's uninterrupted fit ends."""
    x = _blobs(6, 1024)
    kw = dict(min_iters=4, max_iters=4, chunk_size=128, dtype="float64",
              stream_events=True, preempt_poll_iters=2)
    ck = str(tmp_path / "ck")
    ref = j_fit(x, 3, 3, JConfig(**kw))
    with pytest.raises(j_supervisor.PreemptedError):
        with j_faults.use({"preempt": {"iter": 2, "block": 3}}):
            with j_supervisor.use(j_supervisor.RunSupervisor(
                    install_signals=False)):
                j_fit(x, 3, 3, JConfig(checkpoint_dir=ck, **kw))
    assert len(_substeps(ck)) == 1
    with supervisor.use(_sup()):
        res = fit_gmm(x, 3, 3, _cfg(checkpoint_dir=ck, **kw))
    assert res.ideal_num_clusters == ref.ideal_num_clusters
    np.testing.assert_allclose(res.final_loglik, ref.final_loglik,
                               rtol=1e-12)
    np.testing.assert_allclose(res.means, np.asarray(ref.means), rtol=1e-10)


def test_streaming_on_a_data_mesh_matches_jax(tmp_path):
    """2 gloo ranks, mesh (2, 1), each streaming its host_chunk_bounds
    slice, resident and pipelined: the JAX package's ``mesh=(2, 1)``
    streaming fit (rtol 1e-9, same K and merge pairs) and, pipelined, the
    resident mesh fit bit for bit."""
    x = _blobs(8, 1500).astype(np.float32)
    path = str(tmp_path / "ev.bin")
    write_bin(path, x)
    kw = dict(min_iters=4, max_iters=4, chunk_size=128, dtype="float64",
              stream_events=True, mesh_shape=(2, 1))
    cases = [("fit_case", dict(data=x.astype(np.float64), k0=4, target=3,
                               **kw)),
             ("fit_case", dict(data=FileSource(path), k0=4, target=3,
                               ingest="pipelined", **kw)),
             ("fit_case", dict(data=FileSource(path), k0=4, target=4,
                               em_mode="minibatch", minibatch_size=512,
                               **dict(kw, min_iters=8, max_iters=8)))]
    ranks = spawn_world(run_cases, 2, tmp_path / "world", cases)
    metrics = tmp_path / "jax.jsonl"
    ref = j_fit(x.astype(np.float64), 4, 3, JConfig(
        metrics_file=str(metrics), **kw))
    for pid, (res, pipe, mb) in enumerate(ranks):
        assert res["k"] == ref.ideal_num_clusters
        assert [tuple(m) for m in res["merges"]] == _jax_pairs(metrics)
        np.testing.assert_allclose(res["final_loglik"], ref.final_loglik,
                                   rtol=1e-9)
        np.testing.assert_allclose(res["means"], np.asarray(ref.means),
                                   rtol=1e-7, atol=1e-9)
        assert pipe["final_loglik"] == res["final_loglik"]
        np.testing.assert_array_equal(pipe["means"], res["means"])
        assert res["host_range"] == ((0, 768), (768, 1500))[pid]
        assert np.isfinite(mb["final_loglik"])
    assert ranks[0][2]["final_loglik"] == ranks[1][2]["final_loglik"]
