"""The port's fused sweep, ``sweep_k_buckets``, the device order reduction
and the device-controlled EM loop, on the CPU, against the JAX package and
the port's own host forms.

Tolerances are tests/test_fused_sweep.py's: at float64 the fused sweep
selects the same K, with ``sweep_log`` K and iterations equal, loglik and
score to rtol 1e-12, means to rtol 1e-10 and covariances to rtol 1e-9;
float32 loglik rtol 1e-6, means rtol 1e-4. Where the port holds two of its
own forms against each other (fused against the host sweep at 'off', the
device order reduction against the host one, the device-controlled EM
loop against ``_em_loop``), it holds them exactly (``torch.equal``): they
run the same operations. Checkpoints cross between the packages' CLIs and
end byte-identical to the uninterrupted run at float64.
"""

import json

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.testing import faults as j_faults
from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm, health
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.interop import state_from_numpy
from cuda_gmm_mpi_tpu_torch.models.em_program import EMProgram
from cuda_gmm_mpi_tpu_torch.models.gmm import _em_loop, chunk_events, em_hooks
from cuda_gmm_mpi_tpu_torch.ops.formulas import convergence_epsilon
from cuda_gmm_mpi_tpu_torch.ops.merge import (
    eliminate_and_reduce, eliminate_and_reduce_device,
)
from cuda_gmm_mpi_tpu_torch.state import GMMState
from cuda_gmm_mpi_tpu_torch.telemetry import read_stream, validate_stream
from cuda_gmm_mpi_tpu_torch.testing import faults as t_faults
from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

from .conftest import make_blobs
from .test_torch_cli import ARGS, blob_csv  # noqa: F401  (fixture)
from .test_torch_health import CHUNK, FIT, blob_data, events  # noqa: F401
from .test_torch_health import one_torch_thread  # noqa: F401  (fixture)
from .test_torch_ops import make_state_np

BASE = dict(min_iters=4, max_iters=4, chunk_size=256, dtype="float64")


def tcfg(**kw):
    return GMMConfig(device="cpu", **dict(BASE, **kw))


def jcfg(**kw):
    return JConfig(**dict(BASE, **kw))


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(np.random.default_rng(1234), n=900, d=3, k=4)[0]


def log_rows(result):
    return [tuple(r[:4]) for r in result.sweep_log]


def assert_same_fit(ours, theirs, score_rtol=1e-12):
    """tests/test_fused_sweep.py's bar between two sweeps."""
    assert ours.ideal_num_clusters == theirs.ideal_num_clusters
    np.testing.assert_allclose(ours.min_rissanen, theirs.min_rissanen,
                               rtol=score_rtol)
    np.testing.assert_allclose(ours.final_loglik, theirs.final_loglik,
                               rtol=1e-12)
    np.testing.assert_allclose(ours.means, theirs.means, rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(ours.covariances, theirs.covariances,
                               rtol=1e-9, atol=1e-12)
    assert len(ours.sweep_log) == len(theirs.sweep_log)
    for a, b in zip(ours.sweep_log, theirs.sweep_log):
        assert a[0] == b[0] and a[3] == b[3]
        np.testing.assert_allclose(a[1:3], b[1:3], rtol=1e-12)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal`` that also holds NaN payloads to each other."""
    if a.is_floating_point():
        view = {8: torch.int64, 4: torch.int32}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def assert_states_equal(a: GMMState, b: GMMState):
    for f in ("N", "pi", "constant", "avgvar", "means", "R", "Rinv",
              "active"):
        assert same_bits(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("target", [0, 3])
def test_fused_matches_jax_fused(blobs, target):
    ours = fit_gmm(blobs, 8, target, config=tcfg(fused_sweep=True))
    theirs = j_fit(blobs, 8, target, config=jcfg(fused_sweep=True))
    assert_same_fit(ours, theirs)


@pytest.mark.parametrize("buckets", ["off", "pow2"])
def test_fused_matches_host_sweep(blobs, buckets):
    """At 'off' (the fused sweep's own fixed width) the two sweeps run the
    same operations: equal bit for bit. At 'pow2' the host sweep's EM runs
    at narrower widths: tests/test_fused_sweep.py's bar."""
    fused = fit_gmm(blobs, 8, 3, config=tcfg(fused_sweep=True))
    host = fit_gmm(blobs, 8, 3, config=tcfg(sweep_k_buckets=buckets))
    if buckets == "off":
        assert log_rows(fused) == log_rows(host)
        assert fused.final_loglik == host.final_loglik
        assert fused.min_rissanen == host.min_rissanen
        assert_states_equal(fused.state, host.state)
    else:
        assert_same_fit(fused, host)


def test_fused_k1():
    data, _ = make_blobs(np.random.default_rng(5), n=300, d=2, k=2)
    r = fit_gmm(data, 1, 1, config=tcfg(fused_sweep=True))
    assert r.ideal_num_clusters == 1 and np.isfinite(r.final_loglik)
    assert log_rows(r) == log_rows(fit_gmm(data, 1, 1, config=tcfg()))


@pytest.mark.parametrize("target", [0, 15])
def test_fused_mass_elimination_equals_jax(target):
    """K close to N: elimination can drop the count below the target in
    one step, and the fused sweep stops where the host loop does."""
    data = np.random.default_rng(9).normal(size=(60, 3))
    kw = dict(min_iters=2, max_iters=2, chunk_size=32)
    ours = fit_gmm(data, 24, target, config=tcfg(fused_sweep=True, **kw))
    theirs = j_fit(data, 24, target, config=jcfg(fused_sweep=True, **kw))
    host = fit_gmm(data, 24, target, config=tcfg(**kw))
    assert [r[0] for r in ours.sweep_log] == [r[0] for r in theirs.sweep_log]
    assert [r[0] for r in ours.sweep_log] == [r[0] for r in host.sweep_log]
    assert ours.ideal_num_clusters == theirs.ideal_num_clusters
    np.testing.assert_allclose(ours.min_rissanen, theirs.min_rissanen,
                               rtol=1e-12)


def test_fused_float32_equals_jax():
    data, _ = make_blobs(np.random.default_rng(1234), n=800, d=3, k=4,
                         dtype=np.float32)
    kw = dict(min_iters=4, max_iters=4, chunk_size=256, dtype="float32")
    ours = fit_gmm(data, 7, 0, config=GMMConfig(device="cpu",
                                                fused_sweep=True, **kw))
    theirs = j_fit(data, 7, 0, config=JConfig(fused_sweep=True, **kw))
    assert ours.ideal_num_clusters == theirs.ideal_num_clusters
    np.testing.assert_allclose(ours.final_loglik, theirs.final_loglik,
                               rtol=1e-6)
    np.testing.assert_allclose(ours.means, theirs.means, rtol=1e-4,
                               atol=1e-5)


def test_sweep_k_buckets_off_equals_jax(blobs):
    ours = fit_gmm(blobs, 8, 0, config=tcfg(sweep_k_buckets="off"))
    theirs = j_fit(blobs, 8, 0, config=jcfg(sweep_k_buckets="off"))
    assert_same_fit(ours, theirs)


def test_fused_checkpoint_emits_per_k(tmp_path):
    """Each completed K is a ``<step>.npz`` in the fused layout, and each
    K's seconds are its own (emission arrivals), not the wall over Ks."""
    data, _ = make_blobs(np.random.default_rng(5), n=300, d=2, k=2)
    r = fit_gmm(data, 4, 2, config=tcfg(
        fused_sweep=True, checkpoint_dir=str(tmp_path / "ck")))
    restored = SweepCheckpointer(str(tmp_path / "ck")).restore()
    assert restored is not None and "fused_log" in restored
    assert restored["fused_log"].shape == (4, 5)
    assert r.ideal_num_clusters >= 2 and len(r.sweep_log) >= 2
    assert len({round(row[4], 9) for row in r.sweep_log}) > 1


def _fused_argv(csv, out, *extra):
    return (["8", csv, str(out), "4"] + ARGS[4:] + [CHUNK, "--fused-sweep"]
            + list(extra))


@pytest.fixture(scope="module")
def fused_reference(blob_csv, tmp_path_factory):  # noqa: F811
    """The JAX CLI's uninterrupted fused run."""
    out = tmp_path_factory.mktemp("fused_ref") / "u"
    assert jax_main(_fused_argv(blob_csv, out)) == 0
    return {ext: (out.parent / ("u" + ext)).read_bytes()
            for ext in (".summary", ".results")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fused_resume_across_packages(blob_csv, fused_reference,  # noqa: F811
                                      tmp_path, capsys, writer):
    """A fused run stopped at its first per-K emission (exit 75; the
    deadline is the stop both packages' fused sweeps observe there: the
    JAX package's never polls a ``preempt`` plan) resumes in the other
    package's CLI and ends byte-identical to the uninterrupted run."""
    mains = {"jax": jax_main, "port": torch_main}
    reader = "port" if writer == "jax" else "jax"
    ck = "--checkpoint-dir=" + str(tmp_path / "ck")
    assert mains[writer](_fused_argv(blob_csv, tmp_path / "x", ck,
                                     "--max-runtime=0.001")) == 75
    assert "resumable from step 0" in capsys.readouterr().err
    restored = SweepCheckpointer(str(tmp_path / "ck")).restore()
    assert int(restored["step"]) == 0 and "fused_log" in restored
    assert mains[reader](_fused_argv(blob_csv, tmp_path / "r", ck)) == 0
    for ext, want in fused_reference.items():
        assert (tmp_path / ("r" + ext)).read_bytes() == want, ext
    if writer == "jax":  # the port's own uninterrupted run, too
        assert torch_main(_fused_argv(blob_csv, tmp_path / "p")) == 0
        for ext, want in fused_reference.items():
            assert (tmp_path / ("p" + ext)).read_bytes() == want, ext


def _both_fused(tmp_path, spec, **cfg):
    out = {}
    for name, fit, conf, faults in (("j", j_fit, JConfig, j_faults),
                                    ("t", fit_gmm, GMMConfig, t_faults)):
        metrics = tmp_path / f"{name}.jsonl"
        with faults.use(spec):
            try:
                res = fit(blob_data(), 8, 4, config=conf(
                    metrics_file=str(metrics), fused_sweep=True,
                    **dict(FIT, **cfg)))
            except Exception as e:  # noqa: BLE001 -- compared below
                res = e
        out[name] = (res, events(metrics))
    return out


def test_fused_nan_loglik_retry_equals_jax(tmp_path):
    """The fatal word stops the fused sweep at K = 8; recovery falls back
    to the host-driven sweep, with JAX's records, K and merge pairs."""
    out = _both_fused(tmp_path, {"nan_loglik": {"iter": 3}})
    (jr, jev), (tr, tev) = out["j"], out["t"]
    keys = ("k", "where", "action", "outcome", "flags")
    pick = lambda evs: [{k: e.get(k) for k in keys} for e in evs
                        if e["event"] in ("health", "recovery")]
    assert pick(tev) == pick(jev)
    assert [(e["where"], e["action"]) for e in pick(tev)][:2] == [
        ("fused_sweep", None), (None, "host_fallback")]
    pairs = lambda evs: [e["pair"] for e in evs if e["event"] == "merge"]
    assert pairs(tev) == pairs(jev) and len(pairs(tev)) == 4
    assert tr.ideal_num_clusters == jr.ideal_num_clusters
    assert tr.health["recoveries"] == jr.health["recoveries"] == 1


def test_fused_nan_loglik_off_raises_jax_bundle(tmp_path):
    out = _both_fused(tmp_path, {"nan_loglik": {"iter": 3}}, recovery="off")
    (je, _), (te, _) = out["j"], out["t"]
    assert isinstance(te, health.NumericalFaultError), te
    assert type(je).__name__ == "NumericalFaultError", je
    for key in ("k", "where", "flags", "flag_names"):
        assert te.bundle[key] == je.bundle[key], key


def test_fused_recorder_stream(tmp_path):
    """``run_start.fused_sweep`` is true; one ``em_done`` per K and no
    ``em_iter`` (the iterations never reach the host); the stream passes
    the port's schema."""
    path = tmp_path / "m.jsonl"
    r = fit_gmm(blob_data(), 8, 4, config=GMMConfig(
        metrics_file=str(path), fused_sweep=True, **FIT))
    stream = read_stream(str(path))
    assert validate_stream(stream) == []
    assert stream[0]["event"] == "run_start" and stream[0]["fused_sweep"]
    done = [e for e in stream if e["event"] == "em_done"]
    assert [e["k"] for e in done] == [row[0] for row in r.sweep_log]
    assert not [e for e in stream if e["event"] == "em_iter"]
    assert stream[-1]["event"] == "run_summary"


def _reduction_case(case, dtype):
    rng = np.random.default_rng({"plain": 1, "empty": 2, "inf": 3,
                                 "nonpd": 4}[case])
    k, d = 9, 4
    st = make_state_np(rng, k, d, dtype=dtype, inactive=(2,))
    if case == "empty":
        st["N"][[0, 5]] = [0.2, 0.0]  # eliminated before the scan
    if case == "inf":  # no valid pair: one active cluster after elimination
        st["N"][:] = 0.1
        st["N"][4] = 50.0
    if case == "nonpd":  # the closest pair's merge fails its Cholesky
        st["R"][1] = np.diag([1.0, 1.0, -5.0, 1.0]).astype(dtype)
        st["R"][3] = np.diag([1.0, 1.0, -5.0, 1.0]).astype(dtype)
        st["means"][3] = st["means"][1]
        st["constant"][[1, 3]] = -1e6
    return state_from_numpy(st)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["plain", "empty", "inf", "nonpd"])
@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
def test_device_order_reduction_equals_host(case, dtype, diag):
    state = _reduction_case(case, dtype)
    host, k_h, d_h, pair_h = eliminate_and_reduce(state, diag_only=diag)
    dev, k_d, d_d, pair_d = eliminate_and_reduce_device(state,
                                                        diag_only=diag)
    assert_states_equal(dev, host)
    assert int(k_d) == k_h and tuple(pair_d.tolist()) == pair_h
    assert float(d_d) == d_h or (np.isnan(d_h) and np.isnan(float(d_d)))
    if case == "inf":
        assert d_h == np.inf


class _PoisonAt:
    """An M-step hook that poisons the state's means at its n-th call."""

    def __init__(self, mstep, n):
        self.mstep, self.n, self.calls = mstep, n, 0

    def __call__(self, s, stats):
        self.calls += 1
        out = self.mstep(s, stats)
        if self.calls == self.n:
            out = out.replace(means=out.means + torch.nan)
        return out


EM_CASES = {
    "converges": dict(min_iters=2, max_iters=60),
    "min_binding": dict(min_iters=12, max_iters=60),
    "fatal_mid_loop": dict(min_iters=2, max_iters=60, poison=3),
    "nan_iter": dict(min_iters=2, max_iters=60, nan_iter=3),
    "resume": dict(min_iters=8, max_iters=60, resume=4),
    "polled": dict(min_iters=9, max_iters=9, poll=2),
}


@pytest.mark.parametrize("case", list(EM_CASES))
def test_device_em_loop_equals_host_loop(case):
    """The device-controlled loop, run eagerly (``EMProgram`` without
    capture: the logic a CUDA graph captures), against the host loop
    ``_em_loop``: state, trajectory, iterations and counters equal, and the
    supervisor asked at the same iterations."""
    spec = dict(EM_CASES[case])
    data, _ = make_blobs(np.random.default_rng(3), n=600, d=3, k=3)
    chunks_np, wts_np = chunk_events(data, 128)
    chunks, wts = torch.as_tensor(chunks_np), torch.as_tensor(wts_np)
    state = state_from_numpy(make_state_np(np.random.default_rng(4), 5, 3,
                                           inactive=(4,)))
    eps = convergence_epsilon(*data.shape)
    runs = []
    for form in ("host", "device"):
        estep, mstep, count = em_hooks(chunks, wts)
        if "poison" in spec:
            mstep = _PoisonAt(mstep, spec["poison"])
        asked = []
        poll = spec.get("poll")
        should_stop = (lambda i: asked.append(i) or False) if poll else None
        resume = None
        if "resume" in spec:  # the trajectory of a first run, stopped
            first = _em_loop(state, chunks, wts, eps, spec["resume"],
                             spec["resume"])
            resume = {"em_iter": first.iters, "em_lls": first.lls}
            start = first.state
        else:
            start = state
        kw = dict(min_iters=spec["min_iters"], max_iters=spec["max_iters"],
                  nan_iter=spec.get("nan_iter"), should_stop=should_stop,
                  poll_iters=poll or 25, resume=resume)
        if form == "host":
            run = _em_loop(start, chunks, wts, eps, mstep_fn=mstep, **kw)
        else:
            prog = EMProgram(estep, mstep, count, start,
                             spec["max_iters"] + 1, capture=False)
            run = prog.run(start, epsilon=eps, **kw)
        runs.append((run, asked))
    (h, h_asked), (d, d_asked) = runs
    assert_states_equal(d.state, h.state)
    assert same_bits(torch.tensor(d.lls), torch.tensor(h.lls))
    assert d.iters == h.iters
    np.testing.assert_array_equal(d.health, h.health)
    assert d_asked == h_asked
    if case == "fatal_mid_loop" or case == "nan_iter":
        assert health.fatal_rows(d.health) and d.iters == 3
    if case == "converges":  # before min_binding's bound, too
        assert d.iters < EM_CASES["min_binding"]["min_iters"]
    if case == "min_binding":
        assert spec["min_iters"] <= d.iters < spec["max_iters"]


def test_eager_private_switch_runs_the_host_loop(blobs, monkeypatch):
    """``GMMModel(_eager_em=True)`` (tests and chip_smoke.py hold the
    captured loop to it) runs ``_em_loop``; the default runs the device
    loop (eagerly on the CPU); both fit bit for bit alike."""
    from cuda_gmm_mpi_tpu_torch.models import gmm as gmm_mod

    calls = []
    host_loop, device_run = gmm_mod._em_loop, EMProgram.run
    monkeypatch.setattr(gmm_mod, "_em_loop", lambda *a, **k: calls.append(
        "host") or host_loop(*a, **k))
    monkeypatch.setattr(EMProgram, "run", lambda *a, **k: calls.append(
        "device") or device_run(*a, **k))
    cfg = tcfg()
    a = fit_gmm(blobs, 8, 3, config=cfg, model=GMMModel(cfg, _eager_em=True))
    assert set(calls) == {"host"}
    calls.clear()
    m = GMMModel(cfg)
    b = fit_gmm(blobs, 8, 3, config=cfg, model=m)
    assert set(calls) == {"device"} and len(calls) == len(b.sweep_log)
    assert not m.captures and not m.capture_log
    assert log_rows(a) == log_rows(b) and a.merges == b.merges
    assert_states_equal(a.state, b.state)
    assert json.dumps(a.health) == json.dumps(b.health)


def test_em_while_loop_runs_the_device_loop(monkeypatch):
    """The public ``em_while_loop`` runs the device-controlled loop
    (``EMProgram``, eagerly on the CPU); ``_eager_em=True`` runs the host
    loop ``_em_loop``; both give the same state, loglik and iterations."""
    from cuda_gmm_mpi_tpu_torch.models import gmm as gmm_mod

    data, _ = make_blobs(np.random.default_rng(3), n=600, d=3, k=3)
    chunks, wts = (torch.as_tensor(a) for a in chunk_events(data, 128))
    state = state_from_numpy(make_state_np(np.random.default_rng(4), 5, 3,
                                           inactive=(4,)))
    eps = convergence_epsilon(*data.shape)
    calls = []
    host_loop, device_run = gmm_mod._em_loop, EMProgram.run
    monkeypatch.setattr(gmm_mod, "_em_loop", lambda *a, **k: calls.append(
        "host") or host_loop(*a, **k))
    monkeypatch.setattr(EMProgram, "run", lambda *a, **k: calls.append(
        "device") or device_run(*a, **k))
    s1, ll1, it1 = gmm_mod.em_while_loop(state, chunks, wts, eps, 2, 60,
                                         precompute_features=True)
    assert calls == ["device"]
    s0, ll0, it0 = gmm_mod.em_while_loop(state, chunks, wts, eps, 2, 60,
                                         precompute_features=True,
                                         _eager_em=True)
    assert calls == ["device", "host"]
    assert_states_equal(s1, s0)
    assert same_bits(torch.tensor(ll1), torch.tensor(ll0))
    assert it1 == it0 and it1 >= 2


def test_mesh_fit_takes_the_host_sweep(blobs, caplog):
    """A mesh model has no fused sweep in this package yet: the fit logs
    the JAX package's blocker line and runs the host-driven sweep."""
    import logging

    logger = logging.getLogger("cuda_gmm_mpi_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        r = fit_gmm(blobs, 8, 3, config=tcfg(fused_sweep=True,
                                             mesh_shape=(1, 1)))
    finally:
        logger.removeHandler(caplog.handler)
    assert ("fused_sweep disabled (model without fused-sweep support "
            "requested); using the host-driven sweep") in caplog.text
    host = fit_gmm(blobs, 8, 3, config=tcfg(mesh_shape=(1, 1)))
    assert log_rows(r) == log_rows(host) and r.merges == host.merges
