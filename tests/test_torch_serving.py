"""The port's serving layer on the CPU, against the JAX package's.

- Registry artifacts cross both packages: the port's ``to_registry`` loads
  in the JAX package (and its estimator scores it), and the JAX package's
  ``to_registry`` of that model loads in the port, with equal npz leaves
  and manifest fields.
- The port's ``ScoringExecutor`` (eager on the CPU) against the JAX one on
  the same state and rows: float64 to 1e-12 relative; float32 to 1e-6 of
  the magnitude of the summed terms (two float32 libraries sum each dot
  product of the expanded form in another order, so an absolute 1e-6 of
  logZ would measure the data's |x|^2 cancellation, not the port).
- The port's own bit-identity contracts (tests/test_serving.py's): the
  registry round trip, a split request, coalesced against solo requests,
  a stacked dispatch against solo dispatches, a hot-reloaded route against
  the version loaded fresh; the executor's counters; pinned routes that
  never stage from the host.
- ``handle_requests`` against the JAX server on one request list (errors
  included), the breaker and the ``serve_nan``/``serve_slow``/
  ``registry_torn`` faults, and ``gmm export``/``gmm serve --device cpu``
  against the JAX CLI.
"""

import json
import os

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import GaussianMixture as JGaussianMixture
from cuda_gmm_mpi_tpu.serving import GMMServer as JServer
from cuda_gmm_mpi_tpu.serving import ModelRegistry as JRegistry
from cuda_gmm_mpi_tpu.serving import ScoringExecutor as JExecutor
from cuda_gmm_mpi_tpu.serving.registry import export_main as jexport_main
from cuda_gmm_mpi_tpu.serving.server import serve_main as jserve_main
from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch import telemetry
from cuda_gmm_mpi_tpu_torch.cli import main as tmain
from cuda_gmm_mpi_tpu_torch.interop import state_to_numpy
from cuda_gmm_mpi_tpu_torch.serving import (GMMServer, ModelRegistry,
                                            RegistryError, ScoringExecutor,
                                            pow2_bucket)
from cuda_gmm_mpi_tpu_torch.serving.executor import executor_for_config
from cuda_gmm_mpi_tpu_torch.telemetry.schema import validate_stream
from cuda_gmm_mpi_tpu_torch.testing import faults

from .conftest import make_blobs

CPU = dict(device="cpu")
FAMILIES = [("float32", False), ("float32", True), ("float64", False),
            ("float64", True)]
FAMILY_IDS = ["f32-full", "f32-diag", "f64-full", "f64-diag"]


@pytest.fixture(scope="module")
def fits():
    """One small fit per (dtype, covariance family), and its rows."""
    rng = np.random.default_rng(1234)
    data, _ = make_blobs(rng, n=600, d=4, k=3)
    out = {}
    for dtype, diag in FAMILIES:
        x = data.astype(dtype)
        gm = GaussianMixture(3, target_components=3, min_iters=4,
                             max_iters=4, chunk_size=256, dtype=dtype,
                             diag_only=diag, **CPU).fit(x)
        out[dtype, diag] = (gm, x)
    return out


def _tol_scale(state, x):
    """Per row, the magnitude of the summed terms of the expanded form's
    logp (the largest cluster's): sum |x_i x_j Rinv_ij| + 2 sum |x_i
    (Rinv mu)_i| + |mu' Rinv mu| + |constant| + |ln pi|."""
    s = state_to_numpy(state)
    x = np.asarray(x, np.float64)
    Rinv, mu = s["Rinv"].astype(np.float64), s["means"].astype(np.float64)
    quad = np.einsum("ni,nj,kij->nk", np.abs(x), np.abs(x), np.abs(Rinv))
    h = np.einsum("kij,kj->ki", Rinv, mu)
    lin = 2 * np.abs(x) @ np.abs(h).T
    rest = (np.abs((h * mu).sum(-1)) + np.abs(s["constant"])
            + np.abs(np.log(np.maximum(s["pi"], 1e-300))))
    return (quad + lin + rest[None, :]).max(axis=1)


def _close(ours, theirs, dtype, scale=None):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    if dtype == "float64":
        np.testing.assert_allclose(ours, theirs, rtol=1e-12,
                                   atol=1e-12 * max(1.0, np.abs(theirs).max()))
    else:
        err = np.abs(ours.astype(np.float64) - theirs)
        bound = 1e-6 * (scale if ours.ndim == 1 else scale.max())
        assert (err <= bound).all(), float((err - bound).max())


def _leaves(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


_VOLATILE = ("created_utc", "source", "train_run_id")


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("dtype,diag", FAMILIES, ids=FAMILY_IDS)
def test_registry_crosses_both_packages(fits, tmp_path, dtype, diag):
    """Port artifact -> JAX load and estimator; the JAX estimator's own
    to_registry -> port load: equal npz leaves and manifests, and both
    estimators score alike."""
    gm, x = fits[dtype, diag]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert gm.to_registry(a, "m") == 1
    jgm = JGaussianMixture.from_registry(a, "m")
    assert jgm.to_registry(b, "m") == 1
    la = _leaves(os.path.join(a, "m", "1", "model.npz"))
    lb = _leaves(os.path.join(b, "m", "1", "model.npz"))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and np.array_equal(la[k], lb[k]), k
    ma = ModelRegistry(a).load("m").manifest
    mb = ModelRegistry(b).load("m").manifest
    assert JRegistry(a).load("m").manifest == ma
    # The JAX estimator re-hydrated from a registry carries no training
    # envelope, so its re-export has no envelope stanza.
    assert "envelope" in ma and "envelope" not in mb
    assert ({k: v for k, v in ma.items() if k not in _VOLATILE + ("envelope",)}
            == {k: v for k, v in mb.items() if k not in _VOLATILE})
    back = GaussianMixture.from_registry(b, "m", config=GMMConfig(**CPU))
    assert back.config.dtype == dtype and back.config.diag_only == diag
    rows = x[:173]
    np.testing.assert_array_equal(back.score_samples(rows),
                                  gm.score_samples(rows))
    scale = _tol_scale(gm.result_.state,
                       rows - gm.result_.data_shift[None, :].astype(dtype))
    _close(gm.score_samples(rows), jgm.score_samples(rows), dtype, scale)
    _close(gm.predict_proba(rows), jgm.predict_proba(rows), dtype, scale)
    assert gm.n_components_ == jgm.n_components_ == back.n_components_


def test_registry_roundtrip_versions_and_walk_back(fits, tmp_path):
    """Versions are monotonic; a torn newest version walks back to the
    previous one with a warning; explicit versions never fall back; bad
    names and manifest lies are loud."""
    gm, x = fits["float32", False]
    reg = ModelRegistry(str(tmp_path))
    assert [gm.to_registry(reg, "m") for _ in range(2)] == [1, 2]
    with open(os.path.join(str(tmp_path), "m", "2", "model.npz"), "wb") as f:
        f.write(b"torn")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert reg.load("m").version == 1
    with pytest.raises(RegistryError):
        reg.load("m", 2)
    with pytest.raises(RegistryError, match="invalid model name"):
        reg.load("../x")
    man = os.path.join(str(tmp_path), "m", "1", "manifest.json")
    doc = json.load(open(man))
    json.dump(dict(doc, k=7), open(man, "w"))
    with pytest.raises(RegistryError, match="manifest says K=7"):
        reg.load("m", 1)


# ---------------------------------------------------------------- executor

@pytest.mark.parametrize("dtype,diag", FAMILIES, ids=FAMILY_IDS)
def test_executor_matches_jax_executor(fits, dtype, diag):
    gm, x = fits[dtype, diag]
    state = gm.result_.state
    j = {k: np.asarray(v) for k, v in state_to_numpy(state).items()}
    from cuda_gmm_mpi_tpu.state import GMMState as JState

    jstate = JState(**j)
    rows = (x - gm.result_.data_shift[None, :].astype(dtype))[:300]
    ours = ScoringExecutor(dtype=dtype, diag_only=diag, min_block=64,
                           max_block=128, **CPU)
    theirs = JExecutor(dtype=dtype, diag_only=diag, min_block=64,
                       max_block=128)
    scale = _tol_scale(state, rows)
    for want in ("proba", "assign"):
        a, z = ours.infer(state, rows, want=want)
        ja, jz = theirs.infer(jstate, rows, want=want)
        assert a.shape == ja.shape and a.dtype == ja.dtype
        _close(z, jz, dtype, scale)
        if want == "proba":
            _close(a, ja, dtype, scale)
        else:
            assert np.array_equal(a, ja)
    assert ours.stats() == theirs.stats()


def test_pow2_bucket_policy():
    assert [pow2_bucket(n) for n in (1, 2, 3, 5, 16, 17)] == \
        [1, 2, 4, 8, 16, 32]
    assert pow2_bucket(3, lo=256) == 256
    assert pow2_bucket(100_000, lo=256, hi=4096) == 4096


def test_executor_counters_lru_and_warm_path(fits):
    """Hits, misses, builds, evictions (an evicted bucket is rebuilt and
    counted); after one warm-up per bucket, varying N builds nothing."""
    gm, x = fits["float32", False]
    state = gm.result_.state
    ex = ScoringExecutor(min_block=32, max_block=256, max_executables=2,
                         **CPU)
    ex.infer(state, x[:20])
    ex.infer(state, x[:60])
    assert (ex.misses, ex.compiles, ex.evictions) == (2, 2, 0)
    ex.infer(state, x[:20])
    assert ex.hits == 1
    ex.infer(state, x[:120])
    assert ex.evictions == 1 and ex.cache_size == 2
    c = ex.compiles
    ex.infer(state, x[:60])
    assert ex.compiles == c + 1
    warm = ScoringExecutor(min_block=32, max_block=256, **CPU)
    for n in (32, 64, 128, 256):
        warm.infer(state, x[:n])
    c0 = warm.compile_count
    for n in np.random.default_rng(0).integers(1, 257, size=60):
        warm.infer(state, x[:int(n)])
    assert warm.compile_count == c0 and warm.hits >= 60
    assert warm.stats()["host_stagings"] == 1 and warm.device_bytes() == 0


def test_executor_split_stack_and_k_pad_are_bit_identical(fits):
    gm, x = fits["float32", False]
    other, _ = fits["float32", True]
    st, st2 = gm.result_.state, other.result_.state
    rows = x - gm.result_.data_shift[None, :].astype(np.float32)
    big = ScoringExecutor(min_block=32, max_block=1024, **CPU)
    small = ScoringExecutor(min_block=32, max_block=64, **CPU)
    for a, b in zip(big.infer(st, rows[:300]), small.infer(st, rows[:300])):
        assert np.array_equal(a, b)
    assert small.padded_rows(300) == 64 * 4 + 64
    outs, block = big.infer_stacked([st, st2], [rows[:40], rows[40:57]])
    assert block == 64
    for (w, z), s, r in ((outs[0], st, rows[:40]),
                         (outs[1], st2, rows[40:57])):
        ws, zs = big.infer(s, r)
        assert np.array_equal(w, ws) and np.array_equal(z, zs)
    route = big._route_for(st, k_bucket=16)
    [(w16, z16)] = big._executable("proba", 64, 16, 4).run(
        [(route, rows[:40])])
    w4, z4 = big.infer(st, rows[:40])
    assert np.array_equal(w16[:, :4], w4) and np.array_equal(z16, z4)
    assert not w16[:, 4:].any()


def test_executor_shares_programs_and_estimator_reuses_buckets(fits):
    gm, x = fits["float32", False]
    gm5 = GaussianMixture(4, target_components=4, min_iters=2, max_iters=2,
                          chunk_size=256, **CPU).fit(x)
    ex = ScoringExecutor(min_block=64, max_block=64, **CPU)
    ex.infer(gm.result_.state, x[:10])
    c0 = ex.compile_count
    ex.infer(gm5.result_.state, x[:10])  # pow2 bucket 4 both
    assert ex.compile_count == c0
    shared = executor_for_config(gm.config)
    gm.score_samples(x[:256])
    c0 = shared.compile_count
    for n in (3, 17, 40, 99, 150, 201, 256):
        gm.predict(x[:n])
        gm.score_samples(x[:n])
        gm.predict_proba(x[:n])
    assert shared.compile_count == c0


def test_pinned_routes_never_stage_and_release_restages(fits):
    gm, _ = fits["float32", False]
    ex = ScoringExecutor(**CPU)
    state = gm.result_.state
    ex.pin_state(state)
    assert ex.stats()["pinned_states"] == 1
    assert ex.prepared_state(state).num_clusters_padded == 4
    assert ex.stats()["host_stagings"] == 0
    assert ex.release_state(state) >= 1
    assert ex.stats()["pinned_states"] == 0
    ex.prepared_state(state)
    assert ex.stats()["host_stagings"] == 1


# ---------------------------------------------------------------- server

def _requests(x, model="m"):
    return [
        {"id": 0, "model": model, "op": "score", "x": x[:7].tolist()},
        {"id": 1, "model": model, "op": "predict", "x": x[7:19].tolist()},
        {"id": 2, "model": model, "op": "predict_proba",
         "x": x[19:22].tolist()},
        {"id": 3, "model": model, "op": "score_samples",
         "x": x[22:41].tolist()},
        {"id": 4, "model": model, "op": "score", "x": x[41:44].tolist()},
    ]


def _drop_latency(resps):
    return [{k: v for k, v in r.items() if k != "latency_ms"}
            for r in resps]


def _same_responses(ours, theirs, dtype, scale):
    assert [r["id"] for r in ours] == [r["id"] for r in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b) and a["ok"] == b["ok"], (a, b)
        for k in a:
            if k in ("latency_ms", "result"):
                continue
            assert a[k] == b[k], k
        if "result" not in a:
            continue
        if isinstance(a["result"], list) and a["result"] and \
                isinstance(a["result"][0], int):
            assert a["result"] == b["result"]
        else:
            ra, rb = np.asarray(a["result"]), np.asarray(b["result"])
            _close(ra.astype(dtype), rb, dtype, scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_handle_requests_matches_the_jax_server(fits, tmp_path, dtype):
    gm, x = fits[dtype, False]
    reg = str(tmp_path)
    gm.to_registry(reg, "m")
    reqs = _requests(x) + [
        {"id": 5, "model": "ghost", "op": "score", "x": x[:2].tolist()},
        {"id": 6, "model": "m", "op": "frobnicate", "x": x[:2].tolist()},
        {"id": 7, "model": "m", "op": "score", "x": [[1.0, 2.0]]},
        {"id": 8, "model": "m", "op": "score", "x": [[1.0, "a"]]},
        {"id": 9, "op": "score", "x": x[:2].tolist()},
        {"id": 10, "model": "m", "op": "ping"},
    ]
    ours = GMMServer(ModelRegistry(reg), **CPU).handle_requests(reqs)
    theirs = JServer(JRegistry(reg)).handle_requests(reqs)
    scale = _tol_scale(gm.result_.state,
                       x[:44] - gm.result_.data_shift[None, :].astype(dtype))
    _same_responses(ours, theirs, dtype, scale.max())
    # coalesced == one request at a time, bit for bit
    srv = GMMServer(ModelRegistry(reg), **CPU)
    assert (_drop_latency(srv.handle_requests(reqs))
            == _drop_latency(srv.handle_requests(reqs, coalesce=False)))


class _StreamSink:
    def __init__(self, records):
        self._records = records

    def write(self, line):
        self._records.append(json.loads(line))

    def flush(self):
        pass


def test_hot_reload_and_pinned_routes(fits, tmp_path):
    """A mid-serve export re-pins the version=None route (its results ==
    a fresh load of v2, bit for bit), the pinned v1 keeps its bits, the
    old state leaves the executor, and warm traffic never stages."""
    gm, x = fits["float32", False]
    reg = ModelRegistry(str(tmp_path))
    gm.to_registry(reg, "m")
    server = GMMServer(reg, **CPU)
    rows = x[:9].tolist()

    def ask(srv, **extra):
        return srv.handle_requests([{"id": 0, "model": "m",
                                     "op": "score_samples", "x": rows,
                                     **extra}])[0]

    r1 = ask(server)
    assert server.executor_stats()["host_stagings"] == 0
    assert server.maybe_reload() == []
    gm2 = GaussianMixture.from_registry(reg, "m", config=GMMConfig(**CPU))
    gm2.result_.state = gm2.result_.state.replace(
        means=gm2.result_.state.means + 0.5)
    reg.save("m", gm2.result_, config=gm2.config)
    old = server._models[("m", None)]
    stream = []
    rec = telemetry.RunRecorder(stream=_StreamSink(stream))
    with telemetry.use(rec):
        swaps = server.maybe_reload()
    assert swaps == [{"model": "m", "from_version": 1, "to_version": 2}]
    ex = server._executor_for(old)
    assert not any(v[0] is old.state for v in ex._state_memo.values())
    r2 = ask(server)
    fresh = ask(GMMServer(reg, **CPU), version=2)
    assert r2["version"] == 2 and r2["result"] == fresh["result"]
    assert ask(server, version=1)["result"] == r1["result"]
    assert validate_stream(stream) == []


def test_stacked_dispatch_matches_solo_and_isolates_poison(fits, tmp_path):
    gm, x = fits["float32", False]
    reg = ModelRegistry(str(tmp_path))
    gm.to_registry(reg, "m1")
    gm5 = GaussianMixture(5, target_components=5, min_iters=2, max_iters=2,
                          chunk_size=256, **CPU).fit(x)
    gm5.to_registry(reg, "m2")
    reqs = [{"id": 0, "model": "m1", "op": "score_samples",
             "x": x[:40].tolist()},
            {"id": 1, "model": "m2", "op": "predict_proba",
             "x": x[40:57].tolist()},
            {"id": 2, "model": "m1", "op": "predict", "x": x[60:85].tolist()},
            {"id": 3, "model": "m2", "op": "score", "x": x[90:130].tolist()}]
    stacked = GMMServer(reg, warm=False, stack_models=True, **CPU)
    got = stacked.handle_requests(reqs)
    want = GMMServer(reg, warm=False, **CPU).handle_requests(
        reqs, coalesce=False)
    assert stacked.stacked_batches == 1
    assert _drop_latency(got) == _drop_latency(want)
    with faults.use({"serve_nan": {"model": "m2", "times": 1}}) as plan:
        got = stacked.handle_requests(reqs)
    assert plan.fired["serve_nan"] == 1
    assert [r["ok"] for r in got] == [True, False, True, False]
    assert got[1]["error"] == "non_finite_scores"
    assert _drop_latency([got[0], got[2]]) == _drop_latency(
        [want[0], want[2]])


def test_breaker_opens_on_poison_and_registry_torn_walks_back(fits,
                                                              tmp_path):
    gm, x = fits["float32", False]
    reg = ModelRegistry(str(tmp_path))
    gm.to_registry(reg, "m")
    gm.to_registry(reg, "m")
    server = GMMServer(reg, breaker_threshold=2, breaker_backoff_s=60.0,
                       **CPU)
    ask = lambda: server.handle_requests([{"id": 0, "model": "m",
                                           "op": "score",
                                           "x": x[:5].tolist()}])[0]
    with faults.use({"serve_nan": {"model": "m", "times": 2}}):
        assert [ask()["error"] for _ in range(2)] == ["non_finite_scores"] * 2
    assert ask()["error"] == "circuit_open"
    assert server.breaker.stats()["trips"] == 1
    stream = []
    rec = telemetry.RunRecorder(stream=_StreamSink(stream))
    with telemetry.use(rec), faults.use(
            {"registry_torn": {"name": "m", "version": 2}}) as plan, \
            pytest.warns(RuntimeWarning, match="falling back"):
        fresh = GMMServer(reg, **CPU)
        r = fresh.handle_requests([{"id": 1, "model": "m", "op": "score",
                                    "x": x[:5].tolist()}])[0]
    assert plan.fired["registry_torn"] == 1
    assert r["ok"] and r["version"] == 1
    assert [e["event"] for e in stream].count("registry_torn") == 1
    # serve_slow delays the coalesced tick without changing its bits
    reqs = _requests(x)
    base = _drop_latency(GMMServer(reg, **CPU).handle_requests(reqs))
    with faults.use({"serve_slow": {"ms": 30, "model": "m"}}):
        slow = GMMServer(reg, **CPU).handle_requests(reqs)
    assert _drop_latency(slow) == base


# ---------------------------------------------------------------- CLIs

def _jsonl(path, reqs):
    with open(path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")


def test_export_and_serve_clis_match_the_jax_clis(fits, tmp_path, capsys):
    """``gmm export --summary``/``--checkpoint`` and ``gmm serve --input
    --output --device cpu`` in both packages on the same inputs."""
    from cuda_gmm_mpi_tpu_torch.io import write_summary

    gm, x = fits["float32", False]
    ck = str(tmp_path / "ck")
    res = fit_gmm(x, 5, 0, config=GMMConfig(min_iters=2, max_iters=2,
                                            chunk_size=256,
                                            checkpoint_dir=ck, **CPU))
    summary = str(tmp_path / "model.summary")
    write_summary(summary, res)
    regs = {p: str(tmp_path / f"reg_{p}") for p in ("t", "j")}
    for p, main in (("t", tmain), ("j", None)):
        for src, name in (("--checkpoint", "a"), ("--summary", "b")):
            arg = ck if src == "--checkpoint" else summary
            argv = ["--registry", regs[p], "--name", name, src, arg]
            rc = (main(["export"] + argv + ["--device", "cpu"]) if main
                  else jexport_main(argv))
            assert rc == 0
    out = capsys.readouterr().out
    assert out.count("exported 'a' version 1") == 2
    for name in ("a", "b"):
        mt = ModelRegistry(regs["t"]).load(name).manifest
        mj = JRegistry(regs["j"]).load(name).manifest
        drop = _VOLATILE + ("checkpoint_dir", "summary_path")
        assert ({k: v for k, v in mt.items() if k not in drop}
                == {k: v for k, v in mj.items() if k not in drop})
    assert ModelRegistry(regs["t"]).load("a").k == res.ideal_num_clusters
    assert tmain(["export", "--registry", regs["t"], "--name", "c",
                  "--checkpoint", str(tmp_path / "none"), "--device",
                  "cpu"]) == 1

    gm.to_registry(regs["t"], "m")
    reqs = _requests(x) + [{"id": 5, "model": "ghost", "op": "score",
                            "x": x[:2].tolist()}]
    req_file = str(tmp_path / "req.jsonl")
    _jsonl(req_file, reqs)
    outs = {}
    for p, serve in (("t", ["serve"]), ("j", None)):
        o = str(tmp_path / f"resp_{p}.jsonl")
        argv = ["--registry", regs["t"], "--input", req_file, "--output", o,
                "--models", "m", "--device", "cpu"]
        rc = tmain(serve + argv) if serve else jserve_main(argv)
        assert rc == 0
        outs[p] = sorted((json.loads(ln) for ln in open(o)),
                         key=lambda r: r["id"])
    scale = _tol_scale(gm.result_.state,
                       x[:44] - gm.result_.data_shift[None, :])
    _same_responses(outs["t"], outs["j"], "float32", scale.max())


def test_serve_cli_refuses_what_this_package_lacks(tmp_path, capsys):
    """The serve CLI takes the tuning and lifecycle flags now; what it
    refuses, with a usage error, is what no serving loop has: the probe
    rung of --autotune, --lifecycle without the drift alarms it consumes,
    and a policy it cannot read."""
    base = ["serve", "--registry", str(tmp_path), "--device", "cpu"]
    for extra in (["--autotune", "probe"],
                  ["--lifecycle", "p.json"],
                  ["--lifecycle", str(tmp_path / "missing.json"),
                   "--drift-interval-s", "1"]):
        with pytest.raises(SystemExit) as e:
            tmain(base + extra)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'probe'" in err
    assert "requires --drift-interval-s" in err
    assert "cannot read lifecycle policy" in err
