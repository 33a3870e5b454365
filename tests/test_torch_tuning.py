"""The port's profile-guided autotuner (``cuda_gmm_mpi_tpu_torch/tuning``)
on the CPU, against the JAX package's (tests/test_tuning.py's contracts).

- The database file is the JAX package's, key for key: a file either
  package writes loads in the other with equal entries, and one DB written
  by the JAX ``TuningDB`` resolves the same ``chunk_size``,
  ``sweep_k_buckets`` and ``restart_batch_size`` and the same ``tune``
  records in both packages (the CPU key is JAX's own ``cpu|cpu``).
- A JAX row that chose ``pallas`` or ``jnp`` is a bad row to the port (its
  backends are ``auto``/``cuda``/``torch``) and counts as absent.
- The ladder: a recorded row beats the probe, the probe beats the static
  model; explicitly passed knobs are never touched; ``autotune='off'``
  keeps every stream and result byte-identical (library and CLI).
- Serving blocks from the DB give bit-identical replies, and the probe's
  candidates are the port's: ``torch``/``cuda`` on the card, ``torch``
  elsewhere. On the card a fit keeps its ``chunk_size`` (K1 reads the
  whole grid in one launch, and a streamed fit's blocks are chunks), and a
  candidate whose probe fails fails the resolution and records no row.
- ``gmm tune``, the fit's ``--autotune``/``--tuning-db`` and
  ``gmm serve --autotune db`` with their exit codes.
"""

import dataclasses
import json

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import GMMConfig as JConfig
from cuda_gmm_mpi_tpu import telemetry as jtelemetry
from cuda_gmm_mpi_tpu.tuning import TuningDB as JTuningDB
from cuda_gmm_mpi_tpu.tuning import TuningKey as JTuningKey
from cuda_gmm_mpi_tpu.tuning import cost as jcost
from cuda_gmm_mpi_tpu.tuning import resolve_fit_config_ex as jresolve
from cuda_gmm_mpi_tpu.tuning.autotune import _platform_key as jkey
from cuda_gmm_mpi_tpu.tuning.probe import candidates_for as jcandidates
from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch import telemetry
from cuda_gmm_mpi_tpu_torch.cli import main as tmain
from cuda_gmm_mpi_tpu_torch.serving import GMMServer, ModelRegistry
from cuda_gmm_mpi_tpu_torch.serving.executor import ScoringExecutor
from cuda_gmm_mpi_tpu_torch.telemetry.schema import validate_stream
from cuda_gmm_mpi_tpu_torch.tuning import (FIT_KNOBS, TuningDB, TuningKey,
                                           explicit_knobs, probe_knob,
                                           resolve_fit_config_ex,
                                           resolve_serving_blocks)
from cuda_gmm_mpi_tpu_torch.tuning import cost
from cuda_gmm_mpi_tpu_torch.tuning import autotune as autotune_mod
from cuda_gmm_mpi_tpu_torch.tuning import probe as probe_mod
from cuda_gmm_mpi_tpu_torch.tuning.autotune import (_platform_key,
                                                    device_key, fit_knobs)

from .conftest import make_blobs

CPU = dict(device="cpu")
SHARED_KNOBS = ("chunk_size", "sweep_k_buckets", "restart_batch_size")
TUNE_FIELDS = ("knob", "chosen", "source", "candidates", "predicted_s",
               "key", "surface", "default", "distance")


class _Sink:
    def __init__(self, records):
        self._records = records

    def write(self, line):
        self._records.append(json.loads(line))

    def flush(self):
        pass


def _blobs(rng, n=500, d=4, dtype=np.float32):
    return make_blobs(rng, n=n, d=d, k=3, dtype=np.float64)[0].astype(dtype)


# ------------------------------------------------------------ db and cost


def test_db_file_is_the_jax_packages_both_ways(tmp_path):
    """Rows recorded by one package load in the other, entry for entry,
    and the same records written by each make the same file."""
    key = ("cpu", "cpu", 20000, 16, 8, "full", "float32")
    for writer, reader, kcls in ((JTuningDB, TuningDB, JTuningKey),
                                 (TuningDB, JTuningDB, TuningKey)):
        p = str(tmp_path / f"{writer.__module__}.json")
        db = writer(p)
        k = kcls.for_shape(*key)
        db.record(k, "chunk_size", 4096, {"wall_per_iter_s": 0.02})
        db.record(k, "chunk_size", 8192, {"wall_per_iter_s": 0.01})
        db.record(k, "serve_max_block", 1024, {"wall_per_iter_s": 0.3},
                  source="bench")
        db.save()
        other = reader.open(p)
        assert other.load_error is None and other.entries == db.entries
        assert other.lookup(TuningKey.from_str(k.as_str()),
                            "chunk_size")["chosen"] == "8192"
    files = sorted(tmp_path.glob("*.json"))
    assert files[0].read_bytes() == files[1].read_bytes()


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cost_model_is_the_jax_packages(platform):
    """The static model's predictions and chunk choice equal the JAX
    package's (its constants are kept as they are)."""
    for n, d, k, cov in ((20000, 16, 8, "full"), (1 << 20, 24, 128, "diag")):
        assert (cost.static_chunk_size(n, d, k, cov, "float32", platform)
                == jcost.static_chunk_size(n, d, k, cov, "float32",
                                           platform))
        for c in cost.chunk_ladder(n, platform):
            assert (cost.predict_iteration_wall(n, d, k, cov, "float32",
                                                platform, c)
                    == jcost.predict_iteration_wall(n, d, k, cov, "float32",
                                                    platform, c))


def test_autotune_field_validated():
    with pytest.raises(ValueError, match="autotune"):
        GMMConfig(autotune="always", **CPU)
    assert GMMConfig(**CPU).autotune == "off"


def test_platform_key_reads_the_torch_device():
    """The CPU key is JAX's own ``cpu|cpu``, so both packages resolve from
    one DB; a CUDA device keys as 'gpu' (cost.py's tables)."""
    cfg = GMMConfig(**CPU)
    assert device_key("cpu") == ("cpu", "cpu")
    assert (_platform_key(cfg, 20000, 16, 8).as_str()
            == jkey(JConfig(), 20000, 16, 8).as_str())


# ---------------------------------------------------------------- ladder


def test_explicit_knob_precedence(tmp_path, rng):
    """A user-pinned knob is never overwritten, even when the DB has a
    measured row saying otherwise."""
    data = _blobs(rng)
    dbp = str(tmp_path / "t.json")
    cfg = GMMConfig(autotune="db", tuning_db=dbp, chunk_size=12345,
                    min_iters=2, max_iters=2, **CPU)
    db = TuningDB(dbp)
    db.record(_platform_key(cfg, *data.shape, 3), "chunk_size", 256,
              {"wall_per_iter_s": 1e-6})
    db.save()
    assert "chunk_size" in explicit_knobs(cfg)
    resolved, decisions = resolve_fit_config_ex(cfg, data, 3)
    assert resolved.chunk_size == 12345
    assert resolved.autotune == "off"  # sub-fits must not re-resolve
    assert "chunk_size" not in {d["knob"] for d in decisions}


def _fake_clock(walls):
    """A deterministic _time_fit: the wall keyed by the chunk size the
    probe wrote into the config."""

    def fake(config, data, num_clusters):
        w = walls[config.chunk_size]
        return w + 0.5, w  # the first call pays a fixed fake compile

    return fake


def test_db_beats_probe_beats_static(tmp_path, monkeypatch, rng):
    """No row: 'db' falls to the static model, 'probe' measures (and
    persists) the row; the next resolution reads it back as a db hit, and
    a recorded row outranks what the probe would measure."""
    data = _blobs(rng, n=40000)
    walls = {16384: 0.03, 32768: 0.01, 65536: 0.02, 131072: 0.04}
    monkeypatch.setattr(probe_mod, "_time_fit", _fake_clock(walls))
    dbp = str(tmp_path / "t.json")
    cfg = GMMConfig(autotune="db", tuning_db=dbp, min_iters=2, max_iters=2,
                    **CPU)
    _, static = resolve_fit_config_ex(cfg, data, 3)
    by = {d["knob"]: d for d in static}
    assert by["chunk_size"]["source"] == "static"
    assert by["estep_backend"] == dict(by["estep_backend"], chosen="torch",
                                       source="static")
    probed, decisions = resolve_fit_config_ex(
        dataclasses.replace(cfg, autotune="probe"), data, 3)
    by = {d["knob"]: d for d in decisions}
    assert by["chunk_size"]["source"] == "probe"
    assert probed.chunk_size == 32768
    again, decisions = resolve_fit_config_ex(
        dataclasses.replace(cfg, autotune="probe"), data, 3)
    assert {d["knob"]: d["source"] for d in decisions}["chunk_size"] == "db"
    db = TuningDB.open(dbp)
    db.record(_platform_key(cfg, *data.shape, 3), "chunk_size", 16384,
              {"wall_per_iter_s": 1e-6}, source="bench")
    db.save()
    resolved, decisions = resolve_fit_config_ex(
        dataclasses.replace(cfg, autotune="probe"), data, 3)
    assert resolved.chunk_size == 16384
    assert {d["knob"]: d["predicted_s"] for d in decisions}[
        "chunk_size"] == pytest.approx(1e-6)


def test_corrupt_row_falls_back_to_static(tmp_path, rng):
    data = _blobs(rng)
    dbp = str(tmp_path / "t.json")
    cfg = GMMConfig(autotune="db", tuning_db=dbp, **CPU)
    db = TuningDB(dbp)
    db.record(_platform_key(cfg, *data.shape, 3), "chunk_size",
              "not-a-number", {"wall_per_iter_s": 0.1})
    db.save()
    _, decisions = resolve_fit_config_ex(cfg, data, 3)
    assert {d["knob"]: d["source"] for d in decisions}[
        "chunk_size"] == "static"


@pytest.mark.parametrize("choice", ["pallas", "jnp"])
def test_jax_backend_row_counts_as_absent(tmp_path, rng, choice):
    """A JAX row that chose a JAX backend is a bad row to the port: the
    port resolves estep_backend as if the DB had no row, while the JAX
    package reads the same row back as a db hit."""
    data = _blobs(rng)
    dbp = str(tmp_path / "t.json")
    jdb = JTuningDB(dbp)
    jdb.record(jkey(JConfig(), *data.shape, 3), "estep_backend", choice,
               {"wall_per_iter_s": 0.01})
    jdb.save()
    cfg = GMMConfig(autotune="db", tuning_db=dbp, **CPU)
    resolved, decisions = resolve_fit_config_ex(cfg, data, 3)
    d = {d["knob"]: d for d in decisions}["estep_backend"]
    assert (d["source"], d["chosen"]) == ("static", "torch")
    assert resolved.estep_backend == "torch"
    _, jdecisions = jresolve(JConfig(autotune="db", tuning_db=dbp), data, 3)
    jd = {d["knob"]: d for d in jdecisions}["estep_backend"]
    assert (jd["source"], jd["chosen"]) == ("db", choice)


def test_one_jax_db_resolves_alike_in_both_packages(tmp_path, rng):
    """One DB written by the JAX TuningDB (a nearest-key row for the chunk
    size, exact rows for the bucketing and the restart batch): both
    packages resolve the same three knobs and emit the same ``tune``
    records for them."""
    data = _blobs(rng, n=3000)
    dbp = str(tmp_path / "t.json")
    jdb = JTuningDB(dbp)
    exact = jkey(JConfig(), *data.shape, 3)
    near = JTuningKey.for_shape("cpu", "cpu", 20000, 4, 3, "full", "float32")
    jdb.record(near, "chunk_size", 2048, {"wall_per_iter_s": 0.002})
    jdb.record(near, "chunk_size", 1024, {"wall_per_iter_s": 0.003})
    jdb.record(exact, "sweep_k_buckets", "off", {"wall_per_iter_s": 0.001})
    jdb.record(exact, "restart_batch_size", 2, {"wall_per_iter_s": 0.004})
    jdb.save()
    common = dict(autotune="db", tuning_db=dbp, n_init=3)
    records = {}
    for name, resolve, cfg, tel in (
            ("port", resolve_fit_config_ex, GMMConfig(**common, **CPU),
             telemetry),
            ("jax", jresolve, JConfig(**common), jtelemetry)):
        stream = []
        rec = tel.RunRecorder(stream=_Sink(stream))
        with tel.use(rec), rec:
            resolved, _ = resolve(cfg, data, 3)
        records[name] = (
            {k: getattr(resolved, k) for k in SHARED_KNOBS},
            [{f: r.get(f) for f in TUNE_FIELDS} for r in stream
             if r["event"] == "tune" and r["knob"] in SHARED_KNOBS])
    assert records["port"] == records["jax"]
    knobs, tune = records["port"]
    assert knobs == {"chunk_size": 2048, "sweep_k_buckets": "off",
                     "restart_batch_size": 2}
    assert [r["source"] for r in tune] == ["db"] * 3
    assert tune[0]["key"] == near.as_str()  # the nearest-key row


# ----------------------------------------------------------------- probe


def test_probe_candidates_are_the_ports():
    """torch/cuda on the card at float32 (torch alone at float64 or in the
    full 'centered' form, which the kernels do not take), torch alone off
    the card; the chunk ladder off the card is the JAX package's, and on
    the card no fit resolves chunk_size."""
    cfg = GMMConfig(**CPU)
    jcfg = JConfig()
    assert probe_mod.candidates_for("estep_backend", cfg, 5000,
                                    "gpu") == ["torch", "cuda"]
    for other in (dict(dtype="float64"), dict(quad_mode="centered")):
        assert probe_mod.candidates_for(
            "estep_backend", dataclasses.replace(cfg, **other), 5000,
            "gpu") == ["torch"]
    assert probe_mod.candidates_for("estep_backend", cfg, 5000,
                                    "cpu") == ["torch"]
    assert fit_knobs("cpu") == FIT_KNOBS
    assert fit_knobs("gpu") == tuple(k for k in FIT_KNOBS
                                     if k != "chunk_size")
    for full in (False, True):
        assert (probe_mod.candidates_for("chunk_size", cfg, 40000, "cpu",
                                         full_ladder=full)
                == jcandidates("chunk_size", jcfg, 40000, "cpu",
                               full_ladder=full))


def test_probe_is_deterministic_and_skips_single_candidates(
        tmp_path, monkeypatch, rng):
    """Two probe runs rank alike (ties toward the smaller candidate); a
    knob with one candidate records nothing."""
    data = _blobs(rng, n=5000)
    walls = {1024: 0.04, 2048: 0.03, 4096: 0.01, 8192: 0.01}
    monkeypatch.setattr(probe_mod, "_time_fit", _fake_clock(walls))
    key = TuningKey.for_shape("cpu", "cpu", 5000, 4, 3, "full", "float32")
    rows = []
    for i in range(2):
        db = TuningDB(str(tmp_path / f"t{i}.json"))
        rows.append(probe_knob(GMMConfig(**CPU), data, 3, key, db,
                               "chunk_size", iters=2, full_ladder=True))
    assert rows[0]["chosen"] == rows[1]["chosen"] == "4096"
    assert list(rows[0]["candidates"]) == list(rows[1]["candidates"])
    prof = rows[0]["candidates"]["4096"]
    assert prof["wall_per_iter_s"] == pytest.approx(0.01 / 2)
    assert prof["compile_s"] == pytest.approx(0.5)
    db = TuningDB(str(tmp_path / "one.json"))
    assert probe_knob(GMMConfig(**CPU), data, 3, key, db, "estep_backend",
                      iters=1) is None
    assert db.entries == {}


def test_failed_probe_candidate_raises_and_records_nothing(
        tmp_path, monkeypatch, rng):
    """A candidate whose probe fit raises (the kernels' build or launch
    failing) fails the resolution: no estep_backend row is written, so no
    later resolution can choose the other candidate in its place."""
    data = _blobs(rng, n=5000)

    def fake(config, data, num_clusters):
        if config.estep_backend == "cuda":
            raise RuntimeError("K1 (fused_stats): CUDA error 209 at launch")
        return 0.5, 0.01

    monkeypatch.setattr(probe_mod, "_time_fit", fake)
    monkeypatch.setattr(probe_mod, "candidates_for",
                        lambda knob, *a, **k: (["torch", "cuda"]
                                               if knob == "estep_backend"
                                               else [4096, 8192]))
    dbp = str(tmp_path / "t.json")
    cfg = GMMConfig(autotune="probe", tuning_db=dbp, min_iters=2,
                    max_iters=2, **CPU)
    with pytest.raises(RuntimeError, match="CUDA error"):
        resolve_fit_config_ex(cfg, data, 3)
    key = _platform_key(cfg, *data.shape, 3)
    db = TuningDB.open(dbp)
    assert db.lookup(key, "chunk_size") is not None
    assert db.lookup(key, "estep_backend") is None
    mem = TuningDB(str(tmp_path / "mem.json"))
    with pytest.raises(RuntimeError):
        probe_knob(cfg, data, 3, key, mem, "estep_backend", iters=2)
    assert mem.entries == {}


def test_card_keeps_chunk_size_and_a_streamed_db_fit_equals_off(
        tmp_path, monkeypatch, rng):
    """Under the card's key a fit resolves no chunk_size, even from a row
    that holds one, so a streamed stepwise-EM fit (whose blocks are
    chunk_size events) under 'db' equals the 'off' fit bit for bit."""
    monkeypatch.setattr(autotune_mod, "device_key",
                        lambda device: ("gpu", "NVIDIA H100 80GB HBM3"))
    data = _blobs(rng, n=40000, dtype=np.float64)
    dbp = str(tmp_path / "t.json")
    base = dict(dtype="float64", min_iters=3, max_iters=3, seed=3,
                stream_events=True, em_mode="minibatch",
                estep_backend="torch", **CPU)
    cfg = GMMConfig(autotune="db", tuning_db=dbp, **base)
    key = _platform_key(cfg, *data.shape, 3)
    assert key.platform == "gpu"
    db = TuningDB(dbp)
    db.record(key, "chunk_size", 16384, {"wall_per_iter_s": 0.001})
    db.save()
    resolved, decisions = resolve_fit_config_ex(cfg, data, 3)
    assert "chunk_size" not in {d["knob"] for d in decisions}
    assert resolved.chunk_size == GMMConfig().chunk_size
    tuned = fit_gmm(data, 3, 3, cfg)
    off = fit_gmm(data, 3, 3, dataclasses.replace(cfg, autotune="off"))
    assert tuned.final_loglik == off.final_loglik
    for f in ("means", "R", "pi", "N"):
        assert np.array_equal(getattr(tuned.state, f), getattr(off.state, f))
    chunked = fit_gmm(data, 3, 3, GMMConfig(chunk_size=16384, **base))
    assert chunked.final_loglik != off.final_loglik  # the row would matter


# ---------------------------------------------------------------- parity


def _strip(records):
    """Stream records without their clocks and run identity (heartbeats are
    the sampler's, on the wall clock, and the summary's metrics are
    timings)."""
    drop = {"ts", "seconds", "run_id", "clock", "clock0", "metrics",
            "compile", "phase_profile"}
    return [{k: v for k, v in r.items() if k not in drop
             and not k.endswith("_s")}
            for r in records if r["event"] != "heartbeat"]


def test_autotune_off_is_byte_identical(tmp_path, rng):
    """'off' with a tuning DB named: the same result and the same stream
    as a config without the fields, and no tune record."""
    data = _blobs(rng)
    runs = {}
    for name, extra in (("plain", {}),
                        ("off", dict(autotune="off",
                                     tuning_db=str(tmp_path / "x.json")))):
        path = str(tmp_path / f"{name}.jsonl")
        r = fit_gmm(data, 4, 2, GMMConfig(min_iters=3, max_iters=3,
                                          chunk_size=256, metrics_file=path,
                                          **extra, **CPU))
        recs = [json.loads(ln) for ln in open(path)]
        assert validate_stream(recs) == []
        assert not any(x["event"] == "tune" for x in recs)
        runs[name] = (r, _strip(recs))
    (a, sa), (b, sb) = runs["plain"], runs["off"]
    assert a.final_loglik == b.final_loglik and a.merges == b.merges
    for f in ("means", "R", "pi", "N"):
        assert np.array_equal(getattr(a.state, f), getattr(b.state, f))
    assert sa == sb


def test_tuned_fit_matches_untuned_fit_with_the_resolved_knobs(tmp_path,
                                                               rng):
    """A float64 'db' fit equals, bit for bit, the untuned fit run with the
    knobs it resolved, and its `tune` records are schema-valid."""
    data = _blobs(rng, n=3000, dtype=np.float64)
    dbp = str(tmp_path / "t.json")
    base = dict(dtype="float64", min_iters=4, max_iters=4, **CPU)
    db = TuningDB(dbp)
    cfg = GMMConfig(autotune="db", tuning_db=dbp, **base)
    db.record(_platform_key(cfg, *data.shape, 4), "chunk_size", 1024,
              {"wall_per_iter_s": 0.001})
    db.save()
    path = str(tmp_path / "m.jsonl")
    tuned = fit_gmm(data, 4, 2, dataclasses.replace(cfg, metrics_file=path))
    recs = [json.loads(ln) for ln in open(path)]
    assert validate_stream(recs) == []
    tune = {r["knob"]: r for r in recs if r["event"] == "tune"}
    assert set(tune) == set(FIT_KNOBS) - {"restart_batch_size"}
    assert tune["chunk_size"]["chosen"] == 1024
    knobs = {k: (None if tune[k]["chosen"] == "auto" else tune[k]["chosen"])
             for k in tune}
    plain = fit_gmm(data, 4, 2, GMMConfig(**base, **knobs))
    assert tuned.final_loglik == plain.final_loglik
    assert tuned.merges == plain.merges
    assert tuned.ideal_num_clusters == plain.ideal_num_clusters
    assert np.array_equal(tuned.state.means, plain.state.means)


def test_serving_blocks_from_the_db_are_bit_identical(tmp_path, rng):
    """Block bounds resolved from a DB row score the same bits as the
    defaults; a torn pair of rows never builds an impossible executor."""
    data = _blobs(rng, n=600)
    gm = GaussianMixture(3, target_components=3, min_iters=4, max_iters=4,
                         chunk_size=256, **CPU).fit(data)
    state = gm.result_.state
    dbp = str(tmp_path / "serve.json")
    db = TuningDB(dbp)
    skey = _platform_key(GMMConfig(**CPU), 65536, 4, 3)
    db.record(skey, "serve_min_block", 64, {"wall_per_iter_s": 0.01},
              source="bench")
    db.record(skey, "serve_max_block", 128, {"wall_per_iter_s": 0.01},
              source="bench")
    db.save()
    blocks, decisions = resolve_serving_blocks("float32", False, 4, 3,
                                               tuning_db=dbp, device="cpu")
    assert blocks == {"min_block": 64, "max_block": 128}
    assert {d["source"] for d in decisions} == {"db"}
    tuned = ScoringExecutor(device="cpu", **blocks)
    plain = ScoringExecutor(device="cpu")
    for a, b in zip(tuned.infer(state, data[:333]),
                    plain.infer(state, data[:333])):
        assert np.array_equal(a, b)
    db.record(skey, "serve_min_block", 4096, {"wall_per_iter_s": 0.001})
    db.save()
    blocks, _ = resolve_serving_blocks("float32", False, 4, 3,
                                       tuning_db=dbp, device="cpu")
    assert blocks["min_block"] <= blocks["max_block"]


def test_server_autotune_db_replies_equal_off(tmp_path, rng):
    """GMMServer(autotune='db') resolves its executor's blocks (one `tune`
    event per block knob on the serve stream) and replies byte for byte
    as 'off' does; 'probe' is refused."""
    data = _blobs(rng, n=600)
    gm = GaussianMixture(3, target_components=3, min_iters=4, max_iters=4,
                         chunk_size=256, **CPU).fit(data)
    reg = ModelRegistry(str(tmp_path / "reg"))
    gm.to_registry(reg, "m")
    dbp = str(tmp_path / "serve.json")
    db = TuningDB(dbp)
    skey = _platform_key(GMMConfig(**CPU), 65536, 4, 3)
    db.record(skey, "serve_min_block", 32, {"wall_per_iter_s": 0.01})
    db.record(skey, "serve_max_block", 64, {"wall_per_iter_s": 0.01})
    db.save()
    reqs = [{"id": i, "model": "m", "op": op, "x": data[a:b].tolist()}
            for i, (op, a, b) in enumerate((
                ("score", 0, 70), ("predict", 70, 290),
                ("predict_proba", 290, 300), ("score_samples", 300, 600)))]
    out = {}
    for mode in ("off", "db"):
        stream = []
        rec = telemetry.RunRecorder(stream=_Sink(stream))
        srv = GMMServer(reg, autotune=mode, tuning_db=dbp, warm=False,
                        executor=None, **CPU)
        with telemetry.use(rec), rec:
            resps = srv.handle_requests(reqs)
        out[mode] = [{k: v for k, v in r.items() if k != "latency_ms"}
                     for r in resps]
        tune = [r for r in stream if r["event"] == "tune"]
        assert len(tune) == (2 if mode == "db" else 0)
        assert all(r["surface"] == "serve" for r in tune)
        ex = srv._executor_for(srv.resolve("m"))
        assert ex.block_for(1000) == (64 if mode == "db" else 1024)
    assert out["db"] == out["off"] and all(r["ok"] for r in out["off"])
    with pytest.raises(ValueError, match="autotune"):
        GMMServer(reg, autotune="probe", **CPU)


# ------------------------------------------------------------- the CLIs


def test_gmm_tune_writes_rows_and_exit_codes(tmp_path, capsys, rng):
    """`gmm tune --device cpu` probes the chunk ladder (estep_backend has
    one candidate here), writes the DB and prints the decision table; bad
    shapes exit 1, a missing infile 2; a fit with --autotune db then
    resolves from the row and emits its tune records."""
    dbp = str(tmp_path / "t.json")
    argv = ["tune", "--n", "2000", "--d", "4", "--k", "3", "--probe-iters",
            "1", "--tuning-db", dbp, "--device", "cpu", "--json"]
    assert tmain(argv) == 0
    out = json.loads(capsys.readouterr().out)
    by = {d["knob"]: d for d in out["decisions"]}
    assert by["chunk_size"]["source"] == "db"
    assert set(by["chunk_size"]["candidates"]) == {"1024", "2048"}
    assert by["estep_backend"]["chosen"] == "torch"
    assert out["key"] == "cpu|cpu|n2048|d4|k4|full|float32"
    assert tmain(["tune", "--k", "0", "--device", "cpu"]) == 1
    assert tmain(["tune", str(tmp_path / "missing.csv"), "--device",
                  "cpu"]) == 2
    data = _blobs(rng, n=2000)
    csv = tmp_path / "ev.csv"
    csv.write_text("\n".join(",".join(f"{v:.6f}" for v in r) for r in data))
    met = str(tmp_path / "m.jsonl")
    assert tmain(["3", str(csv), str(tmp_path / "o"), "3", "--device=cpu",
                  "--min-iters=2", "--max-iters=2", "--autotune=db",
                  "--tuning-db", dbp, "--metrics-file", met]) == 0
    tune = {r["knob"]: r for r in map(json.loads, open(met))
            if r["event"] == "tune"}
    assert tune["chunk_size"]["source"] == "db"
    assert tune["chunk_size"]["chosen"] == int(by["chunk_size"]["chosen"])
    assert tmain(["3", str(csv), str(tmp_path / "p"), "3", "--device=cpu",
                  "--predict-from", str(tmp_path / "o.summary"),
                  "--autotune=db"]) == 1
    capsys.readouterr()


def test_serve_cli_autotune_db_and_off_reply_alike(tmp_path, capsys, rng):
    """`gmm serve --autotune db --tuning-db` runs (it exited 2 before) and
    writes the same replies as `--autotune off`."""
    from cuda_gmm_mpi_tpu_torch.serving.server import serve_main

    data = _blobs(rng, n=600)
    gm = GaussianMixture(3, target_components=3, min_iters=4, max_iters=4,
                         chunk_size=256, **CPU).fit(data)
    reg = str(tmp_path / "reg")
    gm.to_registry(reg, "m")
    dbp = str(tmp_path / "serve.json")
    db = TuningDB(dbp)
    skey = _platform_key(GMMConfig(**CPU), 65536, 4, 3)
    db.record(skey, "serve_max_block", 128, {"wall_per_iter_s": 0.01})
    db.save()
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps(
        {"id": i, "model": "m", "op": "predict_proba",
         "x": data[i * 150:(i + 1) * 150].tolist()}) for i in range(4)))
    outs = {}
    for mode in ("off", "db"):
        out = tmp_path / f"{mode}.jsonl"
        assert serve_main(["--registry", reg, "--input", str(req),
                           "--output", str(out), "--device", "cpu",
                           "--autotune", mode, "--tuning-db", dbp]) == 0
        outs[mode] = [{k: v for k, v in json.loads(ln).items()
                       if k != "latency_ms"}
                      for ln in out.read_text().splitlines()]
    assert outs["db"] == outs["off"] and len(outs["off"]) == 4
    capsys.readouterr()
