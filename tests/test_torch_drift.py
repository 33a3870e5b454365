"""``gmm drift`` in the port against the JAX package's, and the port
server's drift plane.

On the same registry (a float64 fit of the port with its training
envelope) and the same BIN datasets, the two CLIs give the same verdict:
PSI, KS and occupancy L1 to 1e-9, the same window rows, failures and exit
codes (0 clean, 1 a gate tripped, 2 a usage error); ``--rebuild-envelope``
leaves model.npz and manifest.json byte-identical. A serve stream recorded
by the port's drift plane re-aggregates in both CLIs alike.
"""

import hashlib
import json

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.telemetry.drift import drift_main as jdrift
from cuda_gmm_mpi_tpu_torch import GaussianMixture, telemetry
from cuda_gmm_mpi_tpu_torch.cli import main as tmain
from cuda_gmm_mpi_tpu_torch.io import write_bin
from cuda_gmm_mpi_tpu_torch.serving import GMMServer, ModelRegistry

from .conftest import make_blobs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drift")
    data, _ = make_blobs(np.random.default_rng(1234), n=600, d=4, k=3)
    gm = GaussianMixture(3, target_components=3, min_iters=4, max_iters=4,
                         chunk_size=256, dtype="float64", device="cpu")
    gm.fit(data)
    reg = str(tmp / "reg")
    gm.to_registry(reg, "m")
    paths = {}
    for name, shift in (("in", 0.0), ("shifted", 8.0)):
        paths[name] = str(tmp / f"{name}.bin")
        write_bin(paths[name], (data + shift).astype(np.float32))
    return dict(reg=reg, data=data, gm=gm, tmp=tmp, **paths)


def _both(argv, capsys):
    """(exit codes, outputs) of the port's and the JAX package's CLI."""
    rc_t = tmain(["drift"] + argv)
    out_t = capsys.readouterr().out
    rc_j = jdrift(argv)
    out_j = capsys.readouterr().out
    return (rc_t, rc_j), (out_t, out_j)


def _same_verdict(a, b):
    for k in ("psi", "ks", "occupancy_l1"):
        assert abs(a[k] - b[k]) <= 1e-9 * max(1.0, abs(b[k])), k
    rest = lambda v: {k: x for k, x in v.items()
                      if k not in ("psi", "ks", "occupancy_l1")}
    assert rest(a) == rest(b)


@pytest.mark.parametrize("target,gates", [
    ("in", ["--fail-on", "psi>0.2"]),
    ("shifted", ["--fail-on", "psi>0.2", "--fail-on", "ks>0.5"]),
    ("shifted", []),
])
def test_dataset_verdicts_match_the_jax_cli(world, capsys, target, gates):
    argv = [world[target], "--registry", world["reg"], "--model", "m",
            "--device", "cpu", "--json"] + gates
    (rc_t, rc_j), (out_t, out_j) = _both(argv, capsys)
    assert rc_t == rc_j == (1 if target == "shifted" and gates else 0)
    vt, vj = json.loads(out_t), json.loads(out_j)
    _same_verdict(vt, vj)
    assert vt["train_rows"] == 600 and vt["window_rows"] == 600


def test_usage_errors_and_rebuild_match_the_jax_cli(world, capsys):
    w = world
    base = ["--registry", w["reg"], "--device", "cpu"]
    for argv in ([w["in"], "--model", "m", "--fail-on", "bogus>1"],
                 [w["in"], "--model", "m", "--fail-on", "psi>10%"],
                 [w["in"]], [w["in"], "--model", "ghost"],
                 [str(w["tmp"] / "missing.bin"), "--model", "m"]):
        (rc_t, rc_j), (out_t, out_j) = _both(argv + base, capsys)
        assert rc_t == rc_j == 2, argv
        assert out_t == out_j, argv
    bare = GaussianMixture(3, target_components=3, min_iters=2, max_iters=2,
                           chunk_size=256, dtype="float64", device="cpu",
                           envelope=False).fit(w["data"])
    bare.to_registry(w["reg"], "bare")
    (rc_t, rc_j), (out_t, _) = _both(
        [w["in"], "--model", "bare", "--fail-on", "psi>0.2"] + base, capsys)
    assert rc_t == rc_j == 2 and "--rebuild-envelope" in out_t
    vdir = w["tmp"] / "reg" / "bare" / "1"
    before = {f: hashlib.sha256((vdir / f).read_bytes()).hexdigest()
              for f in ("model.npz", "manifest.json")}
    assert tmain(["drift", w["in"], "--model", "bare", "--rebuild-envelope",
                  "--json"] + base) == 0
    rebuilt = json.loads(capsys.readouterr().out)
    assert rebuilt["rebuilt"] and rebuilt["envelope"]["rows"] == 600
    after = {f: hashlib.sha256((vdir / f).read_bytes()).hexdigest()
             for f in ("model.npz", "manifest.json")}
    assert after == before
    (rc_t, rc_j), (out_t, out_j) = _both(
        [w["in"], "--model", "bare", "--json", "--fail-on", "psi>0.2"]
        + base, capsys)
    assert rc_t == rc_j == 0
    _same_verdict(json.loads(out_t), json.loads(out_j))


def test_serve_drift_stream_reaggregates_alike(world, tmp_path, capsys):
    """The port server's drift plane on shifted traffic: drift windows and
    an alarm on the stream; both CLIs merge the windows into one verdict."""
    w = world
    server = GMMServer(ModelRegistry(w["reg"]), drift_interval_s=3600.0,
                       drift_psi_threshold=0.2, device="cpu")
    stream = str(tmp_path / "serve.jsonl")
    rec = telemetry.RunRecorder(path=stream, run_id="drift-torch")
    shifted = w["data"] + 8.0
    with telemetry.use(rec), rec:
        for window in range(2):
            server.handle_requests([
                {"id": i, "model": "m", "op": "score_samples",
                 "x": shifted[40 * i:40 * (i + 1)].tolist()}
                for i in range(6)])
            rows = server.flush_drift()
            assert rows and rows[0]["alarm"]
    assert server.drift_stats()["alarms"] == 2
    argv = [stream, "--registry", w["reg"], "--fail-on", "psi>0.2", "--json"]
    (rc_t, rc_j), (out_t, out_j) = _both(argv, capsys)
    assert rc_t == rc_j == 1
    vt, vj = json.loads(out_t), json.loads(out_j)
    _same_verdict(vt, vj)
    assert vt["window_rows"] == 480 and vt["source"] == "stream"
