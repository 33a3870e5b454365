"""The port's closed-loop lifecycle (``cuda_gmm_mpi_tpu_torch/lifecycle``)
on the CPU, against the JAX package's (tests/test_lifecycle.py's contracts).

- The policy is the JAX package's, defaults and refusals alike.
- On one request stream, with a fixed clock, the port's controller takes
  the JAX controller's decisions edge for edge: debounced drift alarm ->
  stepwise-EM retrain from the request spool -> canary gates + a
  duplicate-dispatch shadow window -> promote through the hot reload ->
  watch -> cooldown -> idle, and a post-promotion score regression rolls
  back to the prior version, whose replies are then bit-identical to the
  replies before the promotion.
- A failed retrain (``retrain_fail``) and a rejected canary
  (``canary_regression``) leave every reply byte unchanged; a torn
  promotion is retried on the next tick; a bound controller that never
  fires changes nothing.
- ``gmm lifecycle`` (exit 0 / 1 / 2, as the JAX CLI on the same inputs)
  and ``gmm serve --lifecycle`` (which exited 2 before).

Both packages serve one registry artifact (the JAX package's export of one
fitted mixture), each from its own copy of the registry.
"""

import json
import shutil

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import GMMConfig as JConfig
from cuda_gmm_mpi_tpu import GaussianMixture as JGaussianMixture
from cuda_gmm_mpi_tpu import lifecycle as jlifecycle
from cuda_gmm_mpi_tpu import serving as jserving
from cuda_gmm_mpi_tpu import telemetry as jtelemetry
from cuda_gmm_mpi_tpu.cli import main as jmain
from cuda_gmm_mpi_tpu_torch import telemetry
from cuda_gmm_mpi_tpu_torch.cli import main as tmain
from cuda_gmm_mpi_tpu_torch.lifecycle import (LifecycleController,
                                              LifecycleError,
                                              LifecyclePolicy)
from cuda_gmm_mpi_tpu_torch.lifecycle import controller as controller_mod
from cuda_gmm_mpi_tpu_torch.serving import GMMServer, ModelRegistry
from cuda_gmm_mpi_tpu_torch.telemetry.schema import validate_stream
from cuda_gmm_mpi_tpu_torch.testing import faults

from .conftest import make_blobs

SPEC = {
    "debounce_alarms": 1,
    "cooldown_s": 0.0,
    "holdout_rows": 128,
    "retrain": {"steps": 3, "min_rows": 64, "chunk_size": 256,
                "backoff_base_s": 0.0, "backoff_max_s": 0.0},
    # A drift-adapting candidate scores a drifted holdout very differently;
    # the tests gate on the regression arm.
    "canary": {"max_psi": 100.0, "max_ks": 1.0, "shadow_ticks": 2},
    "watch": {"probation_ticks": 2, "probation_s": 0.0, "min_rows": 10},
}
# The edge fields both controllers must agree on (the gate values are
# float32 scores of two libraries, held by the edges they decide).
EDGE_FIELDS = ("phase", "outcome", "version", "candidate_version",
               "from_version", "to_version", "reason", "attempt",
               "shadow_ticks", "shadow_rows")


class _Sink:
    def __init__(self, records):
        self._records = records

    def write(self, line):
        self._records.append(json.loads(line))

    def flush(self):
        pass


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One fitted mixture exported to a registry by the JAX package, and
    its training rows."""
    gen = np.random.default_rng(7)
    data, _ = make_blobs(gen, n=600, d=4, k=3, dtype=np.float64)
    data = data.astype(np.float32)
    gm = JGaussianMixture(3, target_components=3, config=JConfig(
        min_iters=4, max_iters=4, chunk_size=256, dtype="float32"))
    gm.fit(data)
    root = tmp_path_factory.mktemp("artifact") / "reg"
    gm.to_registry(str(root), "m")
    return root, data


def _spec(**over):
    spec = json.loads(json.dumps(SPEC))
    for key, val in over.items():
        if isinstance(val, dict):
            spec.setdefault(key, {}).update(val)
        else:
            spec[key] = val
    return spec


def world(artifact, tmp_path, jax=False, **over):
    """A fresh registry copy + controller + drift-enabled server, of the
    port (default) or of the JAX package."""
    src, _ = artifact
    root = tmp_path / ("jreg" if jax else "reg")
    shutil.copytree(src, root)
    if jax:
        reg = jserving.ModelRegistry(str(root))
        ctl = jlifecycle.LifecycleController(
            reg, jlifecycle.LifecyclePolicy(_spec(**over)))
        server = jserving.GMMServer(reg, warm=False, drift_interval_s=3600.0,
                                    drift_psi_threshold=0.2, lifecycle=ctl)
    else:
        reg = ModelRegistry(str(root))
        ctl = LifecycleController(reg, LifecyclePolicy(_spec(**over)),
                                  device="cpu")
        server = GMMServer(reg, warm=False, drift_interval_s=3600.0,
                           drift_psi_threshold=0.2, lifecycle=ctl,
                           device="cpu")
    return reg, ctl, server


def traffic(server, data, shift=0.0, requests=12, rows=40, start=0):
    """Replies, latency scrubbed (the wall clock is not payload)."""
    outs = []
    for i in range(requests):
        lo = ((start + i) * 17) % (len(data) - rows)
        x = (data[lo:lo + rows] + np.float32(shift)).tolist()
        resp = server.handle_requests(
            [{"id": i, "model": "m", "op": "score_samples", "x": x}])[0]
        assert resp["ok"], resp
        outs.append(json.dumps({k: v for k, v in resp.items()
                                if k != "latency_ms"}, sort_keys=True))
    return outs


class _Clock:
    """The controllers' clock (their module's ``time``), set by the test:
    alarms, ticks, backoffs and windows all read it."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(controller_mod, "time", c)
    monkeypatch.setattr(jlifecycle.controller, "time", c)
    return c


def edges(stream):
    return [{f: r[f] for f in EDGE_FIELDS if f in r}
            for r in stream if r["event"] == "lifecycle"]


def test_policy_is_the_jax_packages(tmp_path):
    """The same knobs and defaults, and the same loud refusals."""
    assert controller_mod._DEFAULTS == jlifecycle.controller._DEFAULTS
    p = LifecyclePolicy({"models": ["m"], "retrain": {"steps": 5}})
    assert p.models == ["m"] and p.retrain["steps"] == 5
    assert p.retrain["retries"] == 3
    for bad, match in (({"debounce": 1}, "unknown lifecycle policy"),
                       ({"retrain": {"setps": 5}}, "retrain.'setps'"),
                       ({"canary": 3}, "must be an object"),
                       ({"retrain": {"min_rows": 0}}, "min_rows")):
        with pytest.raises(LifecycleError, match=match):
            LifecyclePolicy(bad)
    pol = tmp_path / "p.json"
    pol.write_text("[1, 2]")
    with pytest.raises(LifecycleError, match="JSON object"):
        LifecyclePolicy.from_file(str(pol))


def _arc(reg, ctl, server, data, clock):
    """Drift -> retrain -> canary -> promote -> watch -> cooldown -> idle,
    then a second arc whose watch sees a regression and rolls back; the
    clock moves one second per tick. Returns (states after each tick, the
    probe's replies under v2, which the second arc promoted over, and after
    the rollback that re-publishes it)."""
    states = []

    def tick():
        clock.t += 1.0
        ctl.on_tick()
        states.append(ctl.stats()["routes"]["m"])

    traffic(server, data, shift=8.0)
    server.flush_drift()
    tick()                                     # refit + holdout gates
    traffic(server, data, shift=8.0, requests=2, start=50)  # shadow
    tick()                                     # canary -> promote
    traffic(server, data, shift=8.0, requests=3, start=80)
    tick()                                     # probation closes clean
    tick()                                     # cooldown_s=0 -> idle
    assert server.resolve("m").version == 2
    probe_before = traffic(server, data, requests=1, start=7)
    # second arc: drift on v2, then a far-worse distribution in probation
    traffic(server, data, shift=-8.0)
    server.flush_drift()
    tick()                                     # -> canary
    traffic(server, data, shift=-8.0, requests=2, start=50)
    tick()                                     # -> watch (v3)
    traffic(server, data, shift=300.0, requests=3, start=100)
    tick()                                     # -> rollback
    probe_after = traffic(server, data, requests=1, start=7)
    return states, probe_before, probe_after


def test_same_decisions_as_the_jax_controller(artifact, tmp_path, clock):
    """One stream, a fixed clock: the port's controller takes the JAX
    controller's edges, counts and registry moves; its stream is
    schema-valid; after the rollback a fixed probe scores bit-identically
    to its replies under the version rolled back to."""
    _, data = artifact
    out = {}
    for name, tel, jax in (("port", telemetry, False),
                           ("jax", jtelemetry, True)):
        reg, ctl, server = world(artifact, tmp_path, jax=jax)
        stream = []
        rec = tel.RunRecorder(stream=_Sink(stream))
        with tel.use(rec), rec:
            states, before, after = _arc(reg, ctl, server, data, clock)
        out[name] = dict(states=states, edges=edges(stream),
                         counts=dict(ctl.counts),
                         versions=reg.versions("m"),
                         stages=[reg.stage("m", v) for v in (2, 3)],
                         served=server.resolve("m").version)
        if not jax:
            assert validate_stream(stream) == []
            b, a = json.loads(before[0]), json.loads(after[0])
            assert b.pop("version") == 2 and a.pop("version") == 4
            assert a == b
            man = reg.load("m", 2).manifest
            assert man["source"] == "lifecycle" and man["retrain_of"] == 1
    assert out["port"] == out["jax"]
    port = out["port"]
    assert port["states"] == ["canary", "watch", "cooldown", "idle",
                              "canary", "watch", "cooldown"]
    assert port["counts"] == {"retrains": 2, "canaries": 2, "promotes": 2,
                              "rollbacks": 1, "quarantines": 1}
    assert port["versions"] == [1, 2, 4] and port["served"] == 4
    assert port["stages"] == ["live", "quarantined"]
    assert [(e["phase"], e.get("outcome")) for e in port["edges"]][-3:] == [
        ("watch", "violated"), ("rollback", None), ("quarantine", None)]


@pytest.mark.parametrize("fault", ["retrain_fail", "canary_regression"])
def test_failed_retrain_or_rejected_canary_leaves_replies_unchanged(
        artifact, tmp_path, clock, fault):
    """The serving path is never touched: a retrain that keeps failing
    (retried with backoff, then the attempt quarantined) or a candidate
    the canary rejects (quarantined on disk) leaves every reply byte as it
    was."""
    _, data = artifact
    reg, ctl, server = world(artifact, tmp_path, cooldown_s=600.0)
    stream = []
    rec = telemetry.RunRecorder(stream=_Sink(stream))
    plan = {fault: {"model": "m", "times": 99 if fault == "retrain_fail"
                    else 1}}
    with telemetry.use(rec), rec:
        before = traffic(server, data, shift=8.0)
        with faults.use(plan) as f:
            server.flush_drift()
            for _ in range(10):
                clock.t += 1.0
                ctl.on_tick()
            assert f.fired.get(fault)
        after = traffic(server, data, shift=8.0)
    assert after == before
    st = ctl.stats()
    assert st["quarantines"] == 1 and st["promotes"] == 0
    assert st["routes"]["m"] == "cooldown"
    assert reg.versions("m") == [1] and server.resolve("m").version == 1
    ev = [e for e in stream if e["event"] == "lifecycle"]
    if fault == "retrain_fail":
        assert reg.versions("m", include_candidates=True) == [1]
        retries = [e for e in ev if e.get("outcome") == "retry"]
        assert len(retries) == 3
        assert "retrain_exhausted" in ev[-1]["reason"]
    else:
        assert reg.stage("m", 2) == "quarantined"
        rej = [e for e in ev if e.get("outcome") == "rejected"]
        assert len(rej) == 1 and rej[0]["regression"] > rej[0]["tolerance"]
    assert validate_stream(stream) == []


def test_torn_promotion_retries_on_the_next_tick(artifact, tmp_path,
                                                clock):
    _, data = artifact
    reg, ctl, server = world(artifact, tmp_path, canary={"shadow_ticks": 1})
    traffic(server, data, shift=8.0)
    with faults.use({"promote_torn": {"name": "m", "times": 1}}):
        server.flush_drift()
        ctl.on_tick()                          # retrain -> canary
        traffic(server, data, shift=8.0, requests=1, start=50)
        clock.t += 1.0
        ctl.on_tick()                          # promote: torn
    assert ctl.stats()["routes"]["m"] == "canary"
    assert reg.versions("m") == [1] and server.resolve("m").version == 1
    clock.t += 1.0
    ctl.on_tick()                              # the retry completes
    assert ctl.stats()["routes"]["m"] == "watch"
    assert server.resolve("m").version == 2


def test_bound_idle_controller_changes_nothing(artifact, tmp_path):
    """A bound controller that never fires adds no event and changes no
    reply byte against an unbound server on in-distribution traffic."""
    src, data = artifact
    root = tmp_path / "reg"
    shutil.copytree(src, root)
    reg = ModelRegistry(str(root))

    def run(lifecycle):
        server = GMMServer(reg, warm=False, drift_interval_s=3600.0,
                           drift_psi_threshold=0.2, lifecycle=lifecycle,
                           device="cpu")
        stream = []
        rec = telemetry.RunRecorder(stream=_Sink(stream))
        with telemetry.use(rec), rec:
            replies = traffic(server, data)
            server.flush_drift()
        return replies, [r["event"] for r in stream]

    ctl = LifecycleController(reg, LifecyclePolicy({"debounce_alarms": 1}),
                              device="cpu")
    assert run(ctl) == run(None)
    assert ctl.stats()["routes"] == {"m": "idle"}


def test_gmm_lifecycle_cli_exit_codes_as_the_jax_cli(artifact, tmp_path,
                                                     capsys):
    """Offline over a recorded stream: both CLIs promote (exit 0) with the
    same verdict; injected retrain failures quarantine (exit 1); an
    unknown policy knob is a usage error (exit 2)."""
    src, data = artifact
    stream_path = tmp_path / "serve.jsonl"
    with open(stream_path, "w") as f:
        for t in (1.0, 2.0):
            f.write(json.dumps({"event": "drift_alarm", "t": t,
                                "model": "m", "version": 1,
                                "psi": 9.9, "threshold": 0.2}) + "\n")
        f.write('{"torn tail')                 # live streams end torn
    shifted = data + np.float32(8.0)
    bin_path = tmp_path / "shift.bin"
    with open(bin_path, "wb") as f:
        np.asarray(shifted.shape, np.int32).tofile(f)
        shifted.astype(np.float32).tofile(f)
    pol = tmp_path / "policy.json"
    pol.write_text(json.dumps({
        "debounce_alarms": 2, "cooldown_s": 1.0,
        "retrain": {"steps": 3, "min_rows": 64},
        "canary": {"max_psi": 100.0, "max_ks": 1.0}}))
    verdicts = {}
    for name, main, extra in (("port", tmain, ["--device", "cpu"]),
                              ("jax", jmain, [])):
        root = tmp_path / f"{name}_reg"
        shutil.copytree(src, root)
        out = tmp_path / f"{name}.jsonl"
        assert main(["lifecycle", str(stream_path), "--registry", str(root),
                     "--policy", str(pol), "--data", str(bin_path), "--out",
                     str(out), "--json"] + extra) == 0
        verdicts[name] = json.loads(capsys.readouterr().out.strip())
        if name == "port":
            assert validate_stream([json.loads(ln) for ln in open(out)
                                    if ln.strip()]) == []
            with faults.use({"retrain_fail": {"model": "m", "times": 99}}):
                assert main(["lifecycle", str(stream_path), "--registry",
                             str(root), "--policy", str(pol), "--data",
                             str(bin_path)] + extra) == 1
            assert "quarantine" in capsys.readouterr().out
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"]["counts"]["promotes"] == 1
    assert verdicts["port"]["routes"]["m"]["live_versions"] == [1, 2]
    pol.write_text(json.dumps({"debounce": 1}))
    assert tmain(["lifecycle", str(stream_path), "--registry",
                  str(tmp_path / "port_reg"), "--policy", str(pol),
                  "--device", "cpu"]) == 2
    assert "unknown lifecycle policy" in capsys.readouterr().err


def test_serve_cli_lifecycle_flag(artifact, tmp_path, capsys):
    """`gmm serve --lifecycle` needs the drift plane and a valid policy
    (usage errors, exit 2); with both it serves (exit 0)."""
    from cuda_gmm_mpi_tpu_torch.serving.server import serve_main

    src, data = artifact
    root = tmp_path / "reg"
    shutil.copytree(src, root)
    pol = tmp_path / "p.json"
    pol.write_text(json.dumps({"debounce_alarms": 1}))
    with pytest.raises(SystemExit) as e:
        serve_main(["--registry", str(root), "--lifecycle", str(pol),
                    "--device", "cpu"])
    assert e.value.code == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nope": 1}))
    with pytest.raises(SystemExit) as e:
        serve_main(["--registry", str(root), "--lifecycle", str(bad),
                    "--drift-interval-s", "3600", "--device", "cpu"])
    assert e.value.code == 2
    req = tmp_path / "req.jsonl"
    req.write_text(json.dumps({"id": 0, "model": "m", "op": "score",
                               "x": data[:50].tolist()}))
    out = tmp_path / "out.jsonl"
    assert serve_main(["--registry", str(root), "--lifecycle", str(pol),
                       "--drift-interval-s", "3600", "--input", str(req),
                       "--output", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["ok"]
    capsys.readouterr()


def test_pool_workers_get_the_tuning_and_lifecycle_flags(artifact, tmp_path,
                                                         monkeypatch):
    """`gmm serve --http --workers N` forwards --autotune, --tuning-db and
    --lifecycle to each worker's command line, as the JAX pool does."""
    from cuda_gmm_mpi_tpu_torch.serving import server as server_mod

    src, _ = artifact
    pol = tmp_path / "p.json"
    pol.write_text(json.dumps({"debounce_alarms": 1}))
    seen = {}
    monkeypatch.setattr(server_mod, "_serve_pool_main",
                        lambda args: seen.setdefault("args", args) and 0)
    assert server_mod.serve_main([
        "--registry", str(src), "--http", "0", "--workers", "2", "--device",
        "cpu", "--autotune", "db", "--tuning-db", "t.json", "--lifecycle",
        str(pol), "--drift-interval-s", "60"]) == 0
    cmd = server_mod._worker_argv(seen["args"], "w.sock")
    for flag, value in (("--autotune", "db"), ("--tuning-db", "t.json"),
                        ("--lifecycle", str(pol)),
                        ("--drift-interval-s", "60.0")):
        assert cmd[cmd.index(flag) + 1] == value
