"""The port's telemetry stream against the JAX package's, on the CPU at
float64: the port's schema is the JAX package's (stream rev v2.8); a
port fit's stream validates under both packages' ``validate_stream`` and
the JAX ``gmm report`` renders it with its "Health / recovery" section;
and the stream of a fit under an injected ``nan_loglik`` equals the JAX
package's event by event (names, K, iteration, loglik to 1e-12, flags,
recovery attempt and rung), clocks and platform fields left out.
"""

import numpy as np
import pytest

from cuda_gmm_mpi_tpu import telemetry as j_tel
from cuda_gmm_mpi_tpu_torch import telemetry as t_tel

from .test_torch_health import (  # noqa: F401  (fixture)
    both_fits, one_torch_thread,
)

# Left out of the event-by-event comparison: the compile watch's records
# (the two packages compile different things: XLA executables there, the
# port's kernel libraries and CUDA-graph captures here; the port's own are
# checked in test_port_compile_events_are_its_captures) and the
# rate-limited heartbeat (a clock decides how many there are).
SKIP = {"compile", "heartbeat"}
FIELDS = ("k", "k_active", "next_k", "iter", "iters", "flags", "flag_names",
          "attempt", "action", "outcome", "pair", "where", "criterion",
          "ideal_k", "winner", "dropped", "init")
CLOSE = ("loglik", "score", "final_loglik", "min_distance")


def test_schema_is_the_jax_package_s():
    assert t_tel.SCHEMA_VERSION == j_tel.SCHEMA_VERSION
    assert t_tel.EVENT_FIELDS == j_tel.EVENT_FIELDS


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    _, _, je, te = both_fits(tmp_path_factory.mktemp("streams"),
                             {"nan_loglik": {"iter": 3}})
    return je, te


def test_port_stream_validates_and_renders(streams, tmp_path):
    _, te = streams
    assert j_tel.validate_stream(te) == []
    assert t_tel.validate_stream(te) == []
    head = te[0]
    assert head["event"] == "run_start" and head["platform"] == "cpu"
    assert te[-1]["event"] == "run_summary"
    assert te[-1]["health"]["recoveries"] == 4
    report = j_tel.render_report(te)
    assert "Health / recovery" in report
    assert "action=regularize -> recovered" in report


def test_port_stream_equals_jax(streams):
    je, te = streams
    je = [e for e in je if e["event"] not in SKIP]
    te = [e for e in te if e["event"] not in SKIP]
    assert [e["event"] for e in te] == [e["event"] for e in je]
    for a, b in zip(te, je):
        for key in FIELDS:
            assert a.get(key) == b.get(key), (a["event"], key)
        for key in CLOSE:
            if key in b:
                assert a[key] == pytest.approx(b[key], rel=1e-12), key
        if "delta" in b:  # a difference of two logliks: their 1e-12
            assert a["delta"] == pytest.approx(
                b["delta"], abs=1e-12 * abs(b["loglik"]))
    kinds = {e["event"] for e in te}
    assert {"run_start", "em_iter", "em_done", "merge", "rebucket", "health",
            "recovery", "run_summary"} <= kinds


def test_port_compile_events_are_its_captures(streams):
    """The port's compile events are its own builds: one ``em_program``
    event per captured width (none on the CPU, where nothing is captured)
    and no other site a CPU fit builds; ``run_summary.profile`` counts
    them, with the XLA counters at 0."""
    _, te = streams
    compiles = [e for e in te if e["event"] == "compile"]
    assert all(e["source"] == "aot" and e["site"] in (
        "em_program", "fused_sweep", "kernel_library") for e in compiles)
    summary = te[-1]
    prof = summary["profile"]
    assert prof["compiles"] == len(compiles) == 0
    assert prof["xla_compiles"] == 0 and prof["xla_compile_seconds"] == 0.0
    assert "cost" not in prof


def test_registry_and_recorder_match_jax(tmp_path):
    for tel in (t_tel, j_tel):
        reg = tel.MetricsRegistry()
        reg.count("em_iters", 3)
        reg.gauge("active_k", 7)
        reg.observe("phase", 0.5)
        reg.series("k", 8)
        snap = reg.snapshot()
        assert snap == {"counters": {"em_iters": 3},
                        "gauges": {"active_k": 7},
                        "histograms": {"phase": {"count": 1, "sum": 0.5,
                                                 "min": 0.5, "max": 0.5}},
                        "series": {"k": [8]}}
    path = tmp_path / "s.jsonl"
    with t_tel.RunRecorder(str(path)) as rec:
        assert not t_tel.current().active
        with t_tel.use(rec):
            assert t_tel.current() is rec
            rec.emit("preempt", reason="sigterm", where="em")
            rec.emit("shutdown", reason="sigterm", checkpointed=True)
    records = t_tel.read_stream(str(path))
    assert [r["event"] for r in records] == ["preempt", "shutdown"]
    assert "clock" in records[0] and records[0]["process"] == 0
    assert j_tel.validate_stream(records) == []
    assert t_tel.memory_stats("cpu") is None
    # No CUDA initialized in this process: the default device reads None.
    assert t_tel.memory_stats() is None


@pytest.mark.parametrize("flag", ["--allow-nonfinite", "--sweep-log",
                                  "--no-output"])
def test_cli_output_flags_equal_jax(tmp_path, capsys, flag):
    """The CLI flags beside the recorder, against the JAX CLI at float64:
    --allow-nonfinite drops a NaN row (byte-identical outputs),
    --sweep-log writes the same JSON lines (seconds aside), --no-output
    an empty .summary and no .results."""
    import json

    from cuda_gmm_mpi_tpu.cli import main as jax_main
    from cuda_gmm_mpi_tpu_torch.cli import main as torch_main

    from .test_torch_cli import ARGS
    from .test_torch_health import CHUNK, blob_data

    rows = blob_data()
    if flag == "--allow-nonfinite":
        rows[17, 2] = np.nan
    csv = tmp_path / "e.csv"
    csv.write_text("a,b,c,d,e\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in rows))
    outs = {}
    for name, main in (("j", jax_main), ("t", torch_main)):
        extra = [flag] if flag != "--sweep-log" else [
            f"--sweep-log={tmp_path / (name + '.jsonl')}"]
        argv = (["8", str(csv), str(tmp_path / name), "4"] + ARGS[4:]
                + [CHUNK] + extra)
        assert main(argv) == 0, name
        outs[name] = {ext: (tmp_path / (name + ext)).read_bytes()
                      if (tmp_path / (name + ext)).exists() else None
                      for ext in (".summary", ".results")}
    capsys.readouterr()
    assert outs["t"] == outs["j"]
    if flag == "--no-output":
        assert outs["t"] == {".summary": b"", ".results": None}
    elif flag == "--allow-nonfinite":
        assert outs["t"][".results"].count(b"\n") == 1999
    else:
        logs = [[{k: v for k, v in json.loads(line).items() if k != "seconds"}
                 for line in open(tmp_path / (n + ".jsonl"))]
                for n in ("t", "j")]
        assert [r["num_clusters"] for r in logs[0]] == [8, 7, 6, 5, 4]
        for a, b in zip(*logs):
            assert a.keys() == b.keys()
            assert a["loglik"] == pytest.approx(b["loglik"], rel=1e-12)
            assert (a["num_clusters"], a["em_iters"], a["criterion"]) == (
                b["num_clusters"], b["em_iters"], b["criterion"])
