"""The port's stream tools against the JAX package's, on the CPU: ``gmm
report`` (plain, ``--json``, ``--validate``), ``render_follow`` (``gmm
top``'s screen), ``gmm diff``, ``gmm runs`` and ``gmm timeline`` give the
same stdout, JSON and exit codes under both packages on the same streams:
the JAX package's and the port's streams of a float64 fit with a
``nan_loglik`` fault at iteration 3 (recovery and fit spans, the compile
watch, the envelope), and a clean port fit's. The port CLI dispatches the
subcommands as the JAX CLI does.

Shapes are those of tests/test_torch_health.py: 2000 x 5 events, K 8 -> 4,
10 iterations, one torch thread.
"""

import json
import shutil
import time

import pytest

from cuda_gmm_mpi_tpu import telemetry as j_tel
from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.telemetry import diff as j_diff
from cuda_gmm_mpi_tpu.telemetry import timeline as j_timeline
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch import telemetry as t_tel
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.telemetry import diff as t_diff
from cuda_gmm_mpi_tpu_torch.telemetry import timeline as t_timeline

from .test_torch_health import (  # noqa: F401  (fixture)
    FIT, blob_data, both_fits, one_torch_thread,
)

NAMES = ("jax_nan", "port_nan", "port")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: path} of the three streams, each in its own directory, and
    under "dir" a directory holding all three."""
    tmp = tmp_path_factory.mktemp("streams")
    both_fits(tmp, {"nan_loglik": {"iter": 3}}, metrics_port=0,
              profile=True)
    fit_gmm(blob_data(), 8, 4, config=GMMConfig(
        metrics_file=str(tmp / "p.jsonl"), metrics_port=0, **FIT))
    paths = {"dir": tmp / "all"}
    paths["dir"].mkdir()
    for name, src in zip(NAMES, ("j.jsonl", "t.jsonl", "p.jsonl")):
        (tmp / name).mkdir()
        paths[name] = tmp / name / f"{name}.jsonl"
        shutil.copy(tmp / src, paths[name])
        shutil.copy(tmp / src, paths["dir"] / f"{name}.jsonl")
    return {k: str(v) for k, v in paths.items()}


def _both(capsys, j_fn, t_fn, argv):
    """(exit code, stdout, stderr) of each package's entry point."""
    out = []
    for fn in (j_fn, t_fn):
        capsys.readouterr()
        rc = fn(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_streams_are_what_the_tools_read(streams):
    te = t_tel.read_stream(streams["port_nan"])
    kinds = {r["event"] for r in te}
    assert {"span", "recovery", "health", "run_summary"} <= kinds
    names = {r["name"] for r in te if r["event"] == "span"}
    assert {"fit", "sweep", "em_k", "recovery"} <= names
    summary = [r for r in te if r["event"] == "run_summary"][-1]
    assert {"profile", "envelope"} <= set(summary)
    for name in NAMES:
        records = t_tel.read_stream(streams[name])
        assert t_tel.validate_stream(records) == []
        assert j_tel.validate_stream(records) == []


@pytest.mark.parametrize("flags", [[], ["--json"], ["--validate"]])
@pytest.mark.parametrize("name", NAMES)
def test_report_main_equals_jax(streams, capsys, name, flags):
    (jrc, jout, jerr), t = _both(capsys, j_tel.report_main,
                                 t_tel.report_main, [streams[name]] + flags)
    assert t == (jrc, jout, jerr)
    assert jrc == 0 and jout
    if flags == ["--json"]:
        assert json.loads(jout)["kind"] == "stream"


@pytest.mark.parametrize("name", NAMES)
def test_render_follow_equals_jax(streams, monkeypatch, name):
    """``gmm top``'s screen, on the whole stream and on its first half (a
    run still going); the wall clock pinned (the screen shows an age)."""
    monkeypatch.setattr(time, "time", lambda: 1.9e9)
    records = t_tel.read_stream(streams[name])
    for part in (records, records[:len(records) // 2]):
        assert t_tel.render_follow(part) == j_tel.render_follow(part)
    assert "stream ended" in t_tel.render_follow(records)


@pytest.mark.parametrize("a,b,flags", [
    ("jax_nan", "port_nan", []),
    ("port", "port_nan", []),
    ("port", "port", ["--json"]),
    ("port_nan", "jax_nan", ["--all"]),
    ("port", "jax_nan", ["--fail-on", "wall_s>0.0001",
                         "--no-default-gates"]),
    ("port", "missing", []),
])
def test_diff_main_equals_jax(streams, capsys, a, b, flags):
    argv = [streams[a], streams.get(b, "/nonexistent/run.jsonl")] + flags
    j, t = _both(capsys, j_diff.diff_main, t_diff.diff_main, argv)
    assert t == j
    assert j[0] == 2 if b == "missing" else j[0] in (0, 1)


@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_runs_main_equals_jax(streams, capsys, flags):
    j, t = _both(capsys, j_diff.runs_main, t_diff.runs_main,
                 [streams["dir"]] + flags)
    assert t == j and j[0] == 0
    if flags:
        assert len(json.loads(j[1])["runs"]) == 3
    else:
        assert j[1].count("\n") >= 4  # a header and three rows


@pytest.mark.parametrize("targets", [["port_nan"], ["jax_nan", "port"],
                                     ["dir"]])
def test_timeline_main_equals_jax(streams, capsys, tmp_path, targets):
    out = tmp_path / "trace.json"
    argv = [streams[t] for t in targets] + ["-o", str(out), "--validate"]
    docs = []
    for fn in (j_timeline.timeline_main, t_timeline.timeline_main):
        capsys.readouterr()
        rc = fn(list(argv))
        docs.append((rc, capsys.readouterr(), out.read_bytes()))
        out.unlink()
    assert docs[1] == docs[0]
    assert docs[0][0] == 0
    assert json.loads(docs[0][2])["traceEvents"]


@pytest.mark.parametrize("sub", [
    ["report", "port_nan", "--validate"],
    ["top", "port", "--interval", "0.01"],
    ["diff", "jax_nan", "port_nan"],
    ["runs", "dir"],
    ["timeline", "port", "--json", "-o", "OUT"],
])
def test_cli_dispatches_as_jax(streams, capsys, tmp_path, monkeypatch, sub):
    monkeypatch.setattr(time, "time", lambda: 1.9e9)
    argv = [streams.get(a, str(tmp_path / "t.json") if a == "OUT" else a)
            for a in sub]
    j, t = _both(capsys, jax_main, torch_main, argv)
    assert t == j and j[0] == 0
