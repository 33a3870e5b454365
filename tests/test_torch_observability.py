"""The port's observability against the JAX package's, on the CPU at
float64: the span tree of a fit under the live plane (names, nesting and
fields; ids and clocks left out), a stream carrying ``profile``,
``envelope`` and spans that validates under both packages'
``validate_stream``, the host sweep's envelope, the phase table of
``--profile`` (the JAX package's lines and categories), the OpenMetrics
rendering of one snapshot, a live scrape during a port fit, the compile
watch's snapshot and ``--trace-dir``.

Shapes are those of tests/test_torch_health.py: 2000 x 5 events, K 8 -> 4,
10 iterations, one torch thread.
"""

import io
import json
import re
import urllib.request

import pytest

from cuda_gmm_mpi_tpu import telemetry as j_tel
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.telemetry import exporter as j_exp
from cuda_gmm_mpi_tpu.telemetry import profiling as j_prof
from cuda_gmm_mpi_tpu.telemetry import recorder as j_rec
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch import telemetry as t_tel
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.telemetry import exporter as t_exp
from cuda_gmm_mpi_tpu_torch.telemetry import profiling as t_prof
from cuda_gmm_mpi_tpu_torch.telemetry import recorder as t_rec

from .test_torch_envelope import hold_envelope
from .test_torch_health import (  # noqa: F401  (fixture)
    CHUNK, FIT, blob_data, both_fits, one_torch_thread,
)

# A span's identity and clocks (and the record's envelope stamps): left
# out of the comparison.
CLOCKS = {"span_id", "parent_id", "trace_id", "t0_mono_s", "duration_s",
          "thread", "ts", "mono_s", "run_id"}


@pytest.fixture(scope="module")
def observed(tmp_path_factory):
    """One fit in each package under the live plane (port 0) and
    ``profile``, with the recorder on."""
    return both_fits(tmp_path_factory.mktemp("observed"), {},
                     metrics_port=0, profile=True)


def _tree(node):
    s = node["span"]
    return ({k: v for k, v in s.items() if k not in CLOCKS},
            sorted(CLOCKS & set(s)), [_tree(c) for c in node["children"]])


def test_span_tree_equals_jax(observed):
    _, _, je, te = observed
    jt, tt = j_tel.build_span_tree(je), t_tel.build_span_tree(te)
    assert [_tree(n) for n in tt] == [_tree(n) for n in jt]
    (root,) = tt
    assert root["span"]["name"] == "fit"
    (sweep,) = root["children"]
    assert sweep["span"]["name"] == "sweep"
    assert sweep["span"]["start_k"] == 8
    assert [(c["span"]["name"], c["span"]["k"]) for c in sweep["children"]] \
        == [("em_k", k) for k in (8, 7, 6, 5, 4)]
    # The fit-scoped trace id rides every record of the port's stream.
    ids = {r.get("trace_id") for r in te if r["event"] != "heartbeat"}
    assert len(ids) == 1 and None not in ids


def test_stream_validates_under_both(observed):
    jr, tr, je, te = observed
    for stream in (te, je):
        assert t_tel.validate_stream(stream) == []
        assert j_tel.validate_stream(stream) == []
    (summary,) = [r for r in te if r["event"] == "run_summary"]
    assert summary["envelope"] == tr.envelope
    prof = summary["profile"]
    (j_summary,) = [r for r in je if r["event"] == "run_summary"]
    # The JAX package's keys; no compiler runs on the CPU port (no EM
    # capture, no kernel library), and no cost model is invented.
    assert set(prof) <= set(j_summary["profile"]) - {"cost"}
    assert prof["compiles"] == prof["xla_compiles"] == 0
    assert summary["phase_profile"]["counts"] == \
        j_summary["phase_profile"]["counts"]
    assert {r["event"] for r in te} >= {"span", "heartbeat", "run_summary"}


def test_host_sweep_envelope_equals_jax(observed):
    jr, tr, _, _ = observed
    hold_envelope(tr.envelope, jr.envelope)


def _masked(text):
    return re.sub(r"-?\d+\.\d+", "#", text)


def test_profile_prints_jax_lines_and_categories(observed, tmp_path, capsys):
    """The port CLI's --profile prints the JAX package's phase table (the
    same lines and categories, the same call counts) and its I/O and EM
    lines."""
    jr, _, _, _ = observed
    csv = tmp_path / "e.csv"
    csv.write_text("a,b,c,d,e\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in blob_data()))
    capsys.readouterr()
    assert torch_main(["8", str(csv), str(tmp_path / "o"), "4",
                       "--device=cpu", "--dtype=float64", "--min-iters=10",
                       "--max-iters=10", CHUNK, "--profile"]) == 0
    out = capsys.readouterr().out.splitlines()
    table = jr.profile_report.splitlines()
    i = out.index(table[0])
    assert [_masked(line) for line in out[i:i + len(table)]] == \
        [_masked(line) for line in table]
    assert [line.split("\t")[2] for line in out[i + 1:i + len(table)]] == \
        [line.split("\t")[2] for line in table[1:]]  # the call counts
    assert re.fullmatch(r"I/O time: \d+\.\d{3} \(ms\)", out[i + len(table)])
    iters = sum(r[3] for r in jr.sweep_log)
    assert re.fullmatch(rf"EM time: \d+\.\d{{3}} \(ms\) over {iters} "
                        r"iterations", out[i + len(table) + 1])


def test_render_openmetrics_is_identical():
    snaps = []
    for tel in (j_tel, t_tel):
        reg = tel.MetricsRegistry()
        reg.count("em_iters", 30)
        reg.count("compile_seconds", 0.25)
        reg.gauge("active_k", 6)
        reg.gauge("hbm_peak_bytes", 123456789)
        for v in (0.004, 0.02, 0.3, 7.0):
            reg.observe("phase.e_step", v)
        reg.observe("serve.latency_ms", 1.5)
        snaps.append(reg.snapshot_with_buckets())
    assert snaps[0] == snaps[1]
    snap, buckets = snaps[1]
    extra = {"gmm_active_k_now": 5}
    text = t_exp.render_openmetrics(snap, extra, buckets)
    assert text == j_exp.render_openmetrics(snap, extra, buckets)
    assert t_exp.render_openmetrics(snap) == j_exp.render_openmetrics(snap)
    assert text.endswith("# EOF\n") and "gmm_em_iters_total 30" in text


class _ScrapingSink(io.StringIO):
    """A recorder sink that scrapes the live endpoint at every em_done (the
    fit's thread waits while the exporter's thread answers)."""

    def __init__(self):
        super().__init__()
        self.scrapes = []

    def write(self, line):
        if line.startswith('{"event": "em_done"'):
            port = t_exp.current_exporter().port
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
                self.scrapes.append((r.status, r.headers["Content-Type"],
                                     r.read().decode()))
        return super().write(line)


def test_live_scrape_during_a_port_fit():
    sink = _ScrapingSink()
    rec = t_tel.RunRecorder(stream=sink)
    with t_tel.use(rec):
        res = fit_gmm(blob_data(), 8, 4, config=GMMConfig(
            metrics_port=0, **FIT))
    assert t_exp.current_exporter() is None  # stopped with the fit
    assert len(sink.scrapes) == len(res.sweep_log) == 5
    iters = []
    for status, ctype, body in sink.scrapes:
        assert status == 200 and ctype == t_exp.CONTENT_TYPE
        assert body.endswith("# EOF\n")
        iters.append(int(re.search(r"^gmm_em_iters_total (\d+)$", body,
                                   re.M).group(1)))
    assert iters == [10, 20, 30, 40, 50]
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert any(r["event"] == "heartbeat" and r.get("sampler")
               for r in records)
    assert t_tel.validate_stream(records) == []


def _fake_memory(seq):
    it = iter(seq)
    return lambda device=None: next(it)


def test_compile_watch_snapshot_matches_jax(monkeypatch):
    """One site build and one watermark section through each package's
    watch: the same snapshot keys and watermark numbers, the compile event
    held until the stream head, and the JAX ``gmm report`` renders the
    port's Compile section."""
    mem = [{"bytes_in_use": 100, "peak_bytes_in_use": 500},
           {"bytes_in_use": 300, "peak_bytes_in_use": 900}]
    out = {}
    for name, tel, prof, rec_mod in (("j", j_tel, j_prof, j_rec),
                                     ("t", t_tel, t_prof, t_rec)):
        monkeypatch.setattr(rec_mod, "memory_stats", _fake_memory(mem))
        sink = io.StringIO()
        rec = tel.RunRecorder(stream=sink)
        with tel.use(rec), prof.watch() as w:
            if name == "t":
                assert prof.site_compile(
                    "em_program", lambda: 7,
                    memory=lambda _: {"graph_pool_bytes": 4096},
                    width=8) == 7
            else:
                w.observe_site("em_program", 0.5,
                               memory={"graph_pool_bytes": 4096}, width=8)
            assert sink.getvalue() == ""  # held until the stream head
            rec.emit("run_start", platform="cpu", num_events=1,
                     num_dimensions=1, start_k=1, epsilon=1.0)
            with prof.watermark("sweep"):
                pass
            snap = w.snapshot()
        records = [json.loads(line) for line in sink.getvalue().splitlines()]
        out[name] = (snap, records, rec.metrics.snapshot())
    (jsnap, jrec, jmet), (tsnap, trec, tmet) = out["j"], out["t"]
    assert set(tsnap) == set(jsnap)
    for key in ("compiles", "xla_compiles", "memory", "watermarks",
                "hbm_peak_bytes"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["watermarks"] == {"sweep": {
        "sections": 1, "peak_bytes": 900, "delta_bytes": 200}}
    assert [r["event"] for r in trec] == ["run_start", "compile"]
    assert trec[1]["site"] == "em_program" and trec[1]["width"] == 8
    assert tmet["gauges"]["hbm_peak_bytes"] == 900
    assert j_tel.validate_stream(trec) == []
    report = j_tel.render_report(trec)
    assert "Compile activity (rev v2.2): 1 instrumented cache build(s)" in \
        report
    assert "em_program: 1 compile(s)" in report


def test_trace_dir_writes_a_chrome_trace(tmp_path, capsys):
    csv = tmp_path / "e.csv"
    csv.write_text("a,b,c,d,e\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in blob_data()[:400]))
    assert torch_main(["4", str(csv), str(tmp_path / "o"), "--device=cpu",
                       "--min-iters=2", "--max-iters=2",
                       f"--trace-dir={tmp_path / 'tr'}"]) == 0
    capsys.readouterr()
    (trace,) = (tmp_path / "tr").glob("gmm_trace.*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_metrics_port_range_is_checked():
    for cfg in (GMMConfig, JConfig):
        with pytest.raises(ValueError, match="metrics_port"):
            cfg(metrics_port=70000)
    assert GMMConfig().envelope is True and GMMConfig().profile is False
