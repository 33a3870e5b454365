"""The port's pipelined ingestion (io/pipeline.py), the readers' metadata
cache and the out-of-core CLI, on the CPU.

Pipelined ingestion changes where the blocks come from, not a bit of the
fit: 'pipelined' == 'resident' exactly (torch.equal on the means, ==
on the loglik), on BIN and CSV, full and diag. The bounded queue bounds
residency, ``read_slow`` moves only the consumer's wait, delivery order is
the block order and a seek restarts the worker there. The CLI's
``--stream-events`` files (resident, pipelined, stepwise) are
byte-identical to the JAX CLI's at float64. Ported from
tests/test_ingest.py.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.io import native as jax_native
from cuda_gmm_mpi_tpu.telemetry import validate_stream as j_validate_stream
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.io import (
    FileSource, PipelinedBlockSource, read_csv, read_data, write_bin,
)
from cuda_gmm_mpi_tpu_torch.io import native as torch_native
from cuda_gmm_mpi_tpu_torch.io import readers
from cuda_gmm_mpi_tpu_torch.telemetry import read_stream, validate_stream
from cuda_gmm_mpi_tpu_torch.telemetry.report import render_report
from cuda_gmm_mpi_tpu_torch.testing import faults

from .conftest import worker_env


def _blobs(seed, n, d=3, k=3):
    rng = np.random.default_rng(seed)
    c = rng.normal(scale=9.0, size=(k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(
        np.float32)


def _bin(tmp_path, n=2048, d=3, k=3, seed=0, name="ev.bin"):
    path = str(tmp_path / name)
    write_bin(path, _blobs(seed, n, d, k))
    return path


def _csv(tmp_path, x, name="ev.csv"):
    p = tmp_path / name
    p.write_text(",".join("abcdefgh"[:x.shape[1]]) + "\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in x) + "\n")
    return str(p)


def _cfg(**kw):
    return GMMConfig(device="cpu", **kw)


@pytest.mark.parametrize("fmt,diag", [("bin", False), ("bin", True),
                                      ("csv", False)])
def test_pipelined_equals_resident(tmp_path, fmt, diag):
    """Across the K sweep, exactly."""
    path = (_bin(tmp_path) if fmt == "bin"
            else _csv(tmp_path, _blobs(1, 1500, d=4)))
    kw = dict(min_iters=4, max_iters=4, chunk_size=256, dtype="float64",
              stream_events=True, diag_only=diag, seed=7)
    r_res = fit_gmm(FileSource(path), 4, 2, _cfg(**kw))
    r_pipe = fit_gmm(FileSource(path), 4, 2, _cfg(ingest="pipelined", **kw))
    assert r_pipe.ideal_num_clusters == r_res.ideal_num_clusters
    assert r_pipe.final_loglik == r_res.final_loglik
    assert r_pipe.min_rissanen == r_res.min_rissanen
    assert torch.equal(r_pipe.state.means, r_res.state.means)
    assert torch.equal(r_pipe.state.R, r_res.state.R)
    assert torch.equal(r_pipe.state.pi, r_res.state.pi)
    assert [r[:2] for r in r_pipe.sweep_log] == [r[:2] for r in
                                                 r_res.sweep_log]


def test_read_slow_moves_only_the_wait(tmp_path):
    n, chunk = 2048, 256
    src = FileSource(_bin(tmp_path, n=n))
    expect = [src.read_range(j * chunk, (j + 1) * chunk).astype(np.float64)
              for j in range(n // chunk)]
    with faults.use({"read_slow": {"ms": 40, "block": 1, "times": 2}}) \
            as plan:
        pbs = PipelinedBlockSource(src, start=0, stop=n, chunk_size=chunk,
                                   num_chunks=n // chunk, queue_depth=2)
        try:
            for _ in range(2):
                for j in range(pbs.num_blocks):
                    x, w = pbs.get_block(j)
                    np.testing.assert_array_equal(x, expect[j])
                    np.testing.assert_array_equal(w, np.ones(chunk))
        finally:
            pbs.close()
    assert plan.fired["read_slow"] == 2
    assert pbs.prefetch_wait_s > 0.0
    assert 1 <= pbs.peak_resident <= 2
    assert pbs.delivered_order == list(range(pbs.num_blocks)) * 2
    assert pbs.blocks_read == 2 * pbs.num_blocks
    assert not pbs._thread.is_alive()


def test_prefetch_order_and_reseek(tmp_path):
    n, chunk = 1024, 128
    src = FileSource(_bin(tmp_path, n=n))
    pbs = PipelinedBlockSource(src, start=0, stop=n, chunk_size=chunk,
                               num_chunks=n // chunk, queue_depth=3)
    try:
        for j in range(pbs.num_blocks):
            pbs.get_block(j)
        x, _ = pbs.get_block(5)  # a resumed pass seeks
        np.testing.assert_array_equal(
            x, src.read_range(5 * chunk, 6 * chunk).astype(np.float64))
        for j in range(6, pbs.num_blocks):
            pbs.get_block(j)
        with pytest.raises(IndexError):
            pbs.get_block(pbs.num_blocks)
        assert pbs.delivered_order == (list(range(pbs.num_blocks))
                                       + list(range(5, pbs.num_blocks)))
        # An elastic refit's new rows: the second half, 4 chunks.
        pbs.reseek(start=512, stop=n, num_chunks=4)
        x, w = pbs.get_block(3)
        np.testing.assert_array_equal(
            x, src.read_range(896, 1024).astype(np.float64))
        assert pbs.total_weight == 512.0
    finally:
        pbs.close()
    assert not pbs._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pbs.get_block(0)


def test_worker_joined_when_a_fit_stops(tmp_path):
    """Exit 75 leaves no ingestion thread behind."""
    from cuda_gmm_mpi_tpu_torch import supervisor

    path = _bin(tmp_path, n=3072)
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(supervisor.PreemptedError):
        with faults.use({"preempt": {"iter": 1, "block": 2}}), \
                supervisor.use(supervisor.RunSupervisor(
                    install_signals=False)):
            fit_gmm(FileSource(path), 3, 3, _cfg(
                min_iters=3, max_iters=3, chunk_size=256, dtype="float64",
                stream_events=True, ingest="pipelined",
                checkpoint_dir=str(tmp_path / "ck")))
    left = {t.name for t in threading.enumerate()
            if t.name.startswith("gmm-ingest")} - before
    assert not left


def test_elastic_refit_reseeks_the_live_source(tmp_path, monkeypatch):
    """``rank_lost`` inside a pipelined pass with ``elastic``: the refit over
    the survivor re-seeks the fit's live block source (one source made, one
    seek) and resumes inside the pass to the uninterrupted fit, bit for
    bit (the single-process harness of tests/test_torch_elastic.py)."""
    from cuda_gmm_mpi_tpu_torch import supervisor
    from cuda_gmm_mpi_tpu_torch.io import pipeline
    from cuda_gmm_mpi_tpu_torch.parallel import elastic

    path = _bin(tmp_path, n=3072)
    kw = dict(min_iters=5, max_iters=5, chunk_size=256, dtype="float64",
              stream_events=True, ingest="pipelined", preempt_poll_iters=1,
              seed=3, elastic_backoff_s=0.0)

    def sup():
        return supervisor.use(supervisor.RunSupervisor(install_signals=False))

    elastic.reset()
    try:
        with sup():
            ref = fit_gmm(FileSource(path), 4, 2,
                          _cfg(checkpoint_dir=str(tmp_path / "ref"), **kw))
        ck = str(tmp_path / "ck")
        elastic.write_membership(elastic.membership_dir(ck), elastic.Membership(
            generation=0, ranks=(0, 1), world_size0=2))
        made, seeks = [], []
        init, reseek = (pipeline.PipelinedBlockSource.__init__,
                        pipeline.PipelinedBlockSource.reseek)

        def counted_init(self, *a, **k):
            made.append(1)
            init(self, *a, **k)

        def counted_reseek(self, **k):
            seeks.append(k)
            reseek(self, **k)

        monkeypatch.setattr(pipeline.PipelinedBlockSource, "__init__",
                            counted_init)
        monkeypatch.setattr(pipeline.PipelinedBlockSource, "reseek",
                            counted_reseek)
        with faults.use({"rank_lost": {"iter": 3, "rank": 1}}) as plan, sup():
            res = fit_gmm(FileSource(path), 4, 2,
                          _cfg(checkpoint_dir=ck, elastic=True, **kw))
        assert plan.fired["rank_lost"] == 1 and elastic.generation() == 1
        assert len(made) == 1 and len(seeks) == 1
        assert seeks[0]["start"] == 0 and seeks[0]["stop"] == 3072
        assert res.final_loglik == ref.final_loglik
        np.testing.assert_array_equal(res.means, ref.means)
    finally:
        elastic.reset()


def test_ingest_records_validate_and_render(tmp_path):
    """One ingest_start, one ingest_summary within the queue bound, the
    chunk_flush records' wait/compute split: valid under both packages'
    schemas, rendered by ``gmm report``."""
    mf = tmp_path / "m.jsonl"
    fit_gmm(FileSource(_bin(tmp_path)), 3, 3, _cfg(
        min_iters=3, max_iters=3, chunk_size=256, dtype="float64",
        stream_events=True, ingest="pipelined", ingest_queue_depth=2,
        metrics_file=str(mf), seed=7))
    records = read_stream(str(mf))
    assert validate_stream(records) == []
    assert j_validate_stream(records) == []
    start = [r for r in records if r["event"] == "ingest_start"]
    summ = [r for r in records if r["event"] == "ingest_summary"]
    assert len(start) == 1 and len(summ) == 1
    assert start[0]["mode"] == "full" and start[0]["rows"] == 2048
    assert start[0]["queue_depth"] == 2 and start[0]["blocks"] == 8
    assert 1 <= summ[0]["peak_resident_blocks"] <= 2
    assert summ[0]["blocks_read"] >= 8 and summ[0]["bytes"] > 0
    flushes = [r for r in records if r["event"] == "chunk_flush"]
    assert len(flushes) == summ[0]["blocks_read"]
    assert all(r["prefetch_wait_s"] >= 0 and r["compute_s"] >= 0
               for r in flushes)
    run_start = next(r for r in records if r["event"] == "run_start")
    assert run_start["stream_events"] is True
    assert run_start["path"] == "streaming"
    text = render_report(records)
    assert "ingest:" in text and "ingest summary:" in text
    assert "prefetch wait" in text


def test_metadata_cache_invalidation_and_csv_seek(tmp_path):
    """A second pass's CSV range read seeks to its mark: the rows before it
    are not scanned again (overwriting their line breaks in place, with
    the mtime kept, does not move the rows read), while a rewritten file
    (new size or mtime) drops the cached shape and marks."""
    x = _blobs(2, 600, d=2)
    path = _csv(tmp_path, x)
    assert readers.data_shape(path, use_native="never") == (600, 2)
    for a in range(0, 600, 100):  # the first pass leaves the marks
        np.testing.assert_array_equal(read_csv(path, a, a + 100),
                                      read_data(path, a, a + 100,
                                                use_native="never"))
    marks = readers._file_meta(path)["csv_marks"]
    assert set(range(0, 600, 100)) <= set(marks)
    want = read_csv(path, 400, 500)
    st = os.stat(path)
    raw = bytearray(open(path, "rb").read())
    head = raw.index(b"\n") + 1
    cut = marks[300]
    raw[head:cut] = raw[head:cut].replace(b"\n", b" ")
    open(path, "wb").write(bytes(raw))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    np.testing.assert_array_equal(read_csv(path, 400, 500), want)
    # Rewritten: a different file at the same path.
    y = _blobs(3, 300, d=2)
    _csv(tmp_path, y)
    assert readers.data_shape(path, use_native="never") == (300, 2)
    np.testing.assert_array_equal(
        read_csv(path, 200, 300),
        np.loadtxt(path, delimiter=",", skiprows=1)[200:300].astype(
            np.float32))
    bpath = _bin(tmp_path, n=100, name="b.bin")
    assert readers.read_bin(bpath).shape == (100, 3)
    write_bin(bpath, _blobs(4, 50))
    assert readers.read_bin(bpath).shape == (50, 3)
    assert readers.data_shape(bpath, use_native="never") == (50, 3)


@pytest.fixture
def same_writer(monkeypatch):
    """Both CLIs write .results through the native library (the test of
    tests/test_torch_cli.py)."""
    assert torch_native.ensure_built()
    for mod in (jax_native, torch_native):
        if mod._lib is None:
            monkeypatch.setattr(mod, "_tried", False)


@pytest.mark.parametrize("extra", [
    ["--stream-events"],
    ["--stream-events", "--ingest=pipelined"],
    ["--stream-events", "--ingest=pipelined", "--em-mode=minibatch",
     "--minibatch-size=512", "--min-iters=12", "--max-iters=12"],
], ids=["resident", "pipelined", "minibatch"])
def test_cli_stream_events_byte_identical_to_jax(tmp_path, capsys,
                                                 same_writer, extra):
    infile = _csv(tmp_path, _blobs(7, 2000, d=4, k=4))
    args = ["6", infile, None, "4", "--device=cpu", "--dtype=float64",
            "--min-iters=6", "--max-iters=6", "--chunk-size=256"]

    def run(main, out):
        a = list(args)
        a[2] = str(tmp_path / out)
        return main(a + extra)

    assert run(jax_main, "j") == 0
    assert run(torch_main, "t") == 0
    capsys.readouterr()
    assert jax_native.available() == torch_native.available()
    for ext in (".summary", ".results"):
        assert ((tmp_path / ("t" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes()), ext


def test_cli_refusals(tmp_path, capsys):
    infile = _bin(tmp_path, n=500)
    base = ["3", infile, str(tmp_path / "o"), "--device=cpu"]
    assert torch_main(base + ["--stream-events", "--ingest=pipelined",
                              "--allow-nonfinite"]) == 1
    assert "--allow-nonfinite requires --ingest=resident" in \
        capsys.readouterr().err
    assert torch_main(base + ["--ingest=pipelined"]) == 1  # no streaming
    assert "requires stream_events" in capsys.readouterr().err
    model = tmp_path / "m.summary"  # refused before it is read
    model.write_text("")
    for flag in ("--stream-events", "--em-mode=minibatch"):
        extra = [flag] if flag == "--stream-events" else [
            "--stream-events", flag]
        assert torch_main(base + [f"--predict-from={model}"] + extra) == 1
        assert "has no effect with --predict-from" in capsys.readouterr().err


@pytest.mark.slow
def test_pipelined_rss_bounded_by_queue(tmp_path):
    """A 128 MB file fitted both ways, each in its own process: the
    resident fit's host memory grows by at least the data, the pipelined
    fit's by at most 0.6 of the resident growth and by 0.7 x the data less
    (tests/test_ingest.py's A/B bar)."""
    code = r"""
import sys, threading
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.io import FileSource

def rss_kb():
    for line in open("/proc/self/status"):
        if line.startswith("VmRSS:"):
            return int(line.split()[1])
path, mode = sys.argv[1], sys.argv[2]
# The peak of VmRSS sampled every 10 ms above the post-import baseline
# (ru_maxrss keeps the start-up high-water mark, which can exceed a fit's).
base, peak, done = rss_kb(), [0], threading.Event()
def sample():
    while not done.wait(0.01):
        peak[0] = max(peak[0], rss_kb())
threading.Thread(target=sample, daemon=True).start()
r = fit_gmm(FileSource(path), 2, 2, config=GMMConfig(
    device="cpu", min_iters=2, max_iters=2, chunk_size=4096,
    stream_events=True, ingest=mode))
done.set()
print("GROWTH_KB", max(peak[0], rss_kb()) - base, "LL", float(r.final_loglik))
"""
    path = str(tmp_path / "big.bin")
    n, d, step = 4_000_000, 8, 1 << 16
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        np.asarray([n, d], np.int32).tofile(f)
        for lo in range(0, n, step):
            m = min(step, n - lo)
            f.write(rng.normal(size=(m, d)).astype(np.float32).tobytes())
    data_mb = n * d * 4 / 1024 / 1024
    growth, ll = {}, {}
    for mode in ("resident", "pipelined"):
        r = subprocess.run([sys.executable, "-c", code, path, mode],
                           capture_output=True, text=True, env=worker_env(),
                           timeout=600)
        assert r.returncode == 0, f"{mode}:\n{r.stdout}\n{r.stderr[-3000:]}"
        parts = r.stdout.split()
        growth[mode] = int(parts[parts.index("GROWTH_KB") + 1]) / 1024.0
        ll[mode] = float(parts[parts.index("LL") + 1])
    assert ll["pipelined"] == ll["resident"]
    assert growth["resident"] >= data_mb, growth
    assert growth["pipelined"] <= 0.6 * growth["resident"], growth
    assert growth["pipelined"] <= growth["resident"] - 0.7 * data_mb, growth
