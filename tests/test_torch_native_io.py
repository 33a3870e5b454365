"""The port's copy of the native C++ reader and writer (io/native.py) and
``use_native`` on its readers and writers, mirroring tests/test_native_io.py;
and the port CLI's new flags against the JAX CLI at float64 (byte-identical
files, the native writer on both sides)."""

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.io import native as j_native
from cuda_gmm_mpi_tpu.io.readers import data_shape as j_data_shape
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.io import (
    TruncatedInputError, data_shape, read_bin, read_csv, read_data,
    stream_results, write_bin, write_results,
)
from cuda_gmm_mpi_tpu_torch.io import native

from .test_torch_cli import (_args, blob_csv,  # noqa: F401 (fixtures)
                             native_library)


def _csv(path, data):
    path.write_text(",".join(f"h{i}" for i in range(data.shape[1])) + "\n"
                    + "\n".join(",".join(f"{v:.6f}" for v in row)
                                for row in data))
    return str(path)


def test_native_library_builds_and_loads():
    assert native.ensure_built() and native.available()
    assert native._LIB_PATH == j_native._LIB_PATH  # the repository's one


def test_native_csv_matches_python(tmp_path, rng):
    data = rng.normal(scale=100, size=(500, 7)).astype(np.float32)
    p = _csv(tmp_path / "d.csv", data)
    a = native.read_data(p)
    np.testing.assert_array_equal(a, read_csv(p))
    assert a.dtype == np.float32 and a.shape == (500, 7)
    np.testing.assert_array_equal(read_data(p, use_native="always"),
                                  read_data(p, use_native="never"))


def test_native_bin_matches_python(tmp_path, rng):
    data = rng.normal(size=(123, 4)).astype(np.float32)
    p = str(tmp_path / "d.bin")
    write_bin(p, data)
    np.testing.assert_array_equal(native.read_data(p), read_bin(p))
    np.testing.assert_array_equal(read_data(p, use_native="always"), data)


def test_native_csv_blank_lines_crlf_ragged_and_atof(tmp_path):
    p = tmp_path / "d.csv"
    p.write_bytes(b"a,b\r\n\r\n1.5,2.5\r\n\r\n3.5,4.5\r\n")
    np.testing.assert_allclose(native.read_data(str(p)),
                               [[1.5, 2.5], [3.5, 4.5]])
    p.write_text("a,b,c\n1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        native.read_data(str(p))
    p.write_text("a,b\nhello,1.25e2\n-3.5xyz,0\n")
    np.testing.assert_allclose(native.read_data(str(p)),
                               [[0.0, 125.0], [-3.5, 0.0]])
    with pytest.raises(ValueError):
        native.read_data(str(tmp_path / "missing.csv"))


def test_data_shape_all_paths(tmp_path, rng):
    data = rng.normal(size=(37, 3)).astype(np.float32)
    pc = _csv(tmp_path / "d.csv", data)
    pb = str(tmp_path / "d.bin")
    write_bin(pb, data)
    for p in (pc, pb):
        for mode in ("always", "never"):
            assert data_shape(p, use_native=mode) == (37, 3)
        assert data_shape(p) == tuple(j_data_shape(p))


def test_torn_bin_is_truncated_input_on_every_path(tmp_path, rng):
    """A BIN payload shorter than its header says: TruncatedInputError
    (the CLI's exit 74) whether the native reader ran first or not."""
    p = tmp_path / "t.bin"
    write_bin(str(p), rng.normal(size=(50, 3)).astype(np.float32))
    p.write_bytes(p.read_bytes()[:-20])
    for mode in ("auto", "always", "never"):
        with pytest.raises(TruncatedInputError):
            read_data(str(p), use_native=mode)


def _tie_rule(a_lines, b_lines):
    """tests/test_native_io.py's rule: printf %f and Python's formatter may
    differ in the last digit on ties, never structurally."""
    assert len(a_lines) == len(b_lines)
    for x, y in zip(a_lines, b_lines):
        if x == y:
            continue
        xs, ys = x.replace("\t", ",").split(","), y.replace("\t", ",").split(",")
        assert len(xs) == len(ys)
        np.testing.assert_allclose([float(v) for v in xs],
                                   [float(v) for v in ys], atol=2e-6)


def test_native_writer_matches_python(tmp_path, rng):
    data = rng.normal(scale=10, size=(200, 5)).astype(np.float32)
    memb = rng.random(size=(200, 3)).astype(np.float32)
    memb /= memb.sum(1, keepdims=True)
    pn, pp = tmp_path / "n.results", tmp_path / "p.results"
    native.write_results(str(pn), data, memb)
    write_results(str(pp), data, memb, use_native="never")
    _tie_rule(pn.read_text().splitlines(), pp.read_text().splitlines())
    assert len(pn.read_text().splitlines()) == 200


def test_streaming_results_byte_identical(tmp_path, rng):
    """stream_results == write_results, native and Python paths alike."""
    data = rng.normal(scale=10, size=(317, 4)).astype(np.float32)
    memb = rng.random(size=(317, 5)).astype(np.float32)
    memb /= memb.sum(1, keepdims=True)

    def blocks():
        for lo in range(0, 317, 64):  # an uneven tail block on purpose
            yield data[lo:lo + 64], memb[lo:lo + 64]

    for mode in ("always", "never"):
        p_mono = tmp_path / f"mono_{mode}.results"
        p_stream = tmp_path / f"stream_{mode}.results"
        write_results(str(p_mono), data, memb, use_native=mode)
        assert stream_results(str(p_stream), blocks(), use_native=mode) == 317
        assert p_stream.read_bytes() == p_mono.read_bytes()


def test_results_writer_context_manager(tmp_path, rng):
    data = rng.normal(size=(10, 2)).astype(np.float32)
    memb = rng.random(size=(10, 3)).astype(np.float32)
    p = tmp_path / "w.results"
    with native.ResultsWriter(str(p)) as w:
        w.append(data[:6], memb[:6])
        w.append(data[6:], memb[6:])
    assert len(p.read_text().splitlines()) == 10
    with pytest.raises(ValueError):
        with native.ResultsWriter(str(tmp_path / "x.results")) as w:
            w.append(data[:4], memb[:5])


def test_use_native_always_raises_without_the_library(tmp_path, monkeypatch,
                                                      rng):
    """'always' cannot fall back: with the library unavailable it raises,
    'auto' takes the Python path."""
    data = rng.normal(size=(5, 2)).astype(np.float32)
    p = str(tmp_path / "d.bin")
    write_bin(p, data)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="always"):
        read_data(p, use_native="always")
    with pytest.raises(RuntimeError, match="always"):
        data_shape(p, use_native="always")
    with pytest.raises(RuntimeError, match="always"):
        stream_results(str(tmp_path / "r.results"), [], use_native="always")
    np.testing.assert_array_equal(read_data(p), data)
    with pytest.raises(ValueError, match="use_native"):
        read_data(p, use_native="sometimes")


NEW_FLAGS = {
    "numerics": ["--precision=high", "--quad-mode=packed", "--chunk-size=512",
                 "--max-clusters=64", "--dynamic-range=500",
                 "--epsilon-scale=0.02", "--covariance-type=full"],
    "centered": ["--quad-mode=centered", "--no-center", "--precision=default"],
    "hoist": ["--precompute-features", "--chunk-size=300"],
    "diag": ["--covariance-type=diag", "--quad-mode=packed"],
}


@pytest.mark.parametrize("flags", list(NEW_FLAGS.values()),
                         ids=list(NEW_FLAGS))
def test_cli_new_flags_byte_identical_to_jax(blob_csv, tmp_path, capsys,  # noqa: F811
                                             native_library, flags):  # noqa: F811
    """The float64 CLIs with the new flags: byte-identical .summary and
    .results, both written through the native writer. The two writers
    differ in the last digit of a tie, so a JAX loader that an earlier test
    file in this worker latched to 'unavailable' (it met the library
    half-built by another process) would compare the Python writer's bytes
    with the native one's: ``native_library`` builds the library under the
    port's lock and clears such a latch, and both loaders must load it
    before any byte is compared."""
    assert j_native.available() and native.available()
    assert jax_main(_args(blob_csv, str(tmp_path / "j"), flags)) == 0
    assert torch_main(_args(blob_csv, str(tmp_path / "t"), flags)) == 0
    capsys.readouterr()
    for ext in (".summary", ".results"):
        assert ((tmp_path / ("t" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes()), ext


def test_cli_new_flags_errors(blob_csv, tmp_path, capsys):  # noqa: F811
    """--max-clusters bounds num_clusters (exit 1); a config guard (exit 1)."""
    out = str(tmp_path / "o")
    assert torch_main(_args(blob_csv, out, ["--max-clusters=4"])) == 1
    assert torch_main(_args(blob_csv, out, ["--precompute-features",
                                            "--covariance-type=diag"])) == 1
    capsys.readouterr()


_RACE_SCRIPT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("gmm_native", sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native._NATIVE_DIR = sys.argv[2]
native._LIB_PATH = sys.argv[2] + "/libgmm_io.so"
print(native.available())
"""


@pytest.mark.parametrize("rep", range(5))
def test_concurrent_first_builds_all_load(tmp_path, rep):
    """Six processes start together on a copy of native/ without the
    library: each builds under the lock or waits for the one that does, and
    every one of them loads it (a loader that met a half-written library, or
    latched a failed build, would report False)."""
    import shutil
    import subprocess
    import sys

    nat = tmp_path / "native"
    nat.mkdir()
    for name in ("Makefile", "gmm_io.cpp"):
        shutil.copy(str(native._NATIVE_DIR) + "/" + name, nat)
    script = tmp_path / "race.py"
    script.write_text(_RACE_SCRIPT)
    procs = [subprocess.Popen([sys.executable, str(script), native.__file__,
                               str(nat)], stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert outs == ["True"] * 6
    assert sorted(p.name for p in nat.iterdir()) == [
        ".libgmm_io.lock", "Makefile", "gmm_io.cpp", "libgmm_io.so"]
