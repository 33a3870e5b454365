"""Both CLIs on the same 4-blob CSV at float64 on the CPU: byte-identical
.summary and .results, the same selected K and the same merge pairs; and the
port CLI's exit codes."""

import json

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.io import native as jax_native
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.io import native as torch_native

ARGS = ["8", None, None, "4", "--device=cpu", "--dtype=float64",
        "--min-iters=10", "--max-iters=10"]


@pytest.fixture(scope="module")
def blob_csv(tmp_path_factory):
    """The 4-blob CSV of the repo's CLI verification recipe."""
    rng = np.random.default_rng(7)
    c = rng.normal(scale=10, size=(4, 5))
    x = np.concatenate([rng.normal(c[i], 1, (500, 5))
                        for i in range(4)]).astype(np.float32)
    p = tmp_path_factory.mktemp("csv") / "events.csv"
    p.write_text("a,b,c,d,e\n" + "\n".join(
        ",".join(f"{v:.6f}" for v in r) for r in x))
    return str(p)


@pytest.fixture(autouse=True)
def native_library(monkeypatch):
    """Both CLIs write .results through the native library: the port builds
    it (under its build lock) before either CLI runs, and a loader that an
    earlier test in this process latched to 'unavailable' (a build it met
    half-done) tries again. The two writers differ in the last digit of a
    tie (tests/test_native_io.py), so byte identity needs the same writer on
    both sides; the tests assert that before they compare bytes."""
    use_native_library(monkeypatch)


def use_native_library(monkeypatch):
    """``native_library``'s work, for a fixture of any scope (a module
    fixture passes a ``pytest.MonkeyPatch.context()``)."""
    assert torch_native.ensure_built()
    for mod in (jax_native, torch_native):
        if mod._lib is None:
            monkeypatch.setattr(mod, "_tried", False)


def assert_same_writer():
    assert jax_native.available() == torch_native.available()


def _args(infile, outfile, extra=()):
    a = list(ARGS)
    a[1], a[2] = infile, outfile
    return a + list(extra)


@pytest.mark.parametrize("extra", [[], ["--diag-only"]], ids=["full", "diag"])
def test_cli_outputs_byte_identical_to_jax(blob_csv, tmp_path, capsys, extra):
    metrics = tmp_path / "jax.jsonl"
    assert jax_main(_args(blob_csv, str(tmp_path / "j"), extra)
                    + [f"--metrics-file={metrics}"]) == 0
    capsys.readouterr()
    assert torch_main(_args(blob_csv, str(tmp_path / "t"), extra) + ["-v"]) == 0
    out = capsys.readouterr().out
    assert_same_writer()
    for ext in (".summary", ".results"):
        assert ((tmp_path / ("t" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes()), ext
    summary = (tmp_path / "t.summary").read_text()
    assert summary.count("Cluster #") == 4
    jax_pairs = [tuple(r["pair"]) for r in map(json.loads,
                                               metrics.read_text().splitlines())
                 if r.get("event") == "merge"]
    torch_pairs = [tuple(int(v) for v in line.rsplit(" ", 1)[1].split(","))
                   for line in out.splitlines() if "merging closest pair" in line]
    assert len(torch_pairs) == 4
    assert torch_pairs == jax_pairs


@pytest.fixture(scope="module")
def nan_csv(blob_csv, tmp_path_factory):
    """The 4-blob CSV with a NaN in its tenth event row."""
    lines = open(blob_csv).read().splitlines()
    lines[10] = "nan," + lines[10].split(",", 1)[1]
    p = tmp_path_factory.mktemp("nan") / "nan.csv"
    p.write_text("\n".join(lines))
    return str(p)


@pytest.mark.parametrize("argv,code,message", [
    (["8", "missing.csv", "out"], 2, None),
    (["0", "{csv}", "out"], 1, None),
    (["513", "{csv}", "out"], 1, None),
    (["4", "{csv}", "out", "5"], 4, None),
    (["8", "{nan_csv}", "out", "4"], 1,
     "input contains 1 non-finite event row(s) (first at global row 9); "
     "NaN/Inf events silently poison every statistic the reference "
     "computes -- clean the data or pass validate_input=False/"
     "--no-validate-input to proceed anyway\n"),
], ids=["missing-infile", "k-zero", "k-too-big", "target-gt-k", "nan-row"])
def test_cli_exit_codes_match_jax(blob_csv, nan_csv, tmp_path, capsys, argv,
                                  code, message):
    argv = [a.replace("{csv}", blob_csv).replace("{nan_csv}", nan_csv)
            for a in argv]
    argv[2] = str(tmp_path / argv[2])
    capsys.readouterr()
    assert torch_main(argv + ["--device=cpu"]) == code
    ours = capsys.readouterr().err
    assert jax_main(argv + ["--device=cpu"]) == code
    theirs = capsys.readouterr().err
    if message is not None:
        assert ours == theirs == message


@pytest.fixture(scope="module")
def model4(blob_csv, tmp_path_factory):
    """A 4-cluster .summary written by the JAX CLI's float64 fit."""
    out = tmp_path_factory.mktemp("model") / "m"
    assert jax_main(_args(blob_csv, str(out))) == 0
    return str(out) + ".summary"


@pytest.mark.parametrize("flags", [
    ["8", "4", "--covariance-type=spherical"],
    ["8", "4", "--covariance-type=tied"],
    ["8", None, "--criterion=bic"],  # the search down to 1, scored by BIC
    ["4", "4", "--init-from={model}"],
    ["1", None, "--predict-from={model}"],
    ["8", "4", "--fused-sweep"],
    ["8", "4", "--sweep-k-buckets", "off"],
    ["8", "4", "--no-validate-input"],
    ["8", "4", "--debug"],
], ids=["spherical", "tied", "bic", "init-from", "predict-from", "fused-sweep",
        "sweep-k-buckets-off", "no-validate-input", "debug"])
def test_cli_new_flags_byte_identical_to_jax(blob_csv, model4, tmp_path,
                                             flags):
    """The estimator surface's flags and the sweep's (--fused-sweep,
    --sweep-k-buckets, --no-validate-input, --debug) at float64: the port's .summary
    and .results byte for byte the JAX CLI's (--predict-from fits nothing:
    its .summary echoes the model it loaded)."""
    k, target, *extra = flags
    extra = [f.replace("{model}", model4) for f in extra]
    argv = lambda out: ([k, blob_csv, str(tmp_path / out)]
                        + ([target] if target else []) + ARGS[4:] + extra)
    assert jax_main(argv("j")) == 0
    assert torch_main(argv("t")) == 0
    assert_same_writer()
    for ext in (".summary", ".results"):
        assert ((tmp_path / ("t" + ext)).read_bytes()
                == (tmp_path / ("j" + ext)).read_bytes()), ext
    assert (tmp_path / "t.results").read_text().count("\n") == 2000


@pytest.mark.parametrize("flags,code,message", [
    (["--init-from={model}"], 1, "this fit needs"),          # K 8, model 4
    (["--init-from={csv}"], 1, "Cannot load --init-from"),
    (["--predict-from={csv}"], 1, "Cannot load model"),
    (["--predict-from={model}", "--n-init=2"], 1, "no effect"),
    (["--predict-from={model}", "--process-id=0"], 1, "single-process"),
    (["--predict-from={model}", "--fused-sweep"], 1, "no effect"),
    (["--predict-from={model}", "--sweep-k-buckets=off"], 1, "no effect"),
], ids=["init-from-k", "init-from-bad", "predict-from-bad",
        "predict-from-fit-flag", "predict-from-distributed",
        "predict-from-fused-sweep", "predict-from-sweep-k-buckets"])
def test_cli_model_file_errors_match_jax(blob_csv, model4, tmp_path, capsys,
                                         flags, code, message):
    extra = [f.replace("{model}", model4).replace("{csv}", blob_csv)
             for f in flags]
    argv = ["8", blob_csv, str(tmp_path / "o"), "--device=cpu"] + extra
    assert torch_main(argv) == code
    assert message in capsys.readouterr().err
    assert jax_main(argv) == code
    assert message in capsys.readouterr().err


def test_cli_predict_from_never_clobbers_its_model(blob_csv, model4,
                                                   tmp_path, capsys):
    model = tmp_path / "m.summary"
    model.write_bytes(open(model4, "rb").read())
    before = model.read_bytes()
    assert torch_main(["1", blob_csv, str(tmp_path / "m"), "--device=cpu",
                       "--dtype=float64", f"--predict-from={model}"]) == 0
    assert "skipping the .summary echo" in capsys.readouterr().err
    assert model.read_bytes() == before
    assert (tmp_path / "m.results").exists()


@pytest.fixture(scope="module")
def collapsed_csv(blob_csv, tmp_path_factory):
    """The 4-blob CSV cut to its first 300 rows, then each of its first 5
    rows repeated 40 times: clusters collapse onto the repeated points."""
    lines = open(blob_csv).read().splitlines()
    rows = lines[1:301]
    p = tmp_path_factory.mktemp("dup") / "dup.csv"
    p.write_text("\n".join([lines[0]] + rows
                           + [r for r in rows[:5] for _ in range(40)]))
    return str(p)


def test_cli_collapsed_clusters_match_jax(collapsed_csv, tmp_path):
    """Collapsed clusters at float64: .results byte for byte the JAX CLI's;
    .summary too, except the sign of a printed zero (a covariance entry of
    a collapsed cluster is a few ulps either side of 0), with R held
    numerically."""
    from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
    from cuda_gmm_mpi_tpu.models import fit_gmm as j_fit
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
    from cuda_gmm_mpi_tpu_torch.io import read_data

    argv = lambda out: ["12", collapsed_csv, str(tmp_path / out),
                        "--device=cpu", "--dtype=float64", "--min-iters=5",
                        "--max-iters=40"]
    assert jax_main(argv("j")) == 0
    assert torch_main(argv("t")) == 0
    assert_same_writer()
    assert ((tmp_path / "t.results").read_bytes()
            == (tmp_path / "j.results").read_bytes())
    unsigned = lambda p: p.read_text().replace("-0.000 ", "0.000 ")
    assert unsigned(tmp_path / "t.summary") == unsigned(tmp_path / "j.summary")
    # R itself, from the same fits through the libraries: entries of order
    # 1 agree to a few ulps (the zero-sign flips are ~1e-15 apart).
    data = read_data(collapsed_csv)
    kw = dict(dtype="float64", min_iters=5, max_iters=40)
    ours = fit_gmm(data, 12, config=GMMConfig(device="cpu", **kw))
    theirs = j_fit(data, 12, config=JConfig(**kw))
    assert ours.ideal_num_clusters == theirs.ideal_num_clusters
    np.testing.assert_allclose(ours.covariances, theirs.covariances,
                               rtol=1e-9, atol=1e-12)
