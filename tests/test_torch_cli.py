"""Both CLIs on the same 4-blob CSV at float64 on the CPU: byte-identical
.summary and .results, the same selected K and the same merge pairs; and the
port CLI's exit codes."""

import json

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main

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


@pytest.mark.parametrize("argv,code", [
    (["8", "missing.csv", "out"], 2),
    (["0", "{csv}", "out"], 1),
    (["513", "{csv}", "out"], 1),
    (["4", "{csv}", "out", "5"], 4),
], ids=["missing-infile", "k-zero", "k-too-big", "target-gt-k"])
def test_cli_exit_codes_match_jax(blob_csv, tmp_path, capsys, argv, code):
    argv = [a.replace("{csv}", blob_csv) for a in argv]
    argv[2] = str(tmp_path / argv[2])
    assert torch_main(argv + ["--device=cpu"]) == code
    assert jax_main(argv + ["--device=cpu"]) == code


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
], ids=["spherical", "tied", "bic", "init-from", "predict-from"])
def test_cli_new_flags_byte_identical_to_jax(blob_csv, model4, tmp_path,
                                             flags):
    """The estimator surface's flags at float64: the port's .summary and
    .results byte for byte the JAX CLI's (--predict-from fits nothing: its
    .summary echoes the model it loaded)."""
    k, target, *extra = flags
    extra = [f.replace("{model}", model4) for f in extra]
    argv = lambda out: ([k, blob_csv, str(tmp_path / out)]
                        + ([target] if target else []) + ARGS[4:] + extra)
    assert jax_main(argv("j")) == 0
    assert torch_main(argv("t")) == 0
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
], ids=["init-from-k", "init-from-bad", "predict-from-bad",
        "predict-from-fit-flag", "predict-from-distributed"])
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
