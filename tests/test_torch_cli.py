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
