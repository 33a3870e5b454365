"""Checkpoints across the two packages, on the CPU at float64: a preempted
fit's checkpoint written by either CLI resumes in the other and ends
byte-identical to the JAX CLI's uninterrupted run; a torn newest step falls
back; unreadable checkpoints (and a torn BIN input) exit 74 in both; an
injected ``checkpoint_eio`` is absorbed by the bounded retry alike.

The preempt (``testing.faults`` ``preempt``, the deterministic stand-in for
SIGTERM) lands in the sweep's second K: a first run stops K = 8 at
iteration 4, and the resumed run, given the same plan, next polls
iteration 4 in K = 7 (its K = 8 restarts at iteration 4 and polls at 6,
8, 10).
"""

import warnings

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.cli import main as jax_main
from cuda_gmm_mpi_tpu.config import GMMConfig as JConfig
from cuda_gmm_mpi_tpu.models.order_search import fit_gmm as j_fit
from cuda_gmm_mpi_tpu.testing import faults as j_faults
from cuda_gmm_mpi_tpu.utils.checkpoint import SweepCheckpointer as JCkpt
from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.io import write_bin
from cuda_gmm_mpi_tpu_torch.testing import faults as t_faults
from cuda_gmm_mpi_tpu_torch.utils.checkpoint import SweepCheckpointer

from .test_torch_cli import ARGS, blob_csv  # noqa: F401  (fixture)
from .test_torch_health import (  # noqa: F401  (fixture)
    CHUNK, FIT, blob_data, events, one_torch_thread,
)

CLIS = {"jax": (jax_main, j_faults), "port": (torch_main, t_faults)}


def argv(csv, out, *extra):
    return ["8", csv, str(out), "4"] + ARGS[4:] + [CHUNK] + list(extra)


@pytest.fixture(scope="module")
def reference(blob_csv, tmp_path_factory):  # noqa: F811
    """The JAX CLI's uninterrupted run: {'.summary': bytes, '.results':
    bytes}."""
    out = tmp_path_factory.mktemp("ref") / "u"
    assert jax_main(argv(blob_csv, out)) == 0
    return {ext: (out.parent / ("u" + ext)).read_bytes()
            for ext in (".summary", ".results")}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_preempted_checkpoint_resumes_across_packages(
        blob_csv, reference, tmp_path, capsys, writer, reader):  # noqa: F811
    ck = ["--checkpoint-dir=" + str(tmp_path / "ck"),
          "--preempt-poll-iters=2"]
    main, faults = CLIS[writer]
    for _ in range(2):
        with faults.use({"preempt": {"iter": 4}}):
            assert main(argv(blob_csv, tmp_path / "x", *ck)) == 75
    assert "resumable from step 1 iteration 4" in capsys.readouterr().err
    sweep = sorted(p.name for p in (tmp_path / "ck" / "sweep").iterdir())
    assert "1.iter4.npz" in sweep  # K = 7 (step 1), iteration 4
    assert CLIS[reader][0](argv(blob_csv, tmp_path / "r", *ck)) == 0
    assert "1.iter4.npz" not in {
        p.name for p in (tmp_path / "ck" / "sweep").iterdir()}
    for ext, want in reference.items():
        assert (tmp_path / ("r" + ext)).read_bytes() == want, ext


def test_torn_newest_step_falls_back(tmp_path):
    fit_gmm(blob_data(), 8, 4, config=GMMConfig(
        checkpoint_dir=str(tmp_path / "ck"), **FIT))
    ck = SweepCheckpointer(str(tmp_path / "ck"))
    newest = ck.latest_step()
    assert newest is not None and newest >= 1
    good = ck.restore(newest - 1)
    path = tmp_path / "ck" / "sweep" / f"{newest}.npz"
    path.write_bytes(path.read_bytes()[: max(8, path.stat().st_size // 3)])
    with pytest.warns(RuntimeWarning, match="falling back"):
        restored = ck.restore()
    assert restored["step"] == newest - 1
    np.testing.assert_array_equal(restored["state"].means.numpy(),
                                  good["state"].means.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        theirs = JCkpt(str(tmp_path / "ck")).restore()
    assert theirs["step"] == newest - 1
    np.testing.assert_array_equal(np.asarray(theirs["state"].means),
                                  good["state"].means.numpy())


@pytest.mark.parametrize("case", ["checkpoint", "bin"])
def test_unreadable_inputs_exit_74(blob_csv, tmp_path, capsys,  # noqa: F811
                                   case):
    if case == "checkpoint":
        sweep = tmp_path / "ck" / "sweep"
        sweep.mkdir(parents=True)
        (sweep / "0.npz").write_bytes(b"torn")
        infile, extra = blob_csv, ["--checkpoint-dir=" + str(tmp_path / "ck")]
        message = "Checkpoint unreadable"
    else:
        infile = str(tmp_path / "e.bin")
        write_bin(infile, blob_data())
        with open(infile, "r+b") as f:
            f.truncate(1000)
        extra, message = [], "Error parsing input file"
    for name, (main, _) in CLIS.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert main(argv(infile, tmp_path / name, *extra)) == 74, name
        assert message in capsys.readouterr().err


def test_checkpoint_eio_absorbed_alike(tmp_path):
    spec = {"checkpoint_eio": {"step": 1, "times": 2}}
    out = {}
    for name, fit, conf, faults in (("jax", j_fit, JConfig, j_faults),
                                    ("port", fit_gmm, GMMConfig, t_faults)):
        metrics = tmp_path / f"{name}.jsonl"
        with faults.use(spec) as plan:
            res = fit(blob_data(), 8, 4, config=conf(
                checkpoint_dir=str(tmp_path / name),
                metrics_file=str(metrics), **FIT))
        assert plan.fired["checkpoint_eio"] == 2
        retries = [(e["op"], e["step"], e["attempt"], e["gave_up"])
                   for e in events(metrics) if e["event"] == "io_retry"]
        out[name] = (retries, res.health, res.final_loglik)
    assert out["port"][0] == out["jax"][0] == [("save", 1, 1, False),
                                               ("save", 1, 2, False)]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["io_retries"] == 2
    assert out["port"][2] == pytest.approx(out["jax"][2], rel=1e-12)
