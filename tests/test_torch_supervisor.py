"""The port's run supervisor on the CPU: ``--max-runtime`` stops a fit with
exit 75 and an emergency mid-EM checkpoint, SIGTERM does the same in a
subprocess, and ``--resume auto`` then finishes byte-identical to the
uninterrupted run; the supervisor's own contract (the injected preempt,
the deadline, the inert default).

The fits run long enough (400 EM iterations per K, about a second on one
core) that the deadline and the signal land inside the first K's EM,
polled every iteration.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from cuda_gmm_mpi_tpu_torch import supervisor
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.testing import faults

from .test_torch_cli import blob_csv  # noqa: F401  (fixture)
from .test_torch_health import one_torch_thread  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parents[1]
LONG = ["--device=cpu", "--dtype=float64", "--min-iters=400",
        "--max-iters=400", "--preempt-poll-iters=1", "--chunk-size=2048"]


def argv(csv, out, *extra):
    return ["8", csv, str(out), "6"] + LONG + list(extra)


@pytest.fixture(scope="module")
def uninterrupted(blob_csv, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("ref") / "u"
    assert torch_main(argv(blob_csv, out)) == 0
    return {ext: Path(str(out) + ext).read_bytes()
            for ext in (".summary", ".results")}


def _substeps(ck):
    return sorted(p.name for p in (ck / "sweep").iterdir()
                  if ".iter" in p.name)


def test_max_runtime_exit_75_then_resume(blob_csv, uninterrupted,  # noqa: F811
                                         tmp_path, capsys):
    ck = tmp_path / "ck"
    assert torch_main(argv(blob_csv, tmp_path / "x", f"--checkpoint-dir={ck}",
                           "--max-runtime=0.3")) == 75
    assert "resumable from step 0 iteration" in capsys.readouterr().err
    assert _substeps(ck) and _substeps(ck)[0].startswith("0.iter")
    assert torch_main(argv(blob_csv, tmp_path / "r", f"--checkpoint-dir={ck}",
                           "--resume=auto")) == 0
    assert not _substeps(ck)
    for ext, want in uninterrupted.items():
        assert (tmp_path / ("r" + ext)).read_bytes() == want, ext


def test_sigterm_exit_75_then_resume(blob_csv, uninterrupted,  # noqa: F811
                                     tmp_path):
    ck = tmp_path / "ck"
    # One torch thread, as the in-process fits of this module run.
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuda_gmm_mpi_tpu_torch.cli",
         *argv(blob_csv, tmp_path / "x", f"--checkpoint-dir={ck}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 50
        # Signal once the fit is inside its EM: the checkpoint directory
        # exists once the sweep has started.
        while not (ck / "sweep").is_dir() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err[-2000:]
    assert "emergency checkpoint written" in err
    assert "resumable from step 0 iteration" in err
    assert _substeps(ck)
    assert torch_main(argv(blob_csv, tmp_path / "r",
                           f"--checkpoint-dir={ck}")) == 0
    for ext, want in uninterrupted.items():
        assert (tmp_path / ("r" + ext)).read_bytes() == want, ext


def test_poll_takes_the_injected_preempt_once():
    sup = supervisor.RunSupervisor(install_signals=False)
    with faults.use({"preempt": {"iter": 3}}) as plan:
        assert not sup.poll(where="em", k=5, em_iter=2)
        assert not sup.poll(where="sweep", k=5)  # no em_iter: never fires
        assert sup.poll(where="em", k=5, em_iter=3)
        assert plan.fired["preempt"] == 1
    assert sup.stop_reason == "preempt_injected"
    with pytest.raises(supervisor.PreemptedError, match="resumable") as ei:
        sup.raise_stop(step=1, em_iter=3, checkpointed=True)
    assert (ei.value.step, ei.value.em_iter) == (1, 3)
    sup.reset_for_retry()
    assert not sup.poll(where="em", k=5, em_iter=3)


def test_deadline_and_inert_default():
    sup = supervisor.RunSupervisor(max_runtime_s=0.05, install_signals=False)
    with supervisor.use(sup):
        assert supervisor.current() is sup and supervisor.current().active
        assert not sup.poll(where="sweep", k=1)
        time.sleep(0.1)
        assert sup.poll(where="sweep", k=1)
        assert sup.stop_reason == "deadline"
    assert not supervisor.current().active
    assert not supervisor.current().poll(where="sweep", k=1)
    assert (supervisor.EX_SOFTWARE, supervisor.EX_IOERR,
            supervisor.EX_TEMPFAIL) == (70, 74, 75)


def test_mesh_supervision_resumes_like_one_process(tmp_path):
    """Checkpoints, --max-runtime and the supervisor run on a mesh model
    too: a stop at EM iteration 3 on a (1, 1) mesh writes the emergency
    sub-step, and the resumed fit equals the uninterrupted one."""
    from cuda_gmm_mpi_tpu_torch import GMMConfig, fit_gmm

    data = np.random.default_rng(0).normal(size=(256, 2))
    data[:128] += 6.0
    cfg = dict(device="cpu", dtype="float64", mesh_shape=(1, 1),
               min_iters=6, max_iters=6, preempt_poll_iters=1,
               checkpoint_dir=str(tmp_path / "ck"))
    ref = fit_gmm(data, 4, 2, config=GMMConfig(
        **dict(cfg, checkpoint_dir=None)))
    with pytest.raises(supervisor.PreemptedError) as ei:
        with faults.use({"preempt": {"iter": 3}}), supervisor.use(
                supervisor.RunSupervisor(install_signals=False)):
            fit_gmm(data, 4, 2, config=GMMConfig(**cfg))
    assert ei.value.step == 0 and ei.value.em_iter == 3
    with supervisor.use(supervisor.RunSupervisor(install_signals=False)):
        res = fit_gmm(data, 4, 2, config=GMMConfig(**cfg))
    assert res.ideal_num_clusters == ref.ideal_num_clusters
    assert res.final_loglik == ref.final_loglik
    assert [m[1] for m in res.merges] == [m[1] for m in ref.merges]
    with pytest.raises(supervisor.PreemptedError, match="deadline"):
        fit_gmm(data, 4, 2, config=GMMConfig(**dict(
            cfg, max_runtime_s=1e-9, checkpoint_dir=str(tmp_path / "ck2"))))