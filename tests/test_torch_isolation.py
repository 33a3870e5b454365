"""The port stands alone and never hides the device or the kernel.

- No file of the port (nor chip_smoke.py) imports jax or the JAX package.
  This image preloads jax into every process, so the check scans the
  sources (AST) instead of inspecting sys.modules.
- Entry points raise without a GPU unless asked for the CPU.
- The kernel wrappers take their plain versions only for CPU tensors.
"""

import ast
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu_torch import GaussianMixture, GMMConfig, GMMModel, fit_gmm
from cuda_gmm_mpi_tpu_torch.cli import main as torch_main
from cuda_gmm_mpi_tpu_torch.ops.kernels import fused_stats as fs
from cuda_gmm_mpi_tpu_torch.ops.kernels import resolve_estep_backend

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "cuda_gmm_mpi_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "cuda_gmm_mpi_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    assert {"sharded_em.py", "mesh.py", "distributed.py", "elastic.py"} <= {
        p.name for p in files if p.parent.name == "parallel"}
    assert REPO / "cuda_gmm_mpi_tpu_torch" / "supervisor.py" in files
    assert (REPO / "cuda_gmm_mpi_tpu_torch" / "estimator.py") in files
    models = REPO / "cuda_gmm_mpi_tpu_torch" / "models"
    assert {models / "fused_sweep.py", models / "em_program.py",
            models / "streaming.py"} <= set(files)
    assert REPO / "cuda_gmm_mpi_tpu_torch" / "io" / "pipeline.py" in files
    tel = REPO / "cuda_gmm_mpi_tpu_torch" / "telemetry"
    assert {tel / f"{m}.py" for m in (
        "spans", "report", "profiling", "sketch", "exporter", "diff",
        "timeline")} <= set(files)
    assert REPO / "cuda_gmm_mpi_tpu_torch" / "utils" / "profiling.py" in files
    serving = REPO / "cuda_gmm_mpi_tpu_torch" / "serving"
    assert {serving / f"{m}.py" for m in (
        "wire", "registry", "executor", "breaker", "server", "http",
        "client", "pool")} | {tel / "drift.py"} <= set(files)
    tuning = REPO / "cuda_gmm_mpi_tpu_torch" / "tuning"
    lifecycle = REPO / "cuda_gmm_mpi_tpu_torch" / "lifecycle"
    assert {tuning / f"{m}.py" for m in (
        "__init__", "db", "cost", "probe", "autotune", "cli")} | {
        lifecycle / f"{m}.py" for m in ("__init__", "controller", "cli")
    } <= set(files)
    tenancy = REPO / "cuda_gmm_mpi_tpu_torch" / "tenancy"
    assert {tenancy / f"{m}.py" for m in (
        "__init__", "packing", "fleet", "cli")} <= set(files)
    for path in files:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert GMMConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GMMModel(GMMConfig())
    data = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_gmm(data, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianMixture(2).fit(data)
    csv = tmp_path / "e.csv"
    csv.write_text("a,b\n" + "\n".join(f"{a},{b}" for a, b in data))
    assert torch_main(["2", str(csv), str(tmp_path / "o")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.summary").exists()
    # A fleet fit and `gmm fleet` (tenancy/) too.
    from cuda_gmm_mpi_tpu_torch.tenancy import TenantSpec, fit_fleet

    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_fleet([TenantSpec("a", data, 2)])
    manifest = tmp_path / "fleet.json"
    manifest.write_text(
        f'[{{"name": "a", "infile": "{csv}", "num_clusters": 2}}]')
    assert torch_main(["fleet", str(manifest), "--out-dir",
                       str(tmp_path / "f")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "f").exists()
    # Asked for the CPU, the same calls run.
    cfg = GMMConfig(device="cpu", min_iters=2, max_iters=2)
    assert fit_gmm(data, 2, config=cfg).ideal_num_clusters >= 1
    assert not fit_fleet([TenantSpec("a", data, 2)], cfg).dropped


def test_streaming_entry_points_raise_without_cuda(monkeypatch, tmp_path,
                                                  capsys):
    """The streaming model, a resident and a pipelined streaming fit and
    the CLI's --stream-events/--ingest=pipelined raise (exit 1) without a
    GPU, before any block is read; asked for the CPU they run."""
    from cuda_gmm_mpi_tpu_torch.io import FileSource, write_bin
    from cuda_gmm_mpi_tpu_torch.models.streaming import StreamingGMMModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    path = str(tmp_path / "e.bin")
    write_bin(path, data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingGMMModel(GMMConfig(stream_events=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_gmm(data, 2, config=GMMConfig(stream_events=True))
    for mode in ("resident", "pipelined"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit_gmm(FileSource(path), 2, config=GMMConfig(
                stream_events=True, ingest=mode))
        assert torch_main(["2", path, str(tmp_path / "o"), "--stream-events",
                           f"--ingest={mode}"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.summary").exists()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("gmm-ingest")]
    cfg = GMMConfig(device="cpu", min_iters=2, max_iters=2,
                    stream_events=True, ingest="pipelined")
    assert fit_gmm(FileSource(path), 2, config=cfg).ideal_num_clusters >= 1


def test_serving_entry_points_raise_without_cuda(monkeypatch, tmp_path,
                                                capsys):
    """``gmm serve``, ``gmm export --checkpoint``, ``gmm drift`` and
    ``GaussianMixture.from_registry(...).predict`` raise (the CLIs exit
    non-zero naming the missing device) without a GPU; asked for the CPU
    they run."""
    from cuda_gmm_mpi_tpu_torch.io import write_bin

    data = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    ck, reg = str(tmp_path / "ck"), str(tmp_path / "reg")
    cpu = GMMConfig(device="cpu", min_iters=2, max_iters=2,
                    checkpoint_dir=ck)
    fit_gmm(data, 3, config=cpu)
    GaussianMixture(2, **{"device": "cpu", "min_iters": 2,
                          "max_iters": 2}).fit(data).to_registry(reg, "m")
    path = str(tmp_path / "e.bin")
    write_bin(path, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianMixture.from_registry(reg, "m").predict(data)
    assert torch_main(["serve", "--registry", reg, "--input", path]) == 1
    assert torch_main(["export", "--registry", reg, "--name", "a",
                       "--checkpoint", ck]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert torch_main(["drift", path, "--registry", reg, "--model",
                       "m"]) == 2
    assert "no CUDA device" in capsys.readouterr().out
    from cuda_gmm_mpi_tpu_torch.serving import GMMServer, ModelRegistry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        GMMServer(ModelRegistry(reg))
    assert not (tmp_path / "reg" / "a").exists()
    # Asked for the CPU, the same calls run.
    cpu_gm = GaussianMixture.from_registry(reg, "m",
                                           config=GMMConfig(device="cpu"))
    assert cpu_gm.predict(data).shape == (64,)
    assert torch_main(["export", "--registry", reg, "--name", "a",
                       "--checkpoint", ck, "--device", "cpu"]) == 0


def test_s1_takes_its_plain_version_only_on_the_cpu():
    """S1 on CPU tensors is ``posteriors``; off the CPU the launch path
    refuses what it cannot launch, and no launch is counted."""
    from cuda_gmm_mpi_tpu_torch.ops.estep import posteriors
    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1
    from cuda_gmm_mpi_tpu_torch.state import zeros_state

    st = zeros_state(4, 3, dtype=torch.float64)
    st = st.replace(pi=torch.full((4,), 0.25, dtype=torch.float64),
                    Rinv=torch.eye(3, dtype=torch.float64).repeat(4, 1, 1),
                    active=torch.tensor([True, True, False, True]))
    x = torch.randn(10, 3, dtype=torch.float64)
    before = s1.score.launches
    w, z = s1.score(st, x, diag_only=False)
    wp, zp = posteriors(st, x)
    assert torch.equal(w, wp) and torch.equal(z, zp)
    lab, _ = s1.score(st, x, diag_only=False, kind="assign")
    assert torch.equal(lab, torch.argmax(wp, dim=1).to(torch.int32))
    meta = lambda *s: torch.empty(s, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        s1.score(st.to("meta"), meta(10, 3), diag_only=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        s1.score_launch(x, *s1.score_operands(st, False),
                        torch.empty(10, dtype=torch.float64), diag=False,
                        w=torch.empty(10, 4, dtype=torch.float64))
    assert s1.score.launches == before


def test_s1_centered_form_takes_its_plain_version_only_on_the_cpu():
    """Under 'centered' S1 on CPU tensors is ``posteriors(quad_mode=
    'centered')``, full and diag; off the CPU its operands (mu in A_ext's
    last D rows, g = constant + ln pi) go to the launch path, which refuses
    what it cannot launch."""
    from cuda_gmm_mpi_tpu_torch.ops.estep import posteriors
    from cuda_gmm_mpi_tpu_torch.ops.kernels import score as s1
    from cuda_gmm_mpi_tpu_torch.state import zeros_state

    st = zeros_state(4, 3, dtype=torch.float64)
    st = st.replace(pi=torch.full((4,), 0.25, dtype=torch.float64),
                    means=torch.arange(12, dtype=torch.float64).reshape(4, 3),
                    Rinv=torch.eye(3, dtype=torch.float64).repeat(4, 1, 1),
                    active=torch.tensor([True, True, False, True]))
    x = torch.randn(10, 3, dtype=torch.float64)
    before = s1.score.launches
    for diag in (False, True):
        w, z = s1.score(st, x, diag_only=diag, quad_mode="centered")
        wp, zp = posteriors(st, x, diag_only=diag, quad_mode="centered")
        assert torch.equal(w, wp) and torch.equal(z, zp)
        a, g = s1.score_operands(st, diag, centered=True)
        assert torch.equal(a[-3:], st.means.T)
        assert torch.equal(g[st.active], torch.log(st.pi)[st.active])
        assert bool(torch.isneginf(g[~st.active]).all())
    meta = lambda *s: torch.empty(s, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        s1.score(st.to("meta"), meta(10, 3), diag_only=False,
                 quad_mode="centered")
    with pytest.raises(ValueError, match="quad_mode"):
        s1.score(st, x, diag_only=False, quad_mode="tiled")
    assert s1.score.launches == before


@pytest.mark.parametrize("quad_mode", ["expanded", "packed", "centered"])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_executor_routes_every_precision_to_s1_on_the_card(
        monkeypatch, precision, quad_mode):
    """On a CUDA device the executor's route is S1 at every precision and
    quad mode (the torch-ops route is a yardstick a caller sets, never a
    fallback); on the CPU it is the eager plain version."""
    from cuda_gmm_mpi_tpu_torch.serving import ScoringExecutor

    assert ScoringExecutor(device="cpu", matmul_precision=precision,
                           quad_mode=quad_mode).route == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ex = ScoringExecutor(device="cuda", matmul_precision=precision,
                         quad_mode=quad_mode)
    assert ex.route == "S1"
    assert ex._centered == (quad_mode == "centered")


def test_tuning_and_lifecycle_entry_points_need_the_card_or_the_cpu(
        monkeypatch, tmp_path, capsys):
    """Without a GPU `gmm tune` exits 1 and `gmm lifecycle` 2, naming the
    missing device, and an offline controller's executor raises; asked for
    the CPU, `gmm tune` runs."""
    from cuda_gmm_mpi_tpu_torch.lifecycle import (LifecycleController,
                                                  LifecyclePolicy)
    from cuda_gmm_mpi_tpu_torch.serving import ModelRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = str(tmp_path / "t.json")
    assert torch_main(["tune", "--n", "64", "--d", "2", "--k", "2",
                       "--tuning-db", db]) == 1
    stream = tmp_path / "s.jsonl"
    stream.write_text("")
    pol = tmp_path / "p.json"
    pol.write_text("{}")
    assert torch_main(["lifecycle", str(stream), "--registry",
                       str(tmp_path / "reg"), "--policy", str(pol)]) == 2
    assert capsys.readouterr().err.count("no CUDA device") == 2
    ctl = LifecycleController(ModelRegistry(str(tmp_path / "reg")),
                              LifecyclePolicy())
    assert ctl.device == "cuda"
    assert torch_main(["tune", "--n", "64", "--d", "2", "--k", "2",
                       "--probe-iters", "1", "--tuning-db", db,
                       "--device", "cpu"]) == 0
    capsys.readouterr()


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses what it cannot launch instead of running the plain version."""
    meta = lambda *s: torch.empty(s, device="meta")
    args = (meta(128, 3), meta(128), meta(9, 4), meta(3, 4), meta(1, 4))
    before = (fs.fused_stats.launches, fs.mstep.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stats(*args, diag=False)
    with pytest.raises(ValueError, match="CUDA tensors"):  # K1 runs 'high'
        fs.fused_stats(*args, diag=False, precision="high")
    with pytest.raises(ValueError, match="CUDA tensors"):  # K5 runs 'high'
        fs.local_lse(*args[:1], *args[2:], diag=False, precision="high")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.mstep(meta(4), meta(4, 3), meta(4, 9), meta(4), meta(4),
                 diag=False)
    assert (fs.fused_stats.launches, fs.mstep.launches) == before


def test_batched_kernel_wrappers_do_not_fall_back_off_the_cpu():
    meta = lambda *s: torch.empty(s, device="meta")
    args = (meta(128, 3), meta(128), meta(2), meta(2, 9, 4), meta(2, 3, 4),
            meta(2, 1, 4))
    before = (fs.fused_stats_batched.launches, fs.mstep_batched.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stats_batched(*args, diag=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.mstep_batched(meta(2, 4), meta(2, 4, 3), meta(2, 4, 9),
                         meta(2, 4), meta(2, 4), diag=False)
    assert (fs.fused_stats_batched.launches,
            fs.mstep_batched.launches) == before
    # K3's per-lane-events form (a fleet group's 'vmap' statistics).
    lanes_x = (meta(2, 128, 3), meta(2, 128), meta(2), meta(2))
    before = fs.fused_stats_fleet.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stats_fleet(*lanes_x, *args[3:], diag=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stats_fleet(*lanes_x, *args[3:], diag=False,
                             precision="default")
    assert fs.fused_stats_fleet.launches == before


def test_sharded_kernel_wrappers_do_not_fall_back_off_the_cpu():
    meta = lambda *s: torch.empty(s, device="meta")
    before = (fs.local_lse.launches, fs.stats_logz.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.local_lse(meta(128, 3), meta(9, 4), meta(3, 4), meta(1, 4),
                     diag=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.stats_logz(meta(128, 3), meta(128), meta(128, 1), meta(9, 4),
                      meta(3, 4), meta(1, 4), diag=False)
    assert (fs.local_lse.launches, fs.stats_logz.launches) == before


@pytest.mark.parametrize("diag,dtype,mode,expected", [
    (True, "float32", "auto", "cuda"),    # K5 + K6, torch-ops M-step
    (False, "float32", "auto", "torch"),  # full covariance: one contraction
    (True, "float64", "auto", "torch"),
    (True, "float32", "torch", "torch"),
])
def test_mesh_backend_routing(diag, dtype, mode, expected):
    """JAX's routing on a cluster-sharded mesh; a data-only mesh keeps K1
    and K2 per rank."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_mstep_fn, make_stats_fn

    cfg = GMMConfig(device="cuda", dtype=dtype, diag_only=diag,
                    estep_backend=mode)
    backend, reason = resolve_estep_backend(cfg, cluster_sharded=True)
    assert backend == expected
    if not diag:
        assert "cluster-sharded full covariance" in reason
    hook = make_stats_fn(cfg, cluster_sharded=True, cluster_group=None)
    assert (hook is not None and hook.func is fs.fused_stats_cuda_sharded) \
        == (expected == "cuda")
    assert make_mstep_fn(cfg, cluster_sharded=True) is None
    if resolve_estep_backend(cfg)[0] == "cuda":
        assert make_stats_fn(cfg).func is fs.fused_stats_cuda
        assert make_mstep_fn(cfg) is not None


@pytest.mark.parametrize("device,local_world,world,gpus,expected", [
    ("cuda", "8", 16, 8, "nccl"),   # 2 nodes x 8 GPUs under torchrun
    ("cuda", None, 4, 8, "nccl"),   # one host, a GPU per rank
    ("cuda", None, 4, 1, "gloo"),   # 4 ranks share one GPU
    ("cuda", "4", 4, 1, "gloo"),
    ("cpu", "2", 2, 8, "gloo"),
])
def test_collective_backend_counts_ranks_per_host(
        monkeypatch, device, local_world, world, gpus, expected):
    from cuda_gmm_mpi_tpu_torch.parallel.distributed import choose_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert choose_backend(device, world) == expected


def test_batched_hooks_follow_the_routing():
    """The kernel path gets K3/K4 hooks; the torch-ops path loops the
    unbatched functions over the lanes."""
    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_batched_stats_fn, make_mstep_fn

    from cuda_gmm_mpi_tpu_torch.ops.kernels import make_fleet_stats_fn

    cuda = GMMConfig(device="cuda")
    assert make_batched_stats_fn(cuda).func is fs.fused_stats_cuda_batched
    assert make_fleet_stats_fn(cuda).func is fs.fused_stats_cuda_fleet
    assert make_fleet_stats_fn(cuda, cluster_sharded=True) is None
    assert make_mstep_fn(cuda, batched=True) is not None
    cpu = GMMConfig(device="cpu")
    assert make_batched_stats_fn(cpu) is None
    assert make_fleet_stats_fn(cpu) is None
    model = GMMModel(cpu)
    assert model.batched_stats_fn.__qualname__.startswith("lane_loop_stats")
    assert model.batched_mstep_fn.__qualname__.startswith("lane_loop_mstep")


@pytest.mark.parametrize("device,dtype,mode,expected", [
    ("cuda", "float32", "auto", "cuda"),
    ("cuda", "float32", "cuda", "cuda"),
    ("cuda", "float32", "torch", "torch"),
    ("cuda", "float64", "auto", "torch"),
    ("cpu", "float32", "auto", "torch"),
    ("cpu", "float64", "torch", "torch"),
])
def test_backend_routing(device, dtype, mode, expected):
    backend, reason = resolve_estep_backend(
        GMMConfig(device=device, dtype=dtype, estep_backend=mode))
    assert backend == expected
    if dtype == "float64" and mode != "torch":
        assert reason == "kernel is float32-only (dtype=float64)"


def test_cuda_backend_refuses_the_cpu():
    with pytest.raises(ValueError, match="needs device='cuda'"):
        resolve_estep_backend(GMMConfig(device="cpu", estep_backend="cuda"))


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and "kernels" not in r.stdout
