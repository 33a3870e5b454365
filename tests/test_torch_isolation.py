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
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_gmm_mpi_tpu_torch import GMMConfig, GMMModel, fit_gmm
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
    csv = tmp_path / "e.csv"
    csv.write_text("a,b\n" + "\n".join(f"{a},{b}" for a, b in data))
    assert torch_main(["2", str(csv), str(tmp_path / "o")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.summary").exists()
    # Asked for the CPU, the same calls run.
    cfg = GMMConfig(device="cpu", min_iters=2, max_iters=2)
    assert fit_gmm(data, 2, config=cfg).ideal_num_clusters >= 1


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which
    refuses what it cannot launch instead of running the plain version."""
    meta = lambda *s: torch.empty(s, device="meta")
    args = (meta(128, 3), meta(128), meta(9, 4), meta(3, 4), meta(1, 4))
    before = (fs.fused_stats.launches, fs.mstep.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stats(*args, diag=False)
    with pytest.raises(ValueError, match="not ported"):
        fs.fused_stats(*args, diag=False, precision="high")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.mstep(meta(4, 1), meta(4, 3), meta(4, 9), meta(4, 1), meta(4, 1),
                 diag=False)
    assert (fs.fused_stats.launches, fs.mstep.launches) == before


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
