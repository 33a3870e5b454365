"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc.

Each source becomes its own shared library with a plain C interface, bound
with ctypes; a source may export several entry points (K1, K3 in both
forms, K5 and K6 share fused_stats.cu, K2 and K4 share mstep.cu, S1 is
score.cu's). Libraries are built on first use into the package's
``build/`` directory (git-ignored), named by a hash of the source and the
flags so an edited source is rebuilt; all sources are compiled by parallel
nvcc processes. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Per-source extra flags: K2/K4 must not contract a*b-c into an FMA (their
# N, means and R are held bit-identical to the torch-ops update; the
# factorization spells its FMAs out).
EXTRA_FLAGS = {"mstep.cu": ["--fmad=false"]}

_P, _I = ctypes.c_void_p, ctypes.c_int
# {source: [(entry point, argtypes), ...]}; every entry point returns
# cudaGetLastError() as an int.
SIGNATURES = {
    "fused_stats.cu": [("gmm_fused_stats", [_P] * 10 + [_I] * 8 + [_P]),
                       ("gmm_fused_stats_batched", [_P] * 11 + [_I] * 9 + [_P]),
                       ("gmm_local_lse", [_P] * 5 + [_I] * 8 + [_P]),
                       ("gmm_stats_logz", [_P] * 11 + [_I] * 8 + [_P]),
                       ("gmm_shard_occupancy", [_I] * 3 + [_P]),
                       ("gmm_fused_stats_fleet", [_P] * 12 + [_I] * 10 + [_P]),
                       ("gmm_stats_occupancy", [_I] * 4 + [_P])],
    "mstep.cu": [("gmm_mstep", [_P] * 12 + [_I] * 4 + [_P])],
    "score.cu": [("gmm_score", [_P] * 6 + [_I] * 14 + [_P])],
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """nvcc from PATH, else from the toolkit PyTorch itself locates."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit required)")


def _target(src: str) -> tuple[Path, list[str]]:
    flags = ARCH + BASE_FLAGS + EXTRA_FLAGS.get(src, [])
    digest = hashlib.sha256(
        (CSRC / src).read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}-{digest}.so", flags


def build_all() -> dict:
    """Compile every source that is not built yet, one nvcc each, all
    started together. Returns {source: library path}. Raises on a failed
    build with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, paths = [], {}
    for src in SIGNATURES:
        out, flags = _target(src)
        paths[src] = out
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc()] + flags + ["-o", str(tmp), str(CSRC / src)]
            todo.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for src, out, tmp, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _load(src: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_all()[src]))
    for name, argtypes in SIGNATURES[src]:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(src: str) -> ctypes.CDLL:
    """The loaded library of ``src`` (built on first use; under an active
    compile watch the build and load are one ``kernel_library`` compile
    event)."""
    from ...telemetry.profiling import site_compile

    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = _libs[src] = site_compile(
                "kernel_library", lambda: _load(src), source=src)
        return lib
