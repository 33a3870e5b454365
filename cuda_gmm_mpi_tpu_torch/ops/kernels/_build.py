"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc.

Each source becomes its own shared library with a plain C interface, bound
with ctypes. Libraries are built on first use into the package's ``build/``
directory (git-ignored), named by a hash of the source and the flags so an
edited source is rebuilt; all sources are compiled by parallel nvcc
processes. Nothing here runs at import time.
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
# Per-source extra flags: K2 must not contract a*b-c into an FMA (its output
# is held bit-identical to the torch-ops update).
EXTRA_FLAGS = {"mstep.cu": ["--fmad=false"]}

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "fused_stats.cu": ("gmm_fused_stats", [_P] * 10 + [_I] * 7 + [_P]),
    "mstep.cu": ("gmm_mstep", [_P] * 8 + [_I] * 3 + [_P]),
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


def library(src: str) -> ctypes.CDLL:
    """The loaded library of ``src`` (built on first use)."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[src]))
            name, argtypes = SIGNATURES[src]
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[src] = lib
        return lib
