"""ctypes bindings to the native C++ I/O library (native/gmm_io.cpp).

The reference's data path is native C++ (readData.cpp); this module keeps
that property for the port: a small C++ shared library, the repository's
``native/libgmm_io.so``, does the hot text parsing and formatting, loaded
with ctypes. Callers check ``available()`` and take the NumPy paths
otherwise (``use_native='auto'``), or raise (``'always'``).

The library is built on first use by ``ensure_built()`` with ``make -C
native``. This is the port's own copy of the JAX package's bindings.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgmm_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def ensure_built(force: bool = False) -> bool:
    """Build libgmm_io.so via make if missing or stale. Returns True on
    success (make itself is a no-op when the .so is up to date)."""
    makefile = os.path.join(_NATIVE_DIR, "Makefile")
    if os.path.exists(_LIB_PATH) and not force:
        try:
            lib_mtime = os.path.getmtime(_LIB_PATH)
            srcs = [makefile, os.path.join(_NATIVE_DIR, "gmm_io.cpp")]
            if all(os.path.getmtime(s) <= lib_mtime
                   for s in srcs if os.path.exists(s)):
                return True
        except OSError:
            return True  # can't stat sources; use the existing library
    if not os.path.exists(makefile):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "libgmm_io.so"],
            check=True, capture_output=True, timeout=120,
        )
    except Exception:
        return False
    return os.path.exists(_LIB_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.gmm_read_data.restype = ctypes.c_int
        lib.gmm_read_data.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.gmm_data_shape.restype = ctypes.c_int
        lib.gmm_data_shape.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.gmm_read_range.restype = ctypes.c_int
        lib.gmm_read_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.gmm_free.restype = None
        lib.gmm_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.gmm_write_results.restype = ctypes.c_int
        lib.gmm_write_results.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gmm_results_open.restype = ctypes.c_void_p
        lib.gmm_results_open.argtypes = [ctypes.c_char_p]
        lib.gmm_results_append.restype = ctypes.c_int
        lib.gmm_results_append.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gmm_results_close.restype = ctypes.c_int
        lib.gmm_results_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def select(use_native: str):
    """This module when ``use_native`` ('auto', 'always' or 'never') lets
    a reader or writer use the library and it loads; None for the Python
    path. 'always' raises when the library is unavailable."""
    if use_native not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_native: {use_native!r}")
    if use_native == "never":
        return None
    if available():
        return sys.modules[__name__]
    if use_native == "always":
        raise RuntimeError("native gmm_io library unavailable "
                           "(use_native='always')")
    return None


def read_data(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native gmm_io library unavailable")
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    buf = ctypes.POINTER(ctypes.c_float)()
    rc = lib.gmm_read_data(path.encode(), ctypes.byref(n), ctypes.byref(d),
                           ctypes.byref(buf))
    if rc != 0:
        raise ValueError(f"native reader failed on {path!r} (rc={rc})")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n.value, d.value)).copy()
    finally:
        lib.gmm_free(buf)
    return arr


def data_shape(path: str):
    """(num_events, num_dims) without loading the payload (BIN: header only;
    CSV: one streaming pass, O(1) memory)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native gmm_io library unavailable")
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    rc = lib.gmm_data_shape(path.encode(), ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise ValueError(f"native shape probe failed on {path!r} (rc={rc})")
    return n.value, d.value


def read_range(path: str, start: int, stop=None) -> np.ndarray:
    """Rows [start, stop) as float32 [rows, D]; peak memory O(slice).
    ``stop=None`` reads to the end of the file in a single pass."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native gmm_io library unavailable")
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    buf = ctypes.POINTER(ctypes.c_float)()
    rc = lib.gmm_read_range(path.encode(), start,
                            -1 if stop is None else stop,
                            ctypes.byref(n), ctypes.byref(d),
                            ctypes.byref(buf))
    if rc != 0:
        raise ValueError(
            f"native range read failed on {path!r}[{start}:{stop}] (rc={rc})"
        )
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n.value, d.value)).copy()
    finally:
        lib.gmm_free(buf)
    return arr


class ResultsWriter:
    """Streaming .results writer: append event blocks, bounded memory.

    Context manager over the native handle API (gmm_results_open/append/
    close); the full N x K posterior matrix never has to exist.
    """

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native gmm_io library unavailable")
        self._lib = lib
        self._h = lib.gmm_results_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path!r} for writing")
        self._path = path

    def append(self, data: np.ndarray, memberships: np.ndarray) -> None:
        data = np.ascontiguousarray(data, np.float32)
        memberships = np.ascontiguousarray(memberships, np.float32)
        n, d = data.shape
        k = memberships.shape[1]
        if memberships.shape[0] != n:
            raise ValueError("data/membership row mismatch")
        rc = self._lib.gmm_results_append(
            self._h,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            memberships.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, d, k,
        )
        if rc != 0:
            raise IOError(f"native append failed on {self._path!r} (rc={rc})")

    def close(self) -> None:
        if self._h:
            rc = self._lib.gmm_results_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(f"close failed on {self._path!r} (rc={rc})")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # An exception is already propagating (e.g. append() failed);
            # a failing close() must not mask it.
            try:
                self.close()
            except IOError:
                pass
            return False
        self.close()


def write_results(path: str, data: np.ndarray, memberships: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native gmm_io library unavailable")
    data = np.ascontiguousarray(data, np.float32)
    memberships = np.ascontiguousarray(memberships, np.float32)
    n, d = data.shape
    k = memberships.shape[1]
    rc = lib.gmm_write_results(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        memberships.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, d, k,
    )
    if rc != 0:
        raise IOError(f"native writer failed on {path!r} (rc={rc})")
