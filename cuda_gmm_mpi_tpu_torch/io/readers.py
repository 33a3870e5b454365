"""Input data readers: CSV (with header drop) and BIN, native or numpy.

``use_native`` picks the reader: 'auto' tries the native C++ reader
(``io/native.py``, native/gmm_io.cpp) and falls back to the Python path;
'always' requires it; 'never' forces the Python path. The Python/NumPy path
implements the reference's ``readData.cpp`` semantics:

- dispatch on filename: names ending in "bin" -> binary, else CSV
  (readData.cpp:25-33 -- the reference compares the last 3 chars)
- BIN layout: int32 num_events, int32 num_dimensions, then
  num_events*num_dimensions float32 row-major (readData.cpp:35-47)
- CSV: comma-delimited; dimension count taken from the first line; the FIRST
  LINE IS DROPPED as a header (readData.cpp:84); blank lines skipped
  (readData.cpp:61); ragged rows -> error (readData.cpp:104-107); fields parsed
  with atof semantics (invalid text parses as 0.0)
"""

from __future__ import annotations

import numpy as np


class TruncatedInputError(ValueError):
    """The input file is torn: a BIN header/payload shorter than its own
    declared size (a partial copy, a crashed writer)."""


def read_data(path: str, use_native: str = "auto", screen: str = "off",
              screen_dtype=None) -> np.ndarray:
    """Read every event of ``path`` as a float32 [num_events, D] array.

    A BIN file the native reader rejects is re-read by the Python reader,
    so a torn header or payload surfaces as :class:`TruncatedInputError`
    (as in the JAX package's reader). ``screen`` ('off', 'reject' or
    'quarantine') runs :func:`screen_nonfinite` on the rows."""
    from .native import select

    native = select(use_native)
    data = None
    if native is not None:
        try:
            data = native.read_data(path)
        except ValueError:
            if not path.endswith("bin"):
                raise
    if data is None:
        data = read_bin(path) if path.endswith("bin") else read_csv(path)
    if screen != "off":
        data, _ = screen_nonfinite(data, path, mode=screen,
                                   dtype=screen_dtype)
    return data


def screen_nonfinite(data: np.ndarray, path: str, *, mode: str = "reject",
                     dtype=None):
    """Input-integrity screen (the JAX package's, io/readers.py): reject or
    quarantine NaN/Inf event rows. Returns ``(data, n_dropped)``.
    ``mode='reject'`` raises ``InvalidInputError`` naming the first
    offending rows; ``'quarantine'`` drops them with a warning. ``dtype``
    also treats magnitudes that overflow the compute dtype as non-finite.
    Row numbers are 0-based data rows (after a CSV header)."""
    if mode not in ("reject", "quarantine"):
        raise ValueError(f"unknown screen mode: {mode!r}")
    finite = np.isfinite(data)
    if dtype is not None and np.dtype(dtype).itemsize < data.dtype.itemsize:
        finite &= np.abs(data) <= np.finfo(dtype).max
    row_ok = finite.all(axis=1)
    bad = np.flatnonzero(~row_ok)
    if bad.size == 0:
        return data, 0
    shown = ", ".join(str(int(b)) for b in bad[:5])
    more = ", ..." if bad.size > 5 else ""
    if mode == "reject":
        from ..validation import InvalidInputError

        raise InvalidInputError(
            f"{path}: {bad.size} non-finite event row(s) at ingest "
            f"(data rows {shown}{more}); NaN/Inf events poison every "
            "downstream statistic -- clean the file, or quarantine with "
            "--allow-nonfinite")
    from ..utils.logging_ import get_logger

    get_logger().warning(
        "%s: quarantined %d non-finite event row(s) at ingest (data rows "
        "%s%s) -- they are EXCLUDED from the fit", path, bad.size, shown,
        more)
    return np.ascontiguousarray(data[row_ok]), int(bad.size)


def data_shape(path: str, use_native: str = "auto"):
    """(num_events, num_dimensions) without loading the payload: BIN reads
    its 8-byte header, CSV makes one streaming pass counting the non-blank
    lines after the header."""
    from .native import select

    native = select(use_native)
    if native is not None:
        return native.data_shape(path)
    if path.endswith("bin"):
        with open(path, "rb") as f:
            header = np.fromfile(f, dtype=np.int32, count=2)
        if header.size != 2:
            raise TruncatedInputError(f"{path}: truncated BIN header")
        return int(header[0]), int(header[1])
    num_dims, rows = None, 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8").strip("\r\n")
            if line == "":
                continue
            if num_dims is None:
                num_dims = line.count(",") + 1
            else:
                rows += 1
    if num_dims is None:
        raise ValueError(f"{path}: empty input file")
    return rows, num_dims


def read_bin(path: str) -> np.ndarray:
    """BIN rows: an 8-byte header, then the float32 payload."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=2)
        if header.size != 2:
            raise TruncatedInputError(f"{path}: truncated BIN header")
        num_events, num_dims = int(header[0]), int(header[1])
        if num_events <= 0 or num_dims <= 0:
            raise ValueError(f"{path}: malformed BIN header {header.tolist()}")
        data = np.fromfile(f, dtype=np.float32, count=num_events * num_dims)
    if data.size != num_events * num_dims:
        raise TruncatedInputError(f"{path}: truncated BIN payload")
    return data.reshape(num_events, num_dims)


def _atof(s: str) -> float:
    """C atof semantics: parse a leading float, else 0.0 (readData.cpp:108)."""
    s = s.strip()
    try:
        return float(s)
    except ValueError:
        # atof parses the longest valid prefix; approximate cheaply
        for end in range(len(s), 0, -1):
            try:
                return float(s[:end])
            except ValueError:
                continue
        return 0.0


def _parse_fields(fields, out_row):
    try:
        for j, s in enumerate(fields):
            out_row[j] = float(s)
    except ValueError:
        for j, s in enumerate(fields):
            out_row[j] = _atof(s)


def read_csv(path: str) -> np.ndarray:
    """CSV rows, streaming: one pass, amortized-doubling row buffer.

    The first non-blank line is dropped as a header (readData.cpp:84) and sets
    the dimension count; ragged rows raise (readData.cpp:104-107).
    """
    num_dims = None
    data = None
    seen = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8").strip("\r\n")
            if line == "":
                continue  # blank lines skipped (readData.cpp:61)
            if num_dims is None:
                num_dims = line.count(",") + 1
                continue
            fields = line.split(",")
            if len(fields) != num_dims:
                raise ValueError(
                    f"{path}: row {seen + 2} has {len(fields)} fields, "
                    f"expected {num_dims}")
            if data is None:
                data = np.empty((4096, num_dims), np.float32)
            elif seen == data.shape[0]:
                data = np.concatenate([data, np.empty_like(data)])
            _parse_fields(fields, data[seen])
            seen += 1
    if num_dims is None:
        raise ValueError(f"{path}: empty input file")
    if seen == 0:
        raise ValueError(f"{path}: no data rows after header")
    return data[:seen]


def write_bin(path: str, data: np.ndarray) -> None:
    """Writer for the BIN format (test fixtures / dataset prep)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    with open(path, "wb") as f:
        np.asarray([data.shape[0], data.shape[1]], np.int32).tofile(f)
        data.tofile(f)


def read_summary(path: str) -> dict:
    """Parse a ``.summary`` model file back into arrays.

    Inverse of ``writers.write_summary`` and format-compatible with the
    reference's own output (writeCluster, gaussian.cu:1180-1197), which the
    reference never reads back; this reader makes the format a model
    interchange (``GaussianMixture.from_summary``, ``--init-from``,
    ``--predict-from``). Means and R carry the format's 3 decimals;
    Probability and N printf %f's 6.

    Returns ``{"pi": [K], "N": [K], "means": [K, D], "R": [K, D, D]}``,
    float64; ValueError on a file that is not a well-formed summary.
    """
    pis, ns, means, Rs = [], [], [], []
    cur_R = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("Cluster #"):
                cur_R = None
            elif line.startswith("Probability: "):
                pis.append(float(line.split(": ", 1)[1]))
            elif line.startswith("N: "):
                ns.append(float(line.split(": ", 1)[1]))
            elif line.startswith("Means: "):
                means.append([float(v) for v in line.split()[1:]])
            elif line.startswith("R Matrix:"):
                cur_R = []
                Rs.append(cur_R)
            elif cur_R is not None and line.strip():
                cur_R.append([float(v) for v in line.split()])
    if not pis or not (len(pis) == len(ns) == len(means) == len(Rs)):
        raise ValueError(f"{path}: not a well-formed .summary file")
    d = len(means[0])
    R = np.asarray(Rs, np.float64)
    if R.shape != (len(pis), d, d):
        raise ValueError(
            f"{path}: R blocks have shape {R.shape}, expected "
            f"({len(pis)}, {d}, {d})")
    return {
        "pi": np.asarray(pis, np.float64),
        "N": np.asarray(ns, np.float64),
        "means": np.asarray(means, np.float64),
        "R": R,
    }
