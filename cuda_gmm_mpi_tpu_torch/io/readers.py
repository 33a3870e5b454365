"""Input data readers: CSV (with header drop) and BIN, on the numpy path.

Python/NumPy implementation of the reference's ``readData.cpp`` semantics:

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


def read_data(path: str) -> np.ndarray:
    """Read every event of ``path`` as a float32 [num_events, D] array."""
    return read_bin(path) if path.endswith("bin") else read_csv(path)


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
