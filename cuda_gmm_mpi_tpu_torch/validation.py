"""Input-data validation shared by the fit and CLI paths.

The reference's ``atof``-based reader (readData.cpp:49-129) admits NaN/Inf
values silently, and they poison every statistic downstream. This module
rejects them before any arithmetic touches the data.
"""

from __future__ import annotations

import numpy as np


class InvalidInputError(ValueError):
    """The input data itself is unusable (e.g. non-finite event rows).

    A dedicated type so the CLI can give data-content problems the
    reference's one-line abort style while genuine internal ValueErrors
    still crash loudly with their tracebacks."""


def finite_row_stats(local: np.ndarray, start: int = 0, dtype=None):
    """(n_bad, first_bad_global_row) for one slice of rows."""
    finite = np.isfinite(local)
    if dtype is not None and np.dtype(dtype).itemsize < local.dtype.itemsize:
        finite &= np.abs(local) <= np.finfo(dtype).max
    finite = finite.all(axis=1)
    bad = np.flatnonzero(~finite)
    n_bad = int(bad.size)
    first_bad = start + int(bad[0]) if n_bad else -1
    return n_bad, first_bad


def raise_if_nonfinite(n_bad: int, first_bad: int,
                       collective: bool = False) -> None:
    """The verdict of :func:`validate_finite` from counts gathered by
    :func:`finite_row_stats` (one slice at a time, as pipelined ingestion
    scans them): with ``collective`` every rank of the world reaches the
    same verdict (one gather of the counts)."""
    if collective:
        from .parallel import distributed

        both = distributed.allgather_host(np.asarray([n_bad, first_bad],
                                                     np.int64))
        n_bad = int(both[:, 0].sum())
        firsts = [int(f) for f in both[:, 1] if f >= 0]
        first_bad = min(firsts) if firsts else -1
    if n_bad:
        raise InvalidInputError(
            f"input contains {n_bad} non-finite event row(s) "
            f"(first at global row {first_bad}); NaN/Inf events silently "
            "poison every statistic the reference computes -- clean the "
            "data or pass validate_input=False/--no-validate-input to "
            "proceed anyway"
        )


def validate_finite(local: np.ndarray, start: int = 0, dtype=None,
                    collective: bool = False) -> None:
    """Reject rows that are (or will become, once cast to ``dtype``, the
    compute dtype) non-finite: a value like 1e39 is finite in float64 but
    overflows to Inf in float32. With ``collective`` every rank of the
    world checks its own slice (``start`` its first global row) and all
    reach the same verdict (one gather of the counts), so a bad row on one
    rank never strands the others in a later collective."""
    n_bad, first_bad = finite_row_stats(local, start, dtype=dtype)
    raise_if_nonfinite(n_bad, first_bad, collective=collective)
