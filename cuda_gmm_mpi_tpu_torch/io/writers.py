"""Output writers: the reference's ``.summary`` and ``.results`` formats.

Format provenance (README.txt:79-84, gaussian.cu:998-1061, 1180-1201):

``<outfile>.summary`` -- per saved cluster:
    Cluster #<c>
    Probability: <pi %f>
    N: <N %f>
    Means: <%.3f per dim, space-separated, trailing space>

    R Matrix:
    <%.3f per entry, space-separated rows, trailing space>
    <blank><blank>

``<outfile>.results`` -- per event:
    <data CSV %f> \\t <membership CSV %f>
"""

from __future__ import annotations

from typing import IO

import numpy as np


def _fmt(x: float) -> str:
    return f"{float(x):f}"  # C printf %f: 6 decimal places


def write_cluster(f: IO[str], pi: float, n: float, means: np.ndarray,
                  R: np.ndarray) -> None:
    """One cluster block (writeCluster, gaussian.cu:1180-1197)."""
    f.write(f"Probability: {_fmt(pi)}\n")
    f.write(f"N: {_fmt(n)}\n")
    f.write("Means: " + "".join(f"{m:.3f} " for m in means) + "\n")
    f.write("\nR Matrix:\n")
    for row in R:
        f.write("".join(f"{v:.3f} " for v in row) + "\n")


def write_summary(path: str, result) -> None:
    """``<outfile>.summary`` (gaussian.cu:1014-1040): one block per cluster
    of the best model. ``result.state`` holds host tensors (``GMMResult``
    keeps it on the CPU).
    """
    means = result.means
    state = result.state
    pi, n, R = (np.asarray(state.pi), np.asarray(state.N),
                np.asarray(state.R))
    with open(path, "w") as f:
        for c in range(result.ideal_num_clusters):
            f.write(f"Cluster #{c}\n")
            write_cluster(f, float(pi[c]), float(n[c]), means[c], R[c])
            f.write("\n\n")


def write_results(path: str, data: np.ndarray, memberships: np.ndarray,
                  use_native: str = "auto") -> None:
    """``<outfile>.results`` (gaussian.cu:1042-1059): data CSV, tab,
    per-cluster membership CSV, one line per event."""
    stream_results(path, [(data, memberships)], use_native=use_native)


def stream_results(path: str, chunk_iter, use_native: str = "auto") -> int:
    """Streaming ``.results`` writer: bounded memory at any N.

    ``chunk_iter`` yields ``(data_block [B, D], memberships_block [B, K])``
    pairs in original data coordinates. ``use_native`` as in
    ``readers.read_data``: the native writer (``native.ResultsWriter``,
    printf ``%f`` of the float32 values) under 'auto' when the library
    loads and under 'always', else the Python path, which formats each
    block with one ``%`` over its flattened values (``'%f' % x`` is the same
    text as ``f'{x:f}'``). The two may differ in the last digit on ties.
    Returns the number of events written.
    """
    from .native import select

    written = 0
    native = select(use_native)
    if native is not None:
        with native.ResultsWriter(path) as w:
            for block, memb in chunk_iter:
                w.append(block, memb)
                written += block.shape[0]
        return written
    with open(path, "w") as f:
        for block, memb in chunk_iter:
            rows = block.shape[0]
            if rows == 0:
                continue
            row_fmt = (",".join(["%f"] * block.shape[1]) + "\t"
                       + ",".join(["%f"] * memb.shape[1]) + "\n")
            vals = np.concatenate(
                [np.asarray(block, np.float64), np.asarray(memb, np.float64)],
                axis=1)
            f.write((row_fmt * rows) % tuple(vals.ravel().tolist()))
            written += rows
    return written
