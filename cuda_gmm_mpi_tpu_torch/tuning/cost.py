"""Static cost model: the tuner's fallback when nothing was measured.

docs/PERF.md "Cost model" fixes the conventions this module encodes:
one full-data EM iteration is ``2*N*K*(F+D)`` MACs = ``4*N*K*(F+D)``
FLOPs (F = D^2 expanded full-covariance features, D for diag families —
the same 1 MAC = 2 FLOPs rule XLA's ``cost_analysis()`` prices dots
with, so static predictions and measured ``run_summary.profile.cost``
numbers are directly comparable once trip counts are applied), and one
pass moves at least ``N*(F+K)`` feature/posterior elements.

The effective-throughput constants below are the JAX package's, kept
as they are and deliberately coarse — they exist to RANK candidates when
the tuning DB has no measurement, not to predict absolute walls; no
number here was measured on the port's device. A measured DB row always
outranks them (the ``db > probe > static`` fallback ladder in
``tuning.autotune``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Effective sustained FLOP/s by platform (not peak: includes the
# exp/logsumexp transcendental tax of the E-step).
EFFECTIVE_FLOPS = {
    "cpu": 4.0e9,
    "gpu": 2.0e11,
    "tpu": 1.0e12,
}

# Fixed per-dispatch overhead of one chunk step inside the scanned EM
# body (host loop + launch latency), seconds.
DISPATCH_OVERHEAD_S = {
    "cpu": 2.0e-4,
    "gpu": 1.0e-4,
    "tpu": 5.0e-5,
}

# Working sets larger than this stop fitting in cache/VMEM and the
# effective rate degrades (CPU L2/L3-ish; accelerators stream from HBM
# so the penalty is mild).
CACHE_BYTES = {
    "cpu": 32 << 20,
    "gpu": 48 << 20,
    "tpu": 128 << 20,
}
CACHE_PENALTY = {"cpu": 0.6, "gpu": 0.9, "tpu": 0.9}

# Platform chunk defaults when NOTHING is known: 4096 on the CPU;
# accelerators keep the reference-era 65536.
STATIC_CHUNK = {"cpu": 4096, "gpu": 65536, "tpu": 65536}


def feature_width(n_dims: int, covariance: str) -> int:
    """F: expanded quadratic-feature width per event."""
    d = int(n_dims)
    return d if covariance in ("diag", "spherical") else d * d


def em_iteration_cost(n_events: int, n_dims: int, num_clusters: int,
                      covariance: str, dtype: str) -> Dict[str, float]:
    """Modelled flops/bytes of ONE full-data EM iteration (docs/PERF.md
    conventions; what a DB row carries when no CompileWatch measured
    numbers exist)."""
    f = feature_width(n_dims, covariance)
    n, k, d = int(n_events), int(num_clusters), int(n_dims)
    itemsize = np.dtype(dtype).itemsize
    return {
        "flops": float(4 * n * k * (f + d)),
        "bytes": float(n * (f + k) * itemsize),
    }


def predict_iteration_wall(n_events: int, n_dims: int, num_clusters: int,
                           covariance: str, dtype: str, platform: str,
                           chunk_size: int) -> float:
    """Predicted wall seconds of one full-data EM iteration at a given
    chunk size: compute term + per-chunk dispatch overhead + a cache
    penalty once the per-chunk working set spills."""
    platform = platform if platform in EFFECTIVE_FLOPS else "cpu"
    cost = em_iteration_cost(n_events, n_dims, num_clusters,
                             covariance, dtype)
    chunk = max(1, min(int(chunk_size), int(n_events)))
    n_chunks = -(-int(n_events) // chunk)
    f = feature_width(n_dims, covariance)
    itemsize = np.dtype(dtype).itemsize
    working = chunk * (f + int(num_clusters)) * itemsize
    rate = EFFECTIVE_FLOPS[platform]
    if working > CACHE_BYTES[platform]:
        rate *= CACHE_PENALTY[platform]
    return (cost["flops"] / rate
            + n_chunks * DISPATCH_OVERHEAD_S[platform])


def static_chunk_size(n_events: int, n_dims: int, num_clusters: int,
                      covariance: str, dtype: str,
                      platform: str) -> int:
    """Model-ranked chunk choice over the standard pow2 ladder."""
    best: Optional[int] = None
    best_wall = float("inf")
    for c in chunk_ladder(n_events, platform):
        wall = predict_iteration_wall(n_events, n_dims, num_clusters,
                                      covariance, dtype, platform, c)
        if wall < best_wall:
            best, best_wall = c, wall
    return best if best is not None else STATIC_CHUNK.get(platform, 65536)


def chunk_ladder(n_events: int, platform: str,
                 around: Optional[int] = None) -> list:
    """Deterministic ascending pow2 candidate ladder, clamped to the
    data: the full [1024 .. 131072] octave range (``gmm tune``), or a
    +/- 2-octave window around ``around`` (the bounded in-fit probe)."""
    from .db import pow2_bucket

    hi_cap = pow2_bucket(max(1, int(n_events)))
    lo, hi = 1024, 131072
    if around is not None:
        base = pow2_bucket(int(around))
        lo, hi = max(lo, base // 4), min(hi, base * 4)
    ladder = []
    c = lo
    while c <= min(hi, max(hi_cap, lo)):
        ladder.append(c)
        c *= 2
    return ladder
