"""Mergeable streaming summaries + drift statistics (stream rev v2.4).

The drift-observability substrate (docs/OBSERVABILITY.md "Drift
detection"): a :class:`StreamSketch` is a small, serializable summary of
a value stream -- a fixed-log-bucket histogram (the same bisect-ladder
scheme as ``registry.BUCKET_BOUNDS``, extended symmetrically so signed
per-event log-likelihoods land in resolved buckets), exact count /
min / max, and Welford mean/M2 moments -- built so that sketches MERGE:
``merge(a, b)`` over any split of a stream reproduces the one-shot
sketch (bucket counts, count, min, max exactly; mean/M2 via Chan's
parallel formulas, associative up to float rounding). Per-rank,
per-window, and per-tenant sketches therefore compose into one, which
is what lets a training envelope be assembled across hosts and a serve
stream be re-aggregated offline by ``gmm drift``.

Everything here is numpy + stdlib on purpose: sketches are built on the
serve hot path and parsed by offline CLI tools, neither of which should
pull in jax.

The port's own copy of the JAX package's ``telemetry/sketch.py``: an
envelope the port computes merges and compares with the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .registry import BUCKET_BOUNDS

# Symmetric ladder over the BUCKET_BOUNDS decades: per-event
# log-likelihood scores are signed (densities above/below 1), so the
# positive latency ladder alone would dump every negative score into one
# underflow slot. 45 finite bounds + the trailing +Inf slot.
SCORE_BOUNDS: tuple = (tuple(-b for b in reversed(BUCKET_BOUNDS))
                       + (0.0,) + tuple(BUCKET_BOUNDS))

ENVELOPE_VERSION = 1

# Proportion floor for PSI: empty buckets would make ln(q/p) blow up, so
# both distributions are clamped elementwise to this before the sum --
# the standard PSI stabilizer, and part of the pinned-fixture contract.
PSI_EPS = 1e-6


class StreamSketch:
    """Mergeable streaming summary: log-bucket histogram + moments.

    Buckets follow ``MetricsRegistry.observe``'s ladder semantics:
    bucket ``i`` counts values ``<= bounds[i]`` (``searchsorted`` left),
    with one trailing overflow slot. Non-finite inputs are dropped (they
    are accounted separately by the health machinery, not the sketch).
    """

    __slots__ = ("bounds", "count", "mean", "m2", "vmin", "vmax",
                 "buckets")

    def __init__(self, bounds: Sequence[float] = SCORE_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: List[int] = [0] * (len(self.bounds) + 1)

    def update(self, values) -> "StreamSketch":
        """Fold a batch of values in (vectorized; returns self)."""
        x = np.asarray(values, dtype=np.float64).reshape(-1)
        x = x[np.isfinite(x)]
        n = int(x.size)
        if n == 0:
            return self
        idx = np.searchsorted(self.bounds, x, side="left")
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self.buckets[int(i)] += int(c)
        # Chan's parallel-update formulas with the batch as one summary:
        # exactly the pairwise merge below, so update-then-merge and
        # merge-then-update agree.
        b_mean = float(x.mean())
        b_m2 = float(np.sum((x - b_mean) ** 2))
        total = self.count + n
        delta = b_mean - self.mean
        self.m2 += b_m2 + delta * delta * self.count * n / total
        self.mean += delta * n / total
        self.count = total
        self.vmin = min(self.vmin, float(x.min()))
        self.vmax = max(self.vmax, float(x.max()))
        return self

    def merge(self, other: "StreamSketch") -> "StreamSketch":
        """Fold another sketch in (same bounds required; returns self)."""
        if tuple(other.bounds) != self.bounds:
            raise ValueError(
                f"cannot merge sketches with different bucket ladders "
                f"({len(other.bounds)} vs {len(self.bounds)} bounds)")
        if other.count == 0:
            return self
        total = self.count + other.count
        delta = other.mean - self.mean
        self.m2 += other.m2 + delta * delta * self.count * other.count / total
        self.mean += delta * other.count / total
        self.count = total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        return self

    @property
    def variance(self) -> float:
        return self.m2 / self.count if self.count > 1 else 0.0

    def proportions(self) -> np.ndarray:
        """Normalized bucket mass [len(bounds)+1] (zeros when empty)."""
        counts = np.asarray(self.buckets, dtype=np.float64)
        total = counts.sum()
        return counts / total if total > 0 else counts

    def to_dict(self) -> dict:
        """JSON-ready form; carries its own ladder so a reader aligns
        observed sketches to an envelope's buckets without guessing."""
        return {
            "bounds": list(self.bounds),
            "count": int(self.count),
            "mean": float(self.mean),
            "m2": float(self.m2),
            "min": (float(self.vmin) if self.count else None),
            "max": (float(self.vmax) if self.count else None),
            "buckets": list(self.buckets),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StreamSketch":
        sk = cls(bounds=d["bounds"])
        sk.count = int(d["count"])
        sk.mean = float(d["mean"])
        sk.m2 = float(d["m2"])
        sk.vmin = float(d["min"]) if d.get("min") is not None else math.inf
        sk.vmax = float(d["max"]) if d.get("max") is not None else -math.inf
        buckets = [int(c) for c in d["buckets"]]
        if len(buckets) != len(sk.buckets):
            raise ValueError(
                f"sketch has {len(buckets)} buckets for "
                f"{len(sk.bounds)} bounds")
        sk.buckets = buckets
        return sk


def _clamped_props(counts) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    p = counts / total if total > 0 else counts
    return np.maximum(p, PSI_EPS)


def psi(expected_buckets, observed_buckets) -> float:
    """Population stability index between two bucket-count vectors.

    ``sum((q - p) * ln(q / p))`` over proportions clamped to
    ``PSI_EPS``; >= 0, with 0 iff the clamped distributions agree.
    Conventional reading: < 0.1 stable, 0.1-0.25 moderate shift,
    > 0.25 major shift.
    """
    p = _clamped_props(expected_buckets)
    q = _clamped_props(observed_buckets)
    if len(p) != len(q):
        raise ValueError(f"bucket count mismatch: {len(p)} vs {len(q)}")
    return float(np.sum((q - p) * np.log(q / p)))


def ks(expected_buckets, observed_buckets) -> float:
    """Kolmogorov-Smirnov statistic over the shared bucket ladder:
    max |CDF_p - CDF_q| of the normalized bucket masses, in [0, 1]."""
    p = np.asarray(expected_buckets, dtype=np.float64)
    q = np.asarray(observed_buckets, dtype=np.float64)
    if len(p) != len(q):
        raise ValueError(f"bucket count mismatch: {len(p)} vs {len(q)}")
    p = p / p.sum() if p.sum() > 0 else p
    q = q / q.sum() if q.sum() > 0 else q
    return float(np.max(np.abs(np.cumsum(p) - np.cumsum(q))))


def occupancy_l1(expected_counts, observed_counts) -> float:
    """L1 distance between normalized per-cluster occupancy vectors,
    in [0, 2]. A K mismatch zero-pads the shorter side (a served
    model's K never changes within a version, but offline comparisons
    may cross rebuilt envelopes)."""
    p = np.asarray(expected_counts, dtype=np.float64).reshape(-1)
    q = np.asarray(observed_counts, dtype=np.float64).reshape(-1)
    width = max(len(p), len(q), 1)
    p = np.pad(p, (0, width - len(p)))
    q = np.pad(q, (0, width - len(q)))
    p = p / p.sum() if p.sum() > 0 else p
    q = q / q.sum() if q.sum() > 0 else q
    return float(np.sum(np.abs(p - q)))


def make_envelope(score_sketch: StreamSketch, occupancy,
                  *, k: int, num_events: int) -> dict:
    """The training envelope: the fit-time score sketch + per-cluster
    responsibility occupancy counts, as persisted in ``envelope.json``
    and ``run_summary.envelope``."""
    return {
        "version": ENVELOPE_VERSION,
        "score": score_sketch.to_dict(),
        "occupancy": [int(c) for c in np.asarray(occupancy).reshape(-1)],
        "k": int(k),
        "num_events": int(num_events),
    }


def merge_envelopes(envelopes: Sequence[dict]) -> Optional[dict]:
    """Fold per-rank/per-shard envelopes into one (None if none valid).
    Occupancy vectors must agree on K (same compacted model)."""
    parts = [e for e in envelopes if e and e.get("score")]
    if not parts:
        return None
    sk = StreamSketch.from_dict(parts[0]["score"])
    occ = np.asarray(parts[0]["occupancy"], dtype=np.int64)
    for e in parts[1:]:
        sk.merge(StreamSketch.from_dict(e["score"]))
        occ = occ + np.asarray(e["occupancy"], dtype=np.int64)
    return make_envelope(
        sk, occ, k=int(parts[0]["k"]),
        num_events=sum(int(e["num_events"]) for e in parts))


def envelope_stanza(envelope: dict) -> dict:
    """The small manifest ``envelope`` stanza (registry manifest.json):
    enough to see an envelope exists and its shape without reading
    ``envelope.json``."""
    score = envelope.get("score", {}) or {}
    return {
        "version": int(envelope.get("version", ENVELOPE_VERSION)),
        "rows": int(score.get("count", 0)),
        "k": int(envelope.get("k", 0)),
        "buckets": len(score.get("buckets", [])),
        "mean_score": score.get("mean"),
    }


def compare_to_envelope(envelope: dict, score_sketch: StreamSketch,
                        occupancy) -> Dict[str, float]:
    """The drift statistics of one observed window vs a training
    envelope -- the payload of a ``drift`` event and of the ``gmm
    drift`` verdict. The observed sketch is aligned to the envelope's
    ladder by construction (serve builds windows from the envelope's
    bounds); a ladder mismatch raises."""
    ref = StreamSketch.from_dict(envelope["score"])
    if tuple(score_sketch.bounds) != tuple(ref.bounds):
        raise ValueError("observed sketch ladder != envelope ladder")
    return {
        "psi": round(psi(ref.buckets, score_sketch.buckets), 6),
        "ks": round(ks(ref.buckets, score_sketch.buckets), 6),
        "occupancy_l1": round(occupancy_l1(
            envelope.get("occupancy", []), occupancy), 6),
        "window_rows": int(score_sketch.count),
    }
