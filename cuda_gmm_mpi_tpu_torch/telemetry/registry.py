"""Run-scoped metrics registry: counters, gauges, histograms, series.

The numeric complement of the event stream (recorder.py): events answer
"what happened when", the registry answers "how much in total". One
instance lives on each :class:`RunRecorder`; its ``snapshot()`` is folded
into the ``run_summary`` record. Thread-safe. The port's own copy of the
JAX package's ``telemetry/registry.py``.

Instrument kinds:
  counter    monotonically accumulating totals (em_iters, h2d_bytes, ...)
  gauge      last-written value (active_k, first EM call seconds, ...)
  histogram  count/sum/min/max aggregate of observed values (phase spans)
  series     bounded append-only trajectory (active-K across the sweep)
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List

_SERIES_CAP = 4096  # bound memory for arbitrarily long sweeps

# Fixed histogram bucket bounds (rev v2.2): one log ladder shared by
# every histogram, wide enough to cover sub-millisecond phase spans and
# multi-second serve latencies in ms alike. The exporter renders these
# as cumulative OpenMetrics ``_bucket{le=...}`` lines so p50/p99 are
# scrapeable; the rollup snapshot() keeps its count/sum/min/max shape
# (run_summary.metrics stays byte-stable).
BUCKET_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class MetricsRegistry:
    """Counters/gauges/histograms/series keyed by flat string names."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, float]] = {}
        # name -> per-bucket (non-cumulative) counts, one slot per
        # BUCKET_BOUNDS entry plus the +Inf overflow slot.
        self._buckets: Dict[str, List[int]] = {}
        self._series: Dict[str, List[float]] = {}

    def count(self, name: str, value: float = 1) -> None:
        """Add ``value`` to the counter ``name`` (created at 0)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to ``value`` (last write wins)."""
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Fold ``value`` into histogram ``name`` (count/sum/min/max,
        plus the fixed BUCKET_BOUNDS bucket counts)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = {"count": 1, "sum": value,
                                     "min": value, "max": value}
            else:
                h["count"] += 1
                h["sum"] += value
                h["min"] = min(h["min"], value)
                h["max"] = max(h["max"], value)
            buckets = self._buckets.get(name)
            if buckets is None:
                buckets = self._buckets[name] = \
                    [0] * (len(BUCKET_BOUNDS) + 1)
            buckets[bisect.bisect_left(BUCKET_BOUNDS, value)] += 1

    def series(self, name: str, value: float) -> None:
        """Append ``value`` to the bounded trajectory ``name``."""
        with self._lock:
            s = self._series.setdefault(name, [])
            if len(s) < _SERIES_CAP:
                s.append(value)

    def _snapshot_locked(self) -> dict:
        out = {}
        if self._counters:
            out["counters"] = dict(self._counters)
        if self._gauges:
            out["gauges"] = dict(self._gauges)
        if self._hists:
            out["histograms"] = {k: dict(v)
                                 for k, v in self._hists.items()}
        if self._series:
            out["series"] = {k: list(v)
                             for k, v in self._series.items()}
        return out

    def snapshot(self) -> dict:
        """JSON-ready copy of every instrument (empty kinds omitted)."""
        with self._lock:
            return self._snapshot_locked()

    def snapshot_buckets(self) -> Dict[str, List[int]]:
        """Per-histogram fixed-bucket counts (non-cumulative; one slot
        per BUCKET_BOUNDS bound plus the trailing +Inf slot). Kept out
        of :meth:`snapshot` so the run_summary.metrics payload -- and
        every fixture asserting its exact shape -- stays byte-stable;
        the OpenMetrics exporter is the consumer."""
        with self._lock:
            return {k: list(v) for k, v in self._buckets.items()}

    def snapshot_with_buckets(self) -> tuple:
        """``(snapshot(), snapshot_buckets())`` under ONE lock hold.

        The scrape path needs the pair to agree: taken separately, an
        ``observe()`` landing between the two calls yields a histogram
        whose ``_count`` disagrees with its cumulative ``+Inf`` bucket
        on the same exposition."""
        with self._lock:
            return (self._snapshot_locked(),
                    {k: list(v) for k, v in self._buckets.items()})
