"""Persisted tuning database: measured per-shape knob profiles.

The reference hard-codes its launch geometry per GPU generation
(NUM_BLOCKS/THREADS in gaussian.h, tuned once for Tesla-era parts); the
port's analogs -- ``chunk_size``, the E-step backend, serving block
bounds -- were equally hand-set. This module is the measured half of the
fix: a small versioned JSON database of recorded candidate profiles
(wall/iter, compile seconds, modelled flops/bytes, HBM peak when the
CompileWatch saw one), keyed by the shape class a measurement transfers
across:

    (platform, device_kind, N-bucket, D, K-bucket, covariance, dtype)

N and K are pow2-bucketed (a 19k-event fit and a 23k-event fit share a
row; the executable-cache bucketing in serving/executor.py draws the
same equivalence classes). Resolution first tries the exact key, then
the NEAREST recorded key of the same (platform, device_kind,
covariance, dtype) -- distance is log2-octave distance over (N-bucket,
D, K-bucket) -- and falls back to the static cost model
(``tuning.cost``) when the database has nothing relevant.

Writes are atomic + durable via ``utils.checkpoint.write_json_atomic``
(tmp + fsync + rename + dir fsync -- the npz checkpoint contract's JSON
sibling), so a crashed ``gmm tune`` can never leave a torn database. An
unreadable/alien-version file is treated as empty with a warning, never
a crash: the tuner must degrade to static defaults, not take the fit
down with it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

DB_VERSION = 1

#: knob names a database row may carry (fit-side and serve-side).
KNOBS = (
    "chunk_size",
    "estep_backend",
    "sweep_k_buckets",
    "restart_batch_size",
    "fleet_mode",
    "serve_min_block",
    "serve_max_block",
)


def default_db_path() -> str:
    """``GMM_TUNING_DB`` > ``$XDG_CACHE_HOME/gmm/tuning.json`` >
    ``~/.cache/gmm/tuning.json``."""
    env = os.environ.get("GMM_TUNING_DB")
    if env:
        return env
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "gmm", "tuning.json")


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (the shape equivalence class)."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class TuningKey:
    """One shape class a measurement transfers across."""

    platform: str
    device_kind: str
    n_bucket: int
    d: int
    k_bucket: int
    covariance: str
    dtype: str

    @classmethod
    def for_shape(cls, platform: str, device_kind: str, n_events: int,
                  n_dims: int, num_clusters: int, covariance: str,
                  dtype: str) -> "TuningKey":
        return cls(platform=str(platform), device_kind=str(device_kind),
                   n_bucket=pow2_bucket(n_events), d=int(n_dims),
                   k_bucket=pow2_bucket(num_clusters),
                   covariance=str(covariance), dtype=str(dtype))

    def as_str(self) -> str:
        return (f"{self.platform}|{self.device_kind}|n{self.n_bucket}"
                f"|d{self.d}|k{self.k_bucket}|{self.covariance}"
                f"|{self.dtype}")

    @classmethod
    def from_str(cls, s: str) -> Optional["TuningKey"]:
        parts = s.split("|")
        if len(parts) != 7 or not parts[2].startswith("n") \
                or not parts[3].startswith("d") \
                or not parts[4].startswith("k"):
            return None
        try:
            return cls(platform=parts[0], device_kind=parts[1],
                       n_bucket=int(parts[2][1:]), d=int(parts[3][1:]),
                       k_bucket=int(parts[4][1:]), covariance=parts[5],
                       dtype=parts[6])
        except ValueError:
            return None

    def family_matches(self, other: "TuningKey") -> bool:
        """Same numeric family: measurements may transfer across shapes
        inside a family, never across platforms or dtypes."""
        return (self.platform == other.platform
                and self.device_kind == other.device_kind
                and self.covariance == other.covariance
                and self.dtype == other.dtype)

    def distance(self, other: "TuningKey") -> float:
        """log2-octave distance over (N-bucket, D, K-bucket)."""
        return (abs(math.log2(self.n_bucket) - math.log2(other.n_bucket))
                + abs(math.log2(max(self.d, 1))
                      - math.log2(max(other.d, 1)))
                + abs(math.log2(self.k_bucket)
                      - math.log2(other.k_bucket)))


class TuningDB:
    """In-memory view of one tuning.json, with atomic persistence.

    Layout (``version`` gates readers; rows are keyed by
    ``TuningKey.as_str()``, then knob name, then the candidate's string
    repr)::

        {"version": 1,
         "entries": {
           "cpu|cpu|n32768|d16|k8|full|float32": {
             "chunk_size": {
               "chosen": "8192",
               "source": "probe",
               "candidates": {
                 "8192": {"wall_per_iter_s": 0.011, "compile_s": 0.41,
                          "flops": 2.1e7, "bytes": 1.2e7, ...},
                 ...}}}}}
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_db_path()
        self.entries: Dict[str, Dict[str, Any]] = {}
        self.load_error: Optional[str] = None

    # -- persistence ----------------------------------------------------

    @classmethod
    def open(cls, path: Optional[str] = None) -> "TuningDB":
        db = cls(path)
        db.load()
        return db

    def load(self) -> None:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as e:
            self.load_error = f"unreadable tuning db {self.path}: {e}"
            return
        if not isinstance(raw, dict) or raw.get("version") != DB_VERSION:
            self.load_error = (
                f"tuning db {self.path} has version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'}, "
                f"expected {DB_VERSION}; ignoring it")
            return
        entries = raw.get("entries")
        if isinstance(entries, dict):
            self.entries = entries

    def save(self) -> None:
        from ..utils.checkpoint import write_json_atomic

        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".",
                    exist_ok=True)
        write_json_atomic(self.path,
                          {"version": DB_VERSION, "entries": self.entries})

    # -- recording ------------------------------------------------------

    def record(self, key: TuningKey, knob: str, choice: Any,
               profile: Dict[str, Any], source: str = "probe") -> None:
        """Add/refresh one measured candidate; ``chosen`` is recomputed
        as the wall/iter argmin over everything recorded so far (ties
        break toward the SMALLER candidate repr so reruns are stable)."""
        if knob not in KNOBS:
            raise ValueError(f"unknown tuning knob {knob!r}")
        row = self.entries.setdefault(key.as_str(), {})
        slot = row.setdefault(knob, {"candidates": {}})
        slot["candidates"][str(choice)] = dict(profile)
        slot["source"] = source

        def rank(item: Tuple[str, Dict[str, Any]]):
            name, prof = item
            wall = prof.get("wall_per_iter_s")
            wall = float("inf") if wall is None else float(wall)
            return (wall, name)

        slot["chosen"] = min(slot["candidates"].items(), key=rank)[0]

    # -- resolution -----------------------------------------------------

    def lookup(self, key: TuningKey, knob: str
               ) -> Optional[Dict[str, Any]]:
        """Exact-key row for one knob:
        ``{chosen, candidates, source, key, distance}`` or None."""
        slot = (self.entries.get(key.as_str()) or {}).get(knob)
        if not isinstance(slot, dict) or "chosen" not in slot:
            return None
        return dict(slot, key=key.as_str(), distance=0.0)

    def nearest(self, key: TuningKey, knob: str
                ) -> Optional[Dict[str, Any]]:
        """Exact match, else the nearest same-family recorded row
        (log2-octave distance over N-bucket/D/K-bucket; deterministic
        key-string tie-break)."""
        exact = self.lookup(key, knob)
        if exact is not None:
            return exact
        best: Optional[Tuple[float, str, Dict[str, Any]]] = None
        for key_str, row in self.entries.items():
            other = TuningKey.from_str(key_str)
            if other is None or not key.family_matches(other):
                continue
            slot = row.get(knob)
            if not isinstance(slot, dict) or "chosen" not in slot:
                continue
            d = key.distance(other)
            if best is None or (d, key_str) < (best[0], best[1]):
                best = (d, key_str, slot)
        if best is None:
            return None
        return dict(best[2], key=best[1], distance=best[0])

    def chosen_profile(self, slot: Dict[str, Any]
                       ) -> Optional[Dict[str, Any]]:
        """The chosen candidate's recorded profile for a lookup() row."""
        cands = slot.get("candidates") or {}
        prof = cands.get(str(slot.get("chosen")))
        return prof if isinstance(prof, dict) else None
