"""Checkpoint/resume of the model-order sweep.

The port's own copy of the JAX package's ``utils/checkpoint.py``. Each
completed K saves the sweep position, so a killed run resumes at the next K
instead of restarting the search; a preempted run also saves its mid-EM
state as an intra-K sub-step and resumes inside the interrupted fit.

Layout (the JAX package's): ``<dir>/sweep/<step>.npz`` full steps and
``<dir>/sweep/<step>.iter<i>.npz`` sub-steps, where step counts completed
EM runs. Every file is a flat ``np.savez`` of :func:`flatten_tree`'s keys
(``state.N``, ``best_state.R``, ..., the sweep scalars and the world stamp
``ckpt_world_size``/``ckpt_generation``), written atomically (tmp + fsync
+ ``os.replace`` + directory fsync). A checkpoint either package writes in
this format loads in the other. The JAX package's host-driven sweep writes
its full steps as orbax directories (``<dir>/sweep/<step>/``), which need
orbax to read: the port skips them in the walk-back (a live sub-step, which
is npz, resumes regardless), and with nothing else readable raises
:class:`CheckpointRestoreError`.

State leaves are stored as host numpy arrays: the sweep moves the state to
the CPU (after the device work that made it has finished) before saving,
and moves a restored state back to the model's device.
"""

from __future__ import annotations

import os
import random
import re
import shutil
import tempfile
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..state import GMMState
from ..testing import faults


class CheckpointRestoreError(OSError):
    """Every checkpoint step in the directory was unreadable.

    Aggregates the per-step failures (``.errors``: newest step first); the
    newest failure is also chained as ``__cause__``. The CLI maps this to
    exit 74 (EX_IOERR).
    """

    def __init__(self, message: str,
                 errors: List[Tuple[int, BaseException]]):
        self.errors = errors
        lines = [message]
        for step, err in errors:
            lines.append(f"  step {step}: {type(err).__name__}: {err}")
        super().__init__("\n".join(lines))


_SUBSTEP_RE = re.compile(r"^(\d+)\.iter(\d+)\.npz$")

# First-retry backoff; doubles per attempt with +-25% deterministic jitter
# (seeded per (step, attempt)).
RETRY_BASE_S = 0.05

_STATE_FIELDS = ("N", "pi", "constant", "avgvar", "means", "R", "Rinv",
                 "active")


def _to_tree(state: GMMState) -> Dict[str, Any]:
    return {f: np.asarray(getattr(state, f).cpu()) for f in _STATE_FIELDS}


def _from_tree(t: Dict[str, Any]) -> GMMState:
    return GMMState(**{k: torch.as_tensor(np.asarray(t[k]))
                       for k in _STATE_FIELDS})


def flatten_tree(payload: Dict[str, Any]) -> Dict[str, Any]:
    """One-level flatten of a checkpoint payload into npz-ready keys:
    ``GMMState`` values expand to their leaf arrays and every nested dict
    to ``group.leaf`` keys; scalars/arrays pass through as ``np.asarray``
    (the JAX package's flattening rule)."""
    flat: Dict[str, Any] = {}
    for key, val in payload.items():
        if isinstance(val, GMMState):
            val = _to_tree(val)
        if isinstance(val, dict):
            for leaf, arr in val.items():
                flat[f"{key}.{leaf}"] = np.asarray(arr)
        else:
            flat[key] = np.asarray(val)
    return flat


def _fsync_dir(directory: str) -> None:
    """POSIX-only durability fsync of a directory entry after a rename."""
    if os.name != "posix":
        return
    dir_fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def write_npz_atomic(directory: str, target: str,
                     flat: Dict[str, Any]) -> None:
    """Durable atomic npz write: tmp + fsync + ``os.replace`` + dir fsync,
    so the file survives a host crash and a reader never sees a torn one.
    The tmp name is mkstemp-unique."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    _fsync_dir(directory)


def write_json_atomic(path: str, obj: Any) -> None:
    """``write_npz_atomic``'s sibling for JSON artifacts: the same crash
    contract, keys sorted so equal content gives equal bytes."""
    import json

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.json")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(directory)


def load_npz_tree(path: str,
                  state_keys: Tuple[str, ...] = ("state", "best_state"),
                  ) -> Dict[str, Any]:
    """Un-flatten one npz artifact written via :func:`flatten_tree`:
    ``group.leaf`` keys regroup into dicts, and the groups named in
    ``state_keys`` (when present) become :class:`GMMState` on the CPU."""
    with np.load(path) as z:
        tree: Dict[str, Any] = {}
        for key in z.files:
            if "." in key:
                group, leaf = key.split(".", 1)
                tree.setdefault(group, {})[leaf] = z[key]
            else:
                tree[key] = z[key]
    for key in state_keys:
        if key in tree:
            tree[key] = _from_tree(tree[key])
    return tree


def _load_npz_tree(path: str) -> Dict[str, Any]:
    """One sweep checkpoint: both GMMState groups are required."""
    tree = load_npz_tree(path)
    for key in ("state", "best_state"):
        if not isinstance(tree.get(key), GMMState):
            raise ValueError(f"checkpoint {path!r} is missing the "
                             f"{key!r} group")
    return tree


def world_size() -> int:
    """The torch.distributed world size (1 without a process group)."""
    import torch.distributed as dist

    return (int(dist.get_world_size())
            if dist.is_available() and dist.is_initialized() else 1)


class SweepCheckpointer:
    """Persistence of the order-search sweep.

    ``keep`` bounds the retained steps (default 2: the newest plus one
    fallback in case the newest is torn -- restore() walks back);
    ``retries`` bounds the retries of a failed write.
    """

    def __init__(self, directory: str, keep: int = 2, retries: int = 3):
        self._dir = os.path.abspath(os.path.join(directory, "sweep"))
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max(1, keep)
        self._retries = max(0, retries)
        # Transient-failure retries observed so far (run_summary.health).
        self.io_retries = 0

    @staticmethod
    def _world_meta() -> Dict[str, Any]:
        """The world-size/generation stamp every save carries (the JAX
        package's, so either package diagnoses a world mismatch)."""
        return {"ckpt_world_size": np.asarray(world_size(), np.int64),
                "ckpt_generation": np.asarray(0, np.int64)}

    def _validate_meta(self, tree: Dict[str, Any], step: int) -> None:
        """Raise when a stamped checkpoint was written at another world
        size (unstamped ones skip the check)."""
        if "ckpt_world_size" not in tree:
            return
        saved = int(np.asarray(tree["ckpt_world_size"]))
        here = world_size()
        if saved != here:
            raise ValueError(
                f"checkpoint step {step} was written at world size {saved} "
                f"but this run has {here} process(es); resume at the "
                "original world size")

    def _write_with_retries(self, op: str, step: int,
                            write: Callable[[], None]) -> bool:
        """Run ``write`` with bounded, jittered exponential backoff. Each
        failure emits an ``io_retry`` record; exhaustion logs loudly and
        SKIPS the save (a missing checkpoint degrades resume granularity;
        a crashed run loses everything). Returns True when durable."""
        from .. import telemetry

        delay = RETRY_BASE_S
        for attempt in range(self._retries + 1):
            try:
                # Deterministic injection point (testing.faults:
                # checkpoint_eio), budget-bounded like a transient EIO.
                faults.raise_io_error("checkpoint_eio", step=step)
                write()
                return True
            except OSError as e:
                gave_up = attempt == self._retries
                rec = telemetry.current()
                if rec.active:
                    rec.emit("io_retry", op=op, step=int(step),
                             attempt=attempt + 1, error=str(e),
                             delay_s=(0.0 if gave_up else round(delay, 4)),
                             gave_up=gave_up)
                    rec.metrics.count("io_retries")
                if gave_up:
                    from .logging_ import get_logger

                    get_logger().error(
                        "checkpoint %s for step %d failed after %d "
                        "attempt(s): %s -- continuing WITHOUT this "
                        "checkpoint", op, step, attempt + 1, e)
                    return False
                self.io_retries += 1
                jitter = 0.75 + 0.5 * random.Random(
                    (int(step) << 8) | attempt).random()
                time.sleep(delay * jitter)
                delay *= 2.0

    def _prune(self, newest_step: int) -> None:
        """Drop steps older than the retention window, sub-steps at or below
        the newest completed step and orphaned tmp files. Best-effort."""
        cutoff = newest_step - self._keep + 1
        try:
            for s in self._all_steps():
                if s >= cutoff:
                    continue
                try:
                    npz = os.path.join(self._dir, f"{s}.npz")
                    if os.path.exists(npz):
                        os.remove(npz)
                    d = os.path.join(self._dir, str(s))
                    if os.path.isdir(d):
                        shutil.rmtree(d)
                except OSError:
                    pass
            self.discard_substeps(newest_step)
            for f in os.listdir(self._dir):
                if f.endswith(".tmp.npz"):
                    try:
                        os.remove(os.path.join(self._dir, f))
                    except OSError:
                        pass
        except OSError:
            pass

    def save(self, step: int, payload: Dict[str, Any]) -> None:
        """Save step ``step``: ``payload`` holds ``state``/``best_state``
        (GMMState on the CPU) and plain scalars/arrays. Write failures
        retry with jittered backoff (``retries``)."""
        flat = flatten_tree(dict(payload, **self._world_meta()))
        target = os.path.join(self._dir, f"{step}.npz")
        if self._write_with_retries(
                "save", step, lambda: write_npz_atomic(self._dir, target,
                                                       flat)):
            self._prune(step)

    def save_substep(self, step: int, em_iter: int,
                     payload: Dict[str, Any]) -> bool:
        """Emergency intra-K checkpoint ``<step>.iter<em_iter>.npz``: the
        mid-EM state of the K being fitted at sweep step ``step`` with its
        iteration count and loglik trajectory (``em_iter``/``em_lls``). It
        outranks every full step below it at restore time and is pruned
        when its K completes. Returns True when durable."""
        flat = flatten_tree(dict(payload, em_iter=np.int64(em_iter),
                                 **self._world_meta()))
        target = os.path.join(self._dir, f"{step}.iter{em_iter}.npz")
        ok = self._write_with_retries(
            "save_substep", step,
            lambda: write_npz_atomic(self._dir, target, flat))
        if ok:
            for s, i in self._substeps():
                if s == step and i < em_iter:
                    try:
                        os.remove(os.path.join(self._dir,
                                               f"{s}.iter{i}.npz"))
                    except OSError:
                        pass
        return ok

    def discard_substeps(self, step: int) -> None:
        """Drop intra-K sub-steps at or below ``step`` (that K completed).
        Best-effort."""
        for s, i in self._substeps():
            if s <= step:
                try:
                    os.remove(os.path.join(self._dir, f"{s}.iter{i}.npz"))
                except OSError:
                    pass

    def _all_steps(self) -> list:
        if not os.path.isdir(self._dir):
            return []
        names = os.listdir(self._dir)
        steps = [int(d) for d in names if d.isdigit()]
        steps += [int(f[:-4]) for f in names
                  if f.endswith(".npz") and f[:-4].isdigit()]
        return steps

    def _substeps(self) -> List[Tuple[int, int]]:
        """(step, em_iter) of every intra-K sub-step file on disk."""
        if not os.path.isdir(self._dir):
            return []
        out = []
        for f in os.listdir(self._dir):
            m = _SUBSTEP_RE.match(f)
            if m:
                out.append((int(m.group(1)), int(m.group(2))))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._all_steps()
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Load the requested (default: newest) step. Without an explicit
        ``step`` an unreadable newest checkpoint (torn, mismatched, or an
        orbax directory) falls back to the next older one; when EVERY step
        is unreadable the failures are aggregated into one
        :class:`CheckpointRestoreError` (newest first)."""
        if step is not None:
            return self._restore_step(step)
        failures: List[Tuple[int, BaseException]] = []
        for s in sorted(set(self._all_steps()), reverse=True):
            try:
                return self._restore_step(s)
            except Exception as e:
                failures.append((s, e))
                warnings.warn(
                    f"checkpoint step {s} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous step", RuntimeWarning)
        if failures:
            raise CheckpointRestoreError(
                f"all {len(failures)} checkpoint step(s) under "
                f"{self._dir} are unreadable", failures) from failures[0][1]
        return None

    def restore_substep(self) -> Optional[Dict[str, Any]]:
        """The newest LIVE intra-K sub-step's payload (with ``step`` and
        ``em_iter`` set), or None. A sub-step at or below the newest full
        step is stale; an unreadable one warns and falls back to older
        live sub-steps, then to None (that K restarts from its beginning)."""
        latest_full = self.latest_step()
        for s, i in sorted(self._substeps(), reverse=True):
            if latest_full is not None and s <= latest_full:
                break
            path = os.path.join(self._dir, f"{s}.iter{i}.npz")
            try:
                tree = _load_npz_tree(path)
                self._validate_meta(tree, s)
            except Exception as e:
                warnings.warn(
                    f"intra-K sub-step {s}.iter{i} unreadable "
                    f"({type(e).__name__}: {e}); resuming that K from its "
                    "beginning instead", RuntimeWarning)
                continue
            tree["step"] = s
            tree["em_iter"] = i
            return tree
        return None

    def _restore_step(self, step: int) -> Dict[str, Any]:
        npz = os.path.join(self._dir, f"{step}.npz")
        if os.path.exists(npz):
            tree = _load_npz_tree(npz)
        elif os.path.isdir(os.path.join(self._dir, str(step))):
            raise ValueError(
                f"step {step} is an orbax directory (the JAX package's "
                "collective writer); this package reads the npz steps only")
        else:
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self._dir}")
        self._validate_meta(tree, step)
        tree["step"] = step
        return tree
