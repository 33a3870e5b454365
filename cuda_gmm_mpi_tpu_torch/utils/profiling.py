"""Per-phase profiler with the reference's 7-category taxonomy.

The reference instruments every phase with cudaEvent timers grouped in a
``profile_t`` struct -- categories ``e_step, m_step, constants, reduce,
memcpy, cpu, mpi`` (``gaussian.cu:76-84``) -- and prints totals plus
per-iteration averages at the end (``gaussian.cu:967``). The port's own
copy of the JAX package's ``utils/profiling.py`` keeps the same taxonomy
and the same sites in the sweep, on the host clock:

  e_step    one K's EM (the E-step, M-step and constants of every
            iteration: one CUDA-graph replay each on the card)
  m_step    (folded into e_step, as in the JAX package)
  constants (folded into e_step)
  reduce    model-order reduction: empty elimination + pair scan + merge
  memcpy    rebucketing the state and compacting the best one
  cpu       host-side work: checkpoint writes
  mpi       cross-rank collective setup (0 on one process)

Two usage modes:
  - coarse (always available): wrap phases via ``timer.phase(name)``;
  - deep-dive: a ``torch.profiler`` capture via ``trace(log_dir)``.

PhaseTimer is a thin adapter over the telemetry package: the table
renders through ``telemetry.report.render_phase_table`` (one formatter for
the live ``--profile`` print and the offline ``gmm report``), every
measured span is forwarded into the active RunRecorder's metrics registry
as a ``phase.<name>`` histogram, and ``snapshot()`` is the shape
``run_summary.phase_profile`` carries.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from ..telemetry import current as _current_recorder
from ..telemetry import render_phase_table

CATEGORIES = ("e_step", "m_step", "constants", "reduce", "memcpy", "cpu", "mpi")


class PhaseTimer:
    """Accumulating wall-clock timers, one slot per reference category."""

    def __init__(self):
        self.seconds: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.counts: Dict[str, int] = {c: 0 for c in CATEGORIES}

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self.seconds:  # allow ad-hoc categories too
            self.seconds[name] = 0.0
            self.counts[name] = 0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + count
        rec = _current_recorder()
        if rec.active:
            rec.metrics.observe(f"phase.{name}", seconds)

    def report(self) -> str:
        """Total + per-call average per category (gaussian.cu:967's layout)."""
        return render_phase_table(self.seconds, self.counts)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)

    def snapshot(self) -> Dict[str, dict]:
        """``run_summary.phase_profile`` payload: seconds + call counts."""
        return {"seconds": dict(self.seconds), "counts": dict(self.counts)}


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """A ``torch.profiler`` capture of the enclosed block, written as a
    Chrome trace (``gmm_trace.<pid>.json``, viewable in Perfetto or
    chrome://tracing) into ``log_dir``; a no-op when ``log_dir`` is None.

    Records host activity, plus the card's (kernels, copies, CUDA-graph
    replays' kernels) when ``device`` is a CUDA device, or is None and
    CUDA is available."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"gmm_trace.{os.getpid()}.json"))
