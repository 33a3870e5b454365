"""Preemption-safe execution: the run-scoped shutdown supervisor.

The port's own copy of the single-process part of the JAX package's
``supervisor.py``. A batch scheduler's SIGTERM (or a wall-clock limit)
would otherwise kill a run with every byte of sweep state in host memory;
the supervisor turns it into a clean, resumable exit:

- :class:`RunSupervisor` installs SIGTERM/SIGINT handlers and an optional
  deadline (``GMMConfig.max_runtime_s`` / ``--max-runtime``) and exposes a
  cooperative stop flag. Signal handlers only SET the flag; the work
  happens at the next poll point on the main thread.
- The sweep polls between Ks and the EM loops between iterations
  (``GMMModel.run_em_resumable``). On stop they write an emergency
  checkpoint -- the intra-K sub-step of
  :class:`~cuda_gmm_mpi_tpu_torch.utils.checkpoint.SweepCheckpointer` with
  the mid-EM state and its loglik trajectory -- then raise
  :class:`PreemptedError`, which the CLI maps to exit 75 (``EX_TEMPFAIL``).
  ``--resume auto`` restores the sub-step and restarts inside the fit.

Activation mirrors telemetry's ambient pattern: ``with
supervisor.use(RunSupervisor(...)):`` and the instrumented layers find it
via :func:`current`; the default ambient supervisor is inert. Telemetry
records ``preempt`` and ``shutdown`` document the lifecycle. The JAX
package's multi-host liveness watchdog, ``PeerLostError`` and elastic
recovery are not ported (ROADMAP item 9): a mesh of more than one rank
refuses a checkpoint directory or a supervisor.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time
from typing import Any, Dict, List, Optional

# sysexits.h codes -- the CLI exit-code contract (the JAX package's):
EX_SOFTWARE = 70   # NumericalFaultError after recovery exhaustion
EX_IOERR = 74      # unreadable/torn input or checkpoint IO failure
EX_TEMPFAIL = 75   # preempted (signal/deadline), resumable


class PreemptedError(RuntimeError):
    """The run was stopped cooperatively (signal or deadline) and, when a
    checkpoint directory was configured, its intra-K state is durable on
    disk. Maps to exit 75 (EX_TEMPFAIL): rerun with the same
    ``--checkpoint-dir`` (and ``--resume auto``, the default) to continue
    inside the interrupted fit."""

    def __init__(self, message: str, *, reason: str = "signal",
                 step: Optional[int] = None, em_iter: Optional[int] = None,
                 checkpointed: bool = False):
        super().__init__(message)
        self.reason = reason
        self.step = step
        self.em_iter = em_iter
        self.checkpointed = checkpointed


class RunSupervisor:
    """Cooperative stop flag + signal handlers + deadline.

    ``max_runtime_s``: optional wall-clock budget measured from
    :meth:`install`; reaching it trips the same stop flag a SIGTERM does.
    ``install_signals=False`` supports library use from non-main threads
    (``signal.signal`` is main-thread-only) and tests.
    """

    _HANDLED = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, max_runtime_s: Optional[float] = None,
                 install_signals: bool = True):
        self.max_runtime_s = max_runtime_s
        self._install_signals = install_signals
        self._stop = threading.Event()
        self._reason: Optional[str] = None
        self._deadline: Optional[float] = None
        self._old_handlers: Dict[int, Any] = {}
        self._preempt_emitted = False
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    @property
    def active(self) -> bool:
        return True

    def install(self) -> "RunSupervisor":
        """Arm the deadline and (main thread only) the signal handlers."""
        if self.max_runtime_s is not None:
            self._deadline = time.monotonic() + float(self.max_runtime_s)
        if self._install_signals:
            try:
                for sig in self._HANDLED:
                    self._old_handlers[sig] = signal.signal(
                        sig, self._on_signal)
            except ValueError:
                # Not the main thread: deadline and request_stop still work.
                self._old_handlers.clear()
        return self

    def uninstall(self) -> None:
        """Restore the prior signal handlers."""
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()

    def _on_signal(self, signum, frame) -> None:
        # Signal context: set the flag and nothing else. A second delivery
        # falls through to the ORIGINAL handler, so a double Ctrl-C still
        # kills a wedged run the hard way.
        if self._stop.is_set():
            old = self._old_handlers.get(signum)
            if callable(old):
                old(signum, frame)
            elif old == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self._reason = ("sigterm" if signum == signal.SIGTERM else "sigint")
        self._stop.set()

    # -- the stop flag -----------------------------------------------------

    def request_stop(self, reason: str) -> None:
        """Trip the stop flag programmatically (tests)."""
        if not self._stop.is_set():
            self._reason = reason
            self._stop.set()

    @property
    def stop_requested(self) -> bool:
        self._check_deadline()
        return self._stop.is_set()

    @property
    def stop_reason(self) -> Optional[str]:
        return self._reason

    def _check_deadline(self) -> None:
        if (self._deadline is not None and not self._stop.is_set()
                and time.monotonic() >= self._deadline):
            self._reason = "deadline"
            self._stop.set()

    def poll(self, *, where: str, k: Optional[int] = None,
             em_iter: Optional[int] = None) -> bool:
        """The cooperative intervention point (main thread, between device
        work). Returns True when the run must stop now. Consults the
        ``preempt`` injection (a deterministic stand-in for SIGTERM at one
        EM iteration), the signal flag and the deadline, and emits one
        ``preempt`` record on the first observation."""
        from .testing import faults

        if not self._stop.is_set() and em_iter is not None:
            # block=-1: a plan aimed at a streaming block never fires here.
            if faults.take("preempt", iter=em_iter, block=-1) is not None:
                self._reason = "preempt_injected"
                self._stop.set()
        self._check_deadline()
        if not self._stop.is_set():
            return False
        self._emit_preempt(where=where, k=k, em_iter=em_iter)
        return True

    def poll_block(self, *, k: Optional[int], em_iter: int,
                   block: int) -> bool:
        """A streaming-block poll, as in the JAX package: ``preempt`` may
        target one block of one pass. (The port has no streaming path yet;
        this keeps the interface whole.)"""
        from .testing import faults

        if not self._stop.is_set():
            if faults.take("preempt", iter=em_iter, block=block) is not None:
                self._reason = "preempt_injected"
                self._stop.set()
        self._check_deadline()
        if not self._stop.is_set():
            return False
        self._emit_preempt(where="stream_block", k=k, em_iter=em_iter)
        return True

    def reset_for_retry(self) -> None:
        """Re-arm for another fit in the same run: drop the consumed stop.
        Signal handlers and the deadline persist."""
        self._stop = threading.Event()
        self._reason = None
        self._preempt_emitted = False

    def _emit_preempt(self, *, where: str, k=None, em_iter=None) -> None:
        with self._lock:
            if self._preempt_emitted:
                return
            self._preempt_emitted = True
        from . import telemetry

        rec = telemetry.current()
        if rec.active:
            fields: Dict[str, Any] = {"reason": self._reason, "where": where}
            if k is not None:
                fields["k"] = int(k)
            if em_iter is not None:
                fields["em_iter"] = int(em_iter)
            rec.emit("preempt", **fields)
            rec.metrics.count("preempts")

    def raise_stop(self, *, step: Optional[int] = None,
                   em_iter: Optional[int] = None,
                   checkpointed: bool = False) -> None:
        """Raise the stop as :class:`PreemptedError` after the caller
        finished its emergency checkpoint."""
        raise PreemptedError(
            f"run preempted ({self._reason}); "
            + (f"resumable from step {step}"
               + (f" iteration {em_iter}" if em_iter is not None else "")
               if checkpointed else
               "NOT resumable (no --checkpoint-dir)"),
            reason=self._reason or "unknown", step=step, em_iter=em_iter,
            checkpointed=checkpointed)

    def __enter__(self) -> "RunSupervisor":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class _NullSupervisor(RunSupervisor):
    """The inert ambient default: never stops, installs nothing."""

    def __init__(self):
        super().__init__(max_runtime_s=None, install_signals=False)

    @property
    def active(self) -> bool:
        return False

    def install(self) -> "RunSupervisor":
        return self

    def poll(self, **_kw) -> bool:
        return False

    def poll_block(self, **_kw) -> bool:
        return False


_NULL = _NullSupervisor()
_stack: List[RunSupervisor] = []


def current() -> RunSupervisor:
    """The ambient supervisor (inert unless a run activated one)."""
    return _stack[-1] if _stack else _NULL


@contextlib.contextmanager
def use(sup: RunSupervisor):
    """Make ``sup`` the ambient supervisor for the enclosed run (installs
    handlers/deadline on entry, restores on exit)."""
    _stack.append(sup)
    sup.install()
    try:
        yield sup
    finally:
        _stack.pop()
        sup.uninstall()
