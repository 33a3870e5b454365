"""Preemption-safe execution: the run-scoped shutdown supervisor.

The port's own copy of the JAX package's ``supervisor.py``. A batch
scheduler's SIGTERM (or a wall-clock limit) would otherwise kill a run with
every byte of sweep state in host memory, and a dead rank would leave the
survivors blocked forever in the next collective; the supervisor turns
both into clean, resumable exits:

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
- The fused sweep (``--fused-sweep``) has no mid-K poll, as in the JAX
  package: a stop requested during it takes effect at the next per-K
  emission (``where="fused_emit"``), after that K's checkpoint, and exits
  75 too; an armed ``preempt`` plan (an EM iteration) never fires there.
- On a mesh of more than one rank every poll site calls
  :meth:`RunSupervisor.poll_world`: one all_reduce MAX of the stop flag
  (its reason as a code) makes a stop requested on any rank a stop on
  every rank at the same point, so each rank raises ``PreemptedError``
  with the same step. Only rank 0 writes the checkpoints.
- :class:`LivenessWatchdog` exchanges rank heartbeats through the
  checkpoint filesystem (``parallel.distributed``'s heartbeat files, the
  JAX package's layout). A peer whose heartbeat goes stale beyond
  ``peer_timeout_s`` trips the stop with :class:`PeerLostError` (exit 75)
  instead of an indefinite collective hang; a main thread wedged inside a
  collective is forced out with exit 75 after a grace window, and
  ``distributed.barrier`` takes the timeout while the watchdog runs.
- :class:`ElasticRecovery` (``--elastic``) answers a ``PeerLostError`` by
  shrinking the world over the survivors (``parallel.elastic``) and
  refitting from the newest checkpoint.

Activation mirrors telemetry's ambient pattern: ``with
supervisor.use(RunSupervisor(...)):`` and the instrumented layers find it
via :func:`current`; the default ambient supervisor is inert. Telemetry
records ``preempt``, ``shutdown``, ``peer_lost``, ``elastic_shrink`` and
``elastic_resume`` document the lifecycle.
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# sysexits.h codes -- the CLI exit-code contract (the JAX package's):
EX_SOFTWARE = 70   # NumericalFaultError after recovery exhaustion
EX_IOERR = 74      # unreadable/torn input or checkpoint IO failure
EX_TEMPFAIL = 75   # preempted (signal/deadline/peer loss), resumable

# Stop reasons as the codes ``poll_world`` agrees on (1-based; 0 = no stop).
_REASONS = ("sigint", "sigterm", "deadline", "preempt_injected", "peer_stop",
            "peer_lost")
_REASON_CODE = {r: i + 1 for i, r in enumerate(_REASONS)}


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


class PeerLostError(RuntimeError):
    """A peer rank of a multi-controller run stopped participating (no
    heartbeat within ``peer_timeout_s``, or a collective barrier timed
    out). The local rank checkpoints and exits 75 instead of blocking
    forever in the next collective -- restart the whole job to resume."""

    def __init__(self, message: str, *, rank: Optional[int] = None,
                 age_s: Optional[float] = None,
                 timeout_s: Optional[float] = None):
        super().__init__(message)
        self.rank = rank
        self.age_s = age_s
        self.timeout_s = timeout_s


class RunSupervisor:
    """Cooperative stop flag + signal handlers + deadline + watchdog.

    ``max_runtime_s``: optional wall-clock budget measured from
    :meth:`install` (the CLI's ``--max-runtime``); the deadline trips the
    same stop flag a SIGTERM does, so a scheduler's hard kill limit can be
    front-run with a clean checkpointed exit. ``install_signals=False``
    supports library use from non-main threads (``signal.signal`` is
    main-thread-only) and tests.
    """

    _HANDLED = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, max_runtime_s: Optional[float] = None,
                 install_signals: bool = True):
        self.max_runtime_s = max_runtime_s
        self._install_signals = install_signals
        self._stop = threading.Event()
        self._reason: Optional[str] = None
        self._lost_peer: Optional[Dict[str, Any]] = None
        self._deadline: Optional[float] = None
        self._old_handlers: Dict[int, Any] = {}
        self._watchdog: Optional["LivenessWatchdog"] = None
        self._preempt_emitted = False
        self._stop_consumed = threading.Event()
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
                # Not the main thread: cooperative stop still works via
                # deadline/watchdog/request_stop; signals stay default.
                self._old_handlers.clear()
        return self

    def uninstall(self) -> None:
        """Restore prior signal handlers and stop the watchdog."""
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()
        self.stop_watchdog()

    def _on_signal(self, signum, frame) -> None:
        # Signal context: set the flag and nothing else (no locks, no IO).
        # A second delivery falls through to the ORIGINAL handler so an
        # operator's double Ctrl-C still kills a wedged run the hard way.
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
        """Trip the stop flag programmatically (watchdog, tests)."""
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

    @property
    def lost_peer(self) -> Optional[Dict[str, Any]]:
        """``{rank, age_s, timeout_s}`` once the watchdog flagged a peer."""
        return self._lost_peer

    def _check_deadline(self) -> None:
        if (self._deadline is not None and not self._stop.is_set()
                and time.monotonic() >= self._deadline):
            self._reason = "deadline"
            self._stop.set()

    def poll(self, *, where: str, k: Optional[int] = None,
             em_iter: Optional[int] = None) -> bool:
        """The cooperative intervention point (main thread, between device
        dispatches). Returns True when the run must stop now. Consults, in
        order: the ``rank_hang`` fault injection (testing only -- wedges
        THIS rank so a peer's watchdog can be rehearsed), the ``preempt``
        injection (a deterministic stand-in for SIGTERM at a specific EM
        iteration / streaming block), the signal flag, and the deadline.
        Emits one ``preempt`` telemetry record on the first observation.
        """
        from .testing import faults

        if faults.peek("rank_hang") is not None:
            self._maybe_hang(where=where, em_iter=em_iter)
        if not self._stop.is_set():
            self._maybe_rank_lost(where=where, em_iter=em_iter, block=-1)
        if not self._stop.is_set() and em_iter is not None:
            # block=-1: a spec targeting a specific streaming block must
            # only fire from poll_block, never at a segment boundary.
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
        """Streaming-block-granularity poll: like :meth:`poll` but the
        ``preempt`` injection can target a specific block of a specific
        pass (``{"iter": i, "block": j}``)."""
        from .testing import faults

        if faults.peek("rank_hang") is not None:
            self._maybe_hang(where="stream_block", em_iter=em_iter)
        if not self._stop.is_set():
            self._maybe_rank_lost(where="stream_block", em_iter=em_iter,
                                  block=block)
        if not self._stop.is_set():
            if faults.take("preempt", iter=em_iter, block=block) is not None:
                self._reason = "preempt_injected"
                self._stop.set()
        self._check_deadline()
        if not self._stop.is_set():
            return False
        self._emit_preempt(where="stream_block", k=k, em_iter=em_iter)
        return True

    def poll_world(self, *, where: str, k: Optional[int] = None,
                   em_iter: Optional[int] = None) -> bool:
        """:meth:`poll`, agreed over the world: one all_reduce MAX of this
        rank's stop reason (as a code, 0 = go on), so a stop requested on
        any rank stops every rank at this same poll, each with the highest
        reason any rank saw. Every rank must reach the same poll sites. A
        rank that has declared a peer lost stops without the collective
        (the lost peer would never join it). One process: :meth:`poll`."""
        from .parallel import distributed

        stop = self.poll(where=where, k=k, em_iter=em_iter)
        if self._lost_peer is not None or distributed.world_size() <= 1:
            return stop
        code = (_REASON_CODE.get(self._reason, _REASON_CODE["peer_stop"])
                if stop else 0)
        agreed = distributed.allreduce_max_int(code)
        if agreed and not stop:
            self.request_stop(_REASONS[agreed - 1])
            self._emit_preempt(where=where, k=k, em_iter=em_iter)
        return bool(agreed)

    def _maybe_hang(self, *, where: str, em_iter: Optional[int]) -> None:
        """Honor an armed ``rank_hang`` injection: stop heartbeating and
        wedge this rank right here (simulating a host stuck in a collective
        or a swap death), so the PEER's watchdog path can be tested. The
        process never returns from this; the test harness kills it."""
        from .testing import faults

        cfg = faults.peek("rank_hang")
        if cfg is not None and "iter" in cfg and em_iter is None:
            return  # iter-targeted spec: only EM-iteration polls match
        from .parallel import elastic

        rank = int(elastic.original_rank())
        match: Dict[str, Any] = {"rank": rank}
        if em_iter is not None:
            match["iter"] = em_iter
        if faults.take("rank_hang", **match) is None:
            return
        if self._watchdog is not None:
            self._watchdog.stop_writing()
        from .utils.logging_ import get_logger

        get_logger().warning(
            "rank_hang fault injected at %s (rank %d): wedging this "
            "process", where, rank)
        while True:  # pragma: no cover - killed externally
            time.sleep(3600.0)

    def _maybe_rank_lost(self, *, where: str, em_iter: Optional[int],
                         block: int) -> None:
        """Honor an armed ``rank_lost`` injection: behave exactly as if
        the liveness watchdog had just declared the spec's peer dead --
        WITHOUT any process dying -- so the elastic shrink path (and the
        exit-75 fallback when ``--elastic`` is off) is rehearsable
        deterministically on a single process. Gating mirrors ``preempt``:
        an ``iter``/``block``-targeted spec never fires at a between-K
        poll, and ``where`` (optional) pins one poll site."""
        from .testing import faults

        cfg = faults.peek("rank_lost")
        if cfg is None:
            return
        if em_iter is None:
            # Between-K (sweep) poll: only an untargeted spec --
            # or one pinned to this site via ``where`` -- may fire here.
            if "iter" in cfg or "block" in cfg:
                return
            cfg = faults.take("rank_lost", where=where)
        else:
            cfg = faults.take("rank_lost", where=where, iter=em_iter,
                              block=block)
        if cfg is None:
            return
        self._synthesize_peer_loss(
            rank=int(cfg.get("rank", 1)),
            timeout_s=float(cfg.get("timeout_s",
                                    self.collective_timeout_s or 0.0)))

    def _synthesize_peer_loss(self, *, rank: int,
                              timeout_s: float = 0.0,
                              age_s: Optional[float] = None) -> None:
        """The watchdog's declare-dead sequence, minus the forced-exit
        escalation thread: the poll that invokes this returns True
        immediately, so the main thread is by construction not wedged."""
        self._lost_peer = {"rank": int(rank),
                           "age_s": round(float(age_s if age_s is not None
                                                else timeout_s), 3),
                           "timeout_s": float(timeout_s)}
        from . import telemetry
        from .utils.logging_ import get_logger

        get_logger().error(
            "peer rank %d declared lost (injected rank_lost fault)", rank)
        rec = telemetry.current()
        if rec.active:
            rec.emit("peer_lost", rank=int(rank),
                     timeout_s=float(timeout_s),
                     age_s=self._lost_peer["age_s"])
            rec.metrics.count("peer_losses")
        if self._watchdog is not None:
            self.stop_watchdog()
        self.request_stop("peer_lost")

    def reset_for_retry(self) -> None:
        """Re-arm the supervisor for an elastic refit: drop the consumed
        stop (and the peer it blamed) so the surviving world's next fit
        polls clean. Signal handlers and the wall-clock deadline persist
        -- the runtime budget spans the whole run, shrinks included."""
        self.stop_watchdog()
        self._stop = threading.Event()
        self._stop_consumed = threading.Event()
        self._reason = None
        self._lost_peer = None
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
            if self._lost_peer is not None:
                fields["peer"] = self._lost_peer
            rec.emit("preempt", **fields)
            rec.metrics.count("preempts")

    # -- watchdog ----------------------------------------------------------

    def start_watchdog(self, directory: str, *, rank: int, nproc: int,
                       timeout_s: float,
                       interval_s: Optional[float] = None,
                       peers: Optional[List[int]] = None) -> None:
        """Start (idempotently) the cross-host liveness watchdog. Runs
        until :meth:`uninstall`; a stale peer trips the stop flag with
        reason ``peer_lost`` and the next poll raises
        :class:`PeerLostError` after the emergency checkpoint. ``peers``
        (original rank ids) overrides the default everyone-but-me set --
        an elastic refit watches only the sealed membership's survivors,
        never the rank it just shrank away."""
        if self._watchdog is not None:
            return

        def on_lost(peer_rank: int, age_s: float) -> None:
            self._lost_peer = {"rank": int(peer_rank),
                               "age_s": round(float(age_s), 3),
                               "timeout_s": float(timeout_s)}
            from . import telemetry
            from .utils.logging_ import get_logger

            get_logger().error(
                "peer rank %d heartbeat stale for %.1fs (timeout %.1fs): "
                "stopping with an emergency checkpoint", peer_rank, age_s,
                timeout_s)
            rec = telemetry.current()
            if rec.active:
                rec.emit("peer_lost", rank=int(peer_rank),
                         timeout_s=float(timeout_s),
                         age_s=round(float(age_s), 3))
                rec.metrics.count("peer_losses")
            self.request_stop("peer_lost")
            # Escalation: if the main thread never reaches raise_stop --
            # it is wedged INSIDE a compute collective waiting on the very
            # peer that died, so no poll point will ever run -- the
            # cooperative stop cannot work. After a grace window, exit
            # hard with the preemption code: the completed-K checkpoints
            # on disk are the emergency state (a mid-collective EM carry
            # is not host-observable), and a loud exit 75 beats an
            # indefinite hang (the reference's dead-rank behavior).
            grace = min(float(timeout_s), 30.0)

            def _force_exit():
                if self._stop_consumed.wait(grace):
                    return
                get_logger().error(
                    "main thread did not observe peer loss within %.1fs "
                    "(wedged in a collective?): forcing exit %d",
                    grace, EX_TEMPFAIL)
                try:
                    rec2 = telemetry.current()
                    if rec2.active:
                        rec2.emit("shutdown", reason="peer_lost",
                                  checkpointed=False, forced=True)
                except Exception:
                    pass
                os._exit(EX_TEMPFAIL)

            threading.Thread(target=_force_exit,
                             name="gmm-peer-lost-exit",
                             daemon=True).start()

        self._watchdog = LivenessWatchdog(
            directory, rank=rank, nproc=nproc, timeout_s=timeout_s,
            interval_s=interval_s, on_peer_lost=on_lost, peers=peers)
        self._watchdog.start()

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def peer_loss_from(self, exc: BaseException) -> Optional["PeerLostError"]:
        """The :class:`PeerLostError` behind ``exc``, a collective that
        failed (a dead peer's connection reset) while the watchdog runs:
        waits up to one timeout for the watchdog to name the silent peer,
        then returns the error, the stop consumed. None when ``exc`` did
        not come from torch.distributed or no peer went silent."""
        import traceback

        frames = traceback.extract_tb(exc.__traceback__)
        if not any(f"torch{os.sep}distributed" in f.filename for f in frames):
            return None
        wd = self._watchdog
        if wd is not None:
            deadline = time.monotonic() + wd.timeout_s + 2 * wd.interval_s
            while self._lost_peer is None and time.monotonic() < deadline:
                time.sleep(0.05)
        p = self._lost_peer
        if p is None:
            return None
        self._stop_consumed.set()
        return PeerLostError(
            f"peer rank {p['rank']} lost (heartbeat stale {p['age_s']:.1f}s "
            f"> timeout {p['timeout_s']:.1f}s; a collective failed: "
            f"{str(exc).splitlines()[0][:200]}); the completed Ks are "
            "durable", rank=p["rank"], age_s=p["age_s"],
            timeout_s=p["timeout_s"])

    @property
    def collective_timeout_s(self) -> Optional[float]:
        """Barrier timeout while the watchdog runs (None = unbounded).
        ``distributed.barrier`` consults this so a filesystem-rendezvous
        barrier cannot outlive a dead peer by more than the timeout."""
        if self._watchdog is None:
            return None
        return float(self._watchdog.timeout_s)

    def raise_stop(self, *, step: Optional[int] = None,
                   em_iter: Optional[int] = None,
                   checkpointed: bool = False) -> None:
        """Raise the stop as the right exception type (peer loss vs
        preemption) after the caller finished its emergency checkpoint."""
        self._stop_consumed.set()
        if self._reason == "peer_lost" and self._lost_peer is not None:
            p = self._lost_peer
            raise PeerLostError(
                f"peer rank {p['rank']} lost (heartbeat stale "
                f"{p['age_s']:.1f}s > timeout {p['timeout_s']:.1f}s); "
                "emergency checkpoint "
                + ("written" if checkpointed else "unavailable "
                   "(no --checkpoint-dir)"),
                rank=p["rank"], age_s=p["age_s"], timeout_s=p["timeout_s"])
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
    """Inert ambient default: every poll is a cheap False."""

    def __init__(self):
        super().__init__(install_signals=False)

    @property
    def active(self) -> bool:
        return False

    def poll(self, **kw) -> bool:  # noqa: D102 - inert fast path
        return False

    def poll_block(self, **kw) -> bool:
        return False

    def poll_world(self, **kw) -> bool:
        return False


class LivenessWatchdog(threading.Thread):
    """Background heartbeat writer + peer staleness checker.

    Each rank writes ``<dir>/rank<i>.hb`` every ``interval_s`` (default:
    a quarter of the timeout, capped at the telemetry heartbeat floor of
    5 s) and checks every peer's file age against ``timeout_s``. The
    exchange medium is the checkpoint filesystem every rank already
    shares -- deliberately NOT a collective: a collective heartbeat from a background thread would
    interleave with the main thread's compute collectives, and a hung
    peer is precisely the case where collectives stop returning.

    Staleness is READER-LOCAL: a peer's age is this watchdog's monotonic
    time since it last OBSERVED that peer's heartbeat mtime change --
    never a cross-host wall-clock difference. A peer whose clock is
    skewed hours into the past (or future) keeps producing mtime
    *changes* at the heartbeat cadence and is therefore never falsely
    declared dead; only a genuinely frozen file ages out.
    """

    def __init__(self, directory: str, *, rank: int, nproc: int,
                 timeout_s: float, interval_s: Optional[float] = None,
                 on_peer_lost: Optional[Callable[[int, float], None]] = None,
                 peers: Optional[List[int]] = None):
        super().__init__(name="gmm-liveness-watchdog", daemon=True)
        self.directory = directory
        self.rank = int(rank)
        self.nproc = int(nproc)
        self.peers = (tuple(int(p) for p in peers if int(p) != int(rank))
                      if peers is not None
                      else tuple(p for p in range(self.nproc)
                                 if p != self.rank))
        self.timeout_s = float(timeout_s)
        self.interval_s = float(interval_s if interval_s is not None
                                else min(max(self.timeout_s / 4.0, 0.2), 5.0))
        self._on_peer_lost = on_peer_lost
        self._stopped = threading.Event()
        self._writing = True
        self._started_mono = time.monotonic()
        # peer -> (last observed mtime, monotonic instant of that
        # observation): the reader-local staleness clock.
        self._seen: Dict[int, tuple] = {}

    def stop(self) -> None:
        self._stopped.set()

    def stop_writing(self) -> None:
        """Keep the thread alive but stop heartbeating (``rank_hang``)."""
        self._writing = False
        self._stopped.set()

    def run(self) -> None:  # pragma: no cover - exercised via subprocesses
        from .parallel import distributed

        while not self._stopped.is_set():
            if self._writing:
                try:
                    distributed.write_rank_heartbeat(
                        self.directory, self.rank)
                except OSError:
                    pass  # transient FS hiccup; next beat retries
            lost = self.check_peers()
            if lost is not None:
                rank, age = lost
                if self._on_peer_lost is not None:
                    self._on_peer_lost(rank, age)
                return
            self._stopped.wait(self.interval_s)

    def check_peers(self):
        """(rank, age_s) of the stalest over-timeout peer, else None. A
        peer that never wrote yet ages from this watchdog's start (ranks
        come up seconds apart; the timeout doubles as the grace window).

        Ages are reader-local monotonic deltas since the last observed
        mtime CHANGE -- mtime values are only compared for equality,
        never against this host's clock, so cross-host clock skew (or an
        NTP step on the peer) cannot fake a stale heartbeat."""
        from .parallel import distributed

        now = time.monotonic()
        worst = None
        for peer in self.peers:
            mtime = distributed.read_rank_heartbeat(self.directory, peer)
            seen = self._seen.get(peer)
            if seen is None or seen[0] != mtime:
                # First sight, or the file changed since last check:
                # restart this peer's staleness clock at now. A missing
                # file keeps the watchdog-start epoch as its baseline.
                base = (self._started_mono if mtime is None else now)
                self._seen[peer] = (mtime, base)
                seen = self._seen[peer]
            age = now - seen[1]
            if age > self.timeout_s and (worst is None or age > worst[1]):
                worst = (peer, age)
        return worst


class ElasticRecovery:
    """Bounded shrink-and-continue for :class:`PeerLostError`.

    ``fit_gmm`` wraps its fit in::

        while True:
            try:
                return _fit(...)
            except PeerLostError as e:
                recovery = recovery or ElasticRecovery.maybe(config)
                if recovery is None:
                    raise                       # exit 75, as today
                config = recovery.recover(e, config)

    Each recovery attempt backs off (``elastic_backoff_s`` doubling),
    rendezvouses the survivors on the checkpoint filesystem
    (``parallel.elastic``), adopts the sealed membership as the world
    overlay, re-arms the supervisor, and returns a config with
    ``resume="auto"`` so the refit restores the newest checkpoint.
    After ``elastic_max_retries`` exhausted attempts -- or a shrink
    below ``min_hosts`` -- the original error propagates and the run
    exits 75 exactly as a non-elastic peer loss would.
    """

    def __init__(self):
        self.attempt = 0
        # True once a recovery tore down or rebuilt the process group: the
        # refit then builds its model (and mesh) anew.
        self.rebuilt = False

    @staticmethod
    def maybe(config) -> Optional["ElasticRecovery"]:
        """An ElasticRecovery when the config opted in (``--elastic``
        plus a checkpoint dir -- the rendezvous medium), else None."""
        if getattr(config, "elastic", False) \
                and getattr(config, "checkpoint_dir", None):
            return ElasticRecovery()
        return None

    def recover(self, exc: PeerLostError, config):
        """One shrink: rendezvous the survivors, adopt the new world,
        return the refit config. Re-raises ``exc`` when recovery is out
        of budget, the lost rank is unidentifiable, or the world would
        shrink below ``min_hosts``."""
        from .telemetry import spans as tl_spans

        # The recovery phase gets its own trace span (rev v2.1): under
        # --metrics-port a shrink-and-resume shows up in the fit's span
        # tree with its measured cost, not just as shrink/resume events.
        with tl_spans.span("elastic_recovery", attempt=self.attempt + 1):
            return self._recover(exc, config)

    def _recover(self, exc: PeerLostError, config):
        import dataclasses

        from . import telemetry
        from .parallel import elastic
        from .utils.logging_ import get_logger

        log = get_logger()
        self.attempt += 1
        max_retries = int(getattr(config, "elastic_max_retries", 2))
        if self.attempt > max_retries:
            log.error("elastic recovery budget exhausted (%d attempts); "
                      "giving up", max_retries)
            raise exc
        if exc.rank is None:
            log.error("peer loss without an identifiable rank; cannot "
                      "shrink -- giving up")
            raise exc
        backoff = (float(getattr(config, "elastic_backoff_s", 0.5))
                   * (2.0 ** (self.attempt - 1)))
        if backoff > 0:
            time.sleep(backoff)

        mdir = elastic.membership_dir(config.checkpoint_dir)
        prev = elastic.read_membership(mdir)
        my_rank = elastic.original_rank()
        if prev is None:
            _, nproc0 = elastic.world()
            prev = elastic.Membership(generation=0,
                                      ranks=tuple(range(nproc0)),
                                      world_size0=nproc0)
        window = min(max(float(getattr(config, "peer_timeout_s", 60.0)),
                         1.0), 30.0)
        sealed = elastic.rendezvous(mdir, my_rank=my_rank, prev=prev,
                                    lost=(int(exc.rank),),
                                    window_s=window)
        min_hosts = int(getattr(config, "min_hosts", 1))
        if sealed.world_size < min_hosts:
            log.error("elastic shrink to %d host(s) is below --min-hosts "
                      "%d; giving up", sealed.world_size, min_hosts)
            raise exc
        elastic.set_world_overlay(sealed, my_rank)
        # The torch.distributed world shrinks in process: a new process
        # group over the survivors (none for one), keyed by the generation.
        self.rebuilt = elastic.rebuild_world(
            mdir, sealed, my_rank, device=getattr(config, "device", "cuda"))
        elastic.note_shrink()
        current().reset_for_retry()
        log.warning(
            "elastic recovery: generation %d sealed with %d/%d host(s) "
            "%s (lost rank %d, attempt %d/%d); resuming from checkpoint",
            sealed.generation, sealed.world_size, prev.world_size,
            list(sealed.ranks), int(exc.rank), self.attempt, max_retries)
        rec = telemetry.current()
        if rec.active:
            rec.emit("elastic_shrink", generation=int(sealed.generation),
                     survivors=[int(r) for r in sealed.ranks],
                     world_size=int(sealed.world_size),
                     lost_ranks=[int(exc.rank)], attempt=int(self.attempt),
                     min_hosts=min_hosts)
            rec.metrics.count("elastic_shrinks")
        elastic.note_resume()
        if rec.active:
            rec.emit("elastic_resume", generation=int(sealed.generation),
                     attempt=int(self.attempt),
                     world_size=int(sealed.world_size))
        mesh = getattr(config, "mesh_shape", None)
        if self.rebuilt or mesh is not None:
            # The survivors form a data-only mesh (the checkpoint holds the
            # whole state, so any mesh restores it); one survivor fits on
            # its own device.
            mesh = (sealed.world_size, 1) if sealed.world_size > 1 else None
        return dataclasses.replace(config, resume="auto", mesh_shape=mesh)


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
