"""Supervised serving worker pool (stream rev v2.7; docs/ROBUSTNESS.md
"Network failure containment").

``gmm serve --http PORT --workers N`` forks N child processes, each
running the ALREADY-TESTED single-process serve loop (``gmm serve
--socket``) over the shared model registry, and routes HTTP requests to
them over per-worker UNIX sockets. The parent process is a pure router +
supervisor: it never imports an executor or loads a model, so a worker
taking a SIGKILL (OOM, bad node, fault injection) can never take the
front end down with it.

Containment arc, in order:

* **routing affinity** -- (model, version) hashes to a stable worker
  slot (crc32), so each worker's executor cache warms for its own
  slice of the registry instead of every worker compiling everything;
* **sibling retry** -- a request in flight on a crashing worker fails
  its socket, and because scoring is idempotent the router retries it
  ONCE on the next live sibling; the client sees one answer, not an
  error (``retries`` counted; both legs dead -> 502
  ``worker_unavailable`` + ``retries_exhausted``);
* **respawn** -- the supervisor notices the exit (``worker_exit``,
  ``crash: true``), and relaunches with jittered doubling backoff
  (deterministic per slot+generation, so two crashed workers never
  thundering-herd the registry);
* **quarantine** -- a slot that crashes ``quarantine_after`` times in a
  row stops respawning: a reason file lands in the worker directory
  (``worker<i>.quarantine.json``) for the operator, siblings keep
  serving, and /readyz stays green as long as ANY worker lives.

Each spawn also writes ``worker<i>.json`` ({pid, socket, gen}) so tests
and the bench's kill-under-load probe can target a real pid. Children
get ``GMM_SERVE_WORKER`` / ``GMM_SERVE_WORKER_GEN`` stamped into their
env -- the match keys of the ``worker_crash`` fault kind
(testing/faults.py).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from . import wire

#: extra seconds of socket patience past a request's own deadline: the
#: worker answers deadline_expired itself; the transport must outlive it.
DEADLINE_GRACE_S = 10.0

#: how long a request parks waiting for ANY live worker before 502:
#: covers the whole-pool-dead respawn window (backoff + process start)
#: so a brief total outage reads as latency, not an error.
NO_WORKER_WAIT_S = 15.0


class _Worker:
    """One supervised slot: the live process (if any) and its crash
    history. All mutation happens under the pool lock."""

    def __init__(self, idx: int, sock: str):
        self.idx = idx
        self.sock = sock
        self.proc: Optional[subprocess.Popen] = None
        self.gen = 0                  # respawn generation (0 = first)
        self.consecutive_crashes = 0
        self.quarantined = False
        self.respawn_at: Optional[float] = None  # backoff deadline
        self.started_at = 0.0
        self.log = None

    @property
    def alive(self) -> bool:
        return (self.proc is not None and self.proc.poll() is None
                and os.path.exists(self.sock))


class WorkerPool:
    """Spawn, route to, and supervise N ``gmm serve --socket`` workers.

    ``command_for(idx, sock_path)`` builds one worker's argv (the serve
    CLI reconstructs it from its own flags minus the pool/http ones).
    """

    def __init__(self, n_workers: int, worker_dir: str, command_for,
                 *, backoff_base_s: float = 0.5,
                 quarantine_after: int = 5,
                 spawn_timeout_s: float = 120.0,
                 request_timeout_s: float = 60.0):
        if n_workers < 1:
            raise ValueError("worker pool needs at least 1 worker")
        self._n = int(n_workers)
        self._dir = worker_dir
        self._command_for = command_for
        self._backoff_base_s = float(backoff_base_s)
        self._quarantine_after = int(quarantine_after)
        self._spawn_timeout_s = float(spawn_timeout_s)
        self._request_timeout_s = float(request_timeout_s)
        self._lock = threading.Lock()
        self._draining = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(worker_dir, exist_ok=True)
        self._workers = [
            _Worker(i, os.path.join(worker_dir, f"worker{i}.sock"))
            for i in range(self._n)]
        self.worker_crashes = 0
        self.worker_respawns = 0
        self.worker_quarantines = 0
        self.retries = 0
        self.retries_exhausted = 0

    # -- lifecycle -------------------------------------------------------

    def _spawn(self, w: _Worker, *, respawn: bool) -> None:
        """Launch one worker process (pool lock held)."""
        if os.path.exists(w.sock):
            os.remove(w.sock)  # a stale socket must not look alive
        env = dict(os.environ,
                   GMM_SERVE_WORKER=str(w.idx),
                   GMM_SERVE_WORKER_GEN=str(w.gen))
        if w.log is None:
            w.log = open(os.path.join(self._dir, f"worker{w.idx}.log"),
                         "ab", buffering=0)
        w.proc = subprocess.Popen(self._command_for(w.idx, w.sock),
                                  stdin=subprocess.DEVNULL,
                                  stdout=w.log, stderr=w.log, env=env)
        w.started_at = time.monotonic()
        w.respawn_at = None
        state = {"worker": w.idx, "pid": w.proc.pid, "socket": w.sock,
                 "gen": w.gen}
        path = os.path.join(self._dir, f"worker{w.idx}.json")
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(state, f)
        os.replace(path + ".tmp", path)
        rec = telemetry.current()
        if rec.active:
            rec.emit("worker_spawn", worker=w.idx, pid=w.proc.pid,
                     socket=w.sock, attempt=w.consecutive_crashes,
                     respawn=bool(respawn),
                     **({"backoff_s": round(self._backoff_s(w), 3)}
                        if respawn else {}))
            rec.metrics.count("worker_spawns")

    def start(self) -> "WorkerPool":
        with self._lock:
            for w in self._workers:
                self._spawn(w, respawn=False)
        deadline = time.monotonic() + self._spawn_timeout_s
        for w in self._workers:
            while not os.path.exists(w.sock):
                if w.proc.poll() is not None:
                    raise RuntimeError(
                        f"worker {w.idx} exited with code "
                        f"{w.proc.returncode} before its socket came up "
                        f"(see {self._dir}/worker{w.idx}.log)")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"worker {w.idx} socket {w.sock} did not appear "
                        f"within {self._spawn_timeout_s:.0f}s")
                time.sleep(0.02)
        self._thread = threading.Thread(target=self._supervise,
                                        name="gmm-worker-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def _backoff_s(self, w: _Worker) -> float:
        """Jittered doubling backoff for this slot's next respawn.
        Deterministic per (slot, generation): reproducible in tests, and
        no two slots share a schedule."""
        attempt = max(1, w.consecutive_crashes)
        base = self._backoff_base_s * (2.0 ** (attempt - 1))
        seed = zlib.crc32(f"{w.idx}:{w.gen}".encode()) % 1000
        return base * (1.0 + seed / 2000.0)  # +0..50% jitter

    def _handle_exit(self, w: _Worker) -> None:
        """One observed worker death (pool lock held)."""
        code = w.proc.returncode
        pid = w.proc.pid
        rec = telemetry.current()
        if self._draining.is_set():
            if rec.active:
                rec.emit("worker_exit", worker=w.idx, exitcode=int(code),
                         pid=pid, reason="drain", crash=False)
            w.proc = None
            return
        self.worker_crashes += 1
        w.consecutive_crashes += 1
        quarantine = w.consecutive_crashes >= self._quarantine_after
        if rec.active:
            rec.emit("worker_exit", worker=w.idx, exitcode=int(code),
                     pid=pid, reason="crash", crash=True,
                     quarantined=bool(quarantine))
            rec.metrics.count("worker_crashes")
        try:
            if os.path.exists(w.sock):
                os.remove(w.sock)  # dead socket must stop routing NOW
        except OSError:
            pass
        w.proc = None
        if quarantine:
            self.worker_quarantines += 1
            w.quarantined = True
            reason = {
                "worker": w.idx, "pid": pid, "last_exitcode": int(code),
                "consecutive_crashes": int(w.consecutive_crashes),
                "reason": "crash loop: worker died "
                          f"{w.consecutive_crashes} consecutive times",
                "quarantined_at": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            }
            path = os.path.join(self._dir,
                                f"worker{w.idx}.quarantine.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(reason, f, indent=1)
            if rec.active:
                rec.metrics.count("worker_quarantines")
            return
        w.respawn_at = time.monotonic() + self._backoff_s(w)

    def _supervise(self) -> None:
        """The supervision loop: notice exits, pace respawns, reset the
        crash streak once a respawned worker proves stable."""
        while not self._stop.is_set():
            with self._lock:
                for w in self._workers:
                    if w.proc is not None and w.proc.poll() is not None:
                        self._handle_exit(w)
                    elif (w.proc is None and not w.quarantined
                          and not self._draining.is_set()
                          and w.respawn_at is not None
                          and time.monotonic() >= w.respawn_at):
                        w.gen += 1
                        self.worker_respawns += 1
                        self._spawn(w, respawn=True)
                        rec = telemetry.current()
                        if rec.active:
                            rec.metrics.count("worker_respawns")
                    elif (w.alive and w.consecutive_crashes
                          and time.monotonic() - w.started_at > 30.0):
                        # 30s of life = the crash loop broke; later
                        # crashes restart the backoff ladder from base.
                        w.consecutive_crashes = 0
            self._stop.wait(0.05)

    def begin_drain(self) -> None:
        """SIGTERM every worker: each drains its own queue and exits 75
        (the single-process contract, unchanged)."""
        self._draining.set()
        with self._lock:
            for w in self._workers:
                if w.proc is not None and w.proc.poll() is None:
                    try:
                        w.proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def wait(self, timeout_s: float = 60.0) -> List[Optional[int]]:
        """Join every worker (SIGKILL stragglers past the timeout);
        returns per-slot exit codes (None = never started)."""
        deadline = time.monotonic() + timeout_s
        codes: List[Optional[int]] = []
        for w in self._workers:
            proc = w.proc
            if proc is None:
                codes.append(None)
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
            codes.append(proc.returncode)
        return codes

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            for w in self._workers:
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                if w.log is not None:
                    w.log.close()
                    w.log = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing + transport (the HTTP backend protocol) -----------------

    def _route_order(self, model: Any, version: Any) -> List[_Worker]:
        """Live workers in routing order: the slot (model, version)
        hashes to first -- executor-cache affinity -- then siblings in
        ring order for failover."""
        start = zlib.crc32(f"{model}@{version}".encode()) % self._n
        with self._lock:
            ring = [self._workers[(start + i) % self._n]
                    for i in range(self._n)]
            return [w for w in ring if w.alive and not w.quarantined]

    def _call(self, w: _Worker, payload: bytes, timeout_s: float) -> dict:
        """One request over one worker's UNIX socket (fresh connection:
        a crashed worker must fail THIS call, not poison a pool)."""
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout_s)
            s.connect(w.sock)
            s.sendall(payload)
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 16)
                if not chunk:
                    raise ConnectionError(
                        f"worker {w.idx} closed mid-reply")
                buf += chunk
        return json.loads(buf)

    def score(self, req: dict,
              trace_id: Optional[str] = None) -> Tuple[dict, Dict[str, Any]]:
        """Route one request; on a transport failure (the worker died
        under it) retry ONCE on the next live sibling -- scoring is
        idempotent, so the client sees an answer, not the crash."""
        del trace_id  # the JSONL protocol mints its own ids worker-side
        x = req.get("x")
        if isinstance(x, np.ndarray):
            # A binary (x-gmm-rows) POST decoded to rows in the router;
            # re-frame instead of JSON-ifying the floats so the zero-copy
            # plane survives the hop to the worker: one header line
            # declaring x_bytes, then the raw frame.
            frame = wire.encode_rows(x)
            head = {k: v for k, v in req.items() if k != "x"}
            head["x_bytes"] = len(frame)
            payload = (json.dumps(head) + "\n").encode("utf-8") + frame
        else:
            payload = (json.dumps(req) + "\n").encode("utf-8")
        timeout_s = self._request_timeout_s
        deadline_ms = req.get("deadline_ms")
        if isinstance(deadline_ms, (int, float)) and deadline_ms > 0:
            timeout_s = float(deadline_ms) / 1e3 + DEADLINE_GRACE_S
        order = self._route_order(req.get("model"), req.get("version"))
        if not order:
            # Whole-pool-dead window (every slot mid-respawn): park the
            # request for the supervisor instead of 502ing instantly --
            # a transient total outage should cost latency, not errors.
            wait_until = time.monotonic() + min(timeout_s,
                                                NO_WORKER_WAIT_S)
            while (not order and time.monotonic() < wait_until
                   and not self._draining.is_set()):
                time.sleep(0.05)
                order = self._route_order(req.get("model"),
                                          req.get("version"))
        retried = False
        for attempt, w in enumerate(order[:2]):
            try:
                resp = self._call(w, payload, timeout_s)
                return resp, {"worker": w.idx, "retried": retried}
            except socket.timeout:
                return ({"id": req.get("id"), "ok": False,
                         "error": "http_timeout",
                         "detail": f"worker {w.idx} gave no reply within "
                         f"{timeout_s:.1f}s"},
                        {"worker": w.idx, "retried": retried})
            except (OSError, ConnectionError, ValueError):
                # Dead socket / torn reply: the worker crashed under us.
                if attempt == 0 and len(order) > 1:
                    retried = True
                    with self._lock:
                        self.retries += 1
                    rec = telemetry.current()
                    if rec.active:
                        rec.metrics.count("http_retries")
                    continue
        with self._lock:
            self.retries_exhausted += 1
        rec = telemetry.current()
        if rec.active:
            rec.metrics.count("http_retries_exhausted")
        return ({"id": req.get("id"), "ok": False,
                 "error": "worker_unavailable",
                 "detail": "no live worker could answer (crash retry "
                 "exhausted)"}, {"retried": retried})

    def ready(self) -> bool:
        if self._draining.is_set():
            return False
        with self._lock:
            return any(w.alive and not w.quarantined
                       for w in self._workers)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            alive = sum(w.alive for w in self._workers)
            quarantined = sum(w.quarantined for w in self._workers)
        return {
            "gmm_http_workers": float(self._n),
            "gmm_http_workers_alive": float(alive),
            "gmm_http_workers_quarantined": float(quarantined),
            "gmm_http_worker_crashes": float(self.worker_crashes),
            "gmm_http_worker_respawns": float(self.worker_respawns),
            "gmm_http_retries": float(self.retries),
            "gmm_http_retries_exhausted": float(self.retries_exhausted),
        }

    def http_stats(self) -> Dict[str, int]:
        """The pool's share of the ``serve_summary.http`` rollup."""
        with self._lock:
            return {
                "retries": int(self.retries),
                "retries_exhausted": int(self.retries_exhausted),
                "worker_crashes": int(self.worker_crashes),
                "worker_respawns": int(self.worker_respawns),
                "worker_quarantines": int(self.worker_quarantines),
                "workers": int(self._n),
            }
