"""Resilient HTTP client for the serving tier (stdlib-only).

:class:`GMMClient` is the reference client for docs/SERVING.md's HTTP
front end, and the load half of ``bench.py --http``. The point is not
the four one-line scoring methods -- it is the retry discipline around
them, because a naive client is how a single slow server becomes a
regional outage:

* **deadline propagation** -- one budget covers the WHOLE call, retries
  included: each attempt's ``X-GMM-Deadline-Ms`` header carries the
  remaining budget, so the server sheds work the client has already
  given up on instead of scoring into the void;
* **bounded jittered-backoff retries** -- only on transport failures and
  explicitly-retryable statuses (429/502/503), never on deterministic
  client errors (4xx) or dispatch failures (500); honors the server's
  ``Retry-After`` when it names a longer wait than the backoff ladder;
* **retry budget** -- a token bucket refilled by SUCCESSFUL requests
  (``retry_budget`` tokens each, spend 1.0 per retry): under a real
  outage the bucket drains and the client fails fast instead of
  multiplying the dead server's load by ``1 + retries`` -- the storm
  amplification cap;
* **latency hedging** (opt-in) -- ``hedge_ms`` launches ONE duplicate of
  a still-unanswered request after that many milliseconds and takes the
  first answer (scoring is idempotent); tail latency hiding for the
  p99, paid for with bounded extra load.

Every knob is deterministic under ``seed`` so tests and the bench can
replay schedules.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Any, Dict, List, Optional
from urllib.parse import urlsplit

import numpy as np

from . import wire

RETRYABLE_STATUSES = (429, 502, 503)


class GMMClientError(RuntimeError):
    """Transport/budget failure after the retry policy gave up.
    ``status`` carries the last HTTP status (None = connection error);
    ``body`` the last decoded response body, when one arrived."""

    def __init__(self, msg: str, status: Optional[int] = None,
                 body: Optional[dict] = None):
        super().__init__(msg)
        self.status = status
        self.body = body


class GMMClient:
    """One serving-tier endpoint, with the retry/hedging policy baked in.

    Thread-safe: each request opens its own connection (the resilience
    policy needs per-attempt sockets anyway -- a retry must not reuse
    the pipe its predecessor died on), and the retry-budget bucket is
    the only shared state, guarded by a lock.
    """

    def __init__(self, base_url: str, *, timeout_s: float = 30.0,
                 retries: int = 2, backoff_base_s: float = 0.05,
                 retry_budget: float = 0.2, hedge_ms: Optional[float] = None,
                 encoding: str = "json", seed: int = 0):
        if encoding not in ("json", "binary"):
            raise ValueError(
                f"encoding must be 'json' or 'binary', got {encoding!r}")
        # 'binary' posts each request's rows as ONE x-gmm-rows frame
        # (serving/wire.py) instead of a JSON body: no float
        # stringification client-side, no JSON float parsing
        # server-side, bit-identical responses either way (a JSON body
        # parses to float64 before the executor cast; the binary
        # encoder packs float64 unless handed float32 rows).
        self._encoding = encoding
        parts = urlsplit(base_url if "//" in base_url
                         else f"http://{base_url}")
        self._host = parts.hostname or "127.0.0.1"
        self._port = parts.port or 80
        self._timeout_s = float(timeout_s)
        self._retries = int(retries)
        self._backoff_base_s = float(backoff_base_s)
        self._budget_ratio = float(retry_budget)
        self._hedge_ms = float(hedge_ms) if hedge_ms else None
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # The bucket starts with enough for a few retries so a cold
        # client can survive hitting a mid-respawn pool on request one.
        self._tokens = 2.0
        self._tokens_cap = 10.0
        self.requests = 0
        self.retries = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.budget_denied = 0

    # -- scoring API -----------------------------------------------------

    def predict(self, model: str, x, **kw) -> List[int]:
        return self._call_op(model, "predict", x, **kw)

    def predict_proba(self, model: str, x, **kw) -> List[List[float]]:
        return self._call_op(model, "predict_proba", x, **kw)

    def score_samples(self, model: str, x, **kw) -> List[float]:
        return self._call_op(model, "score_samples", x, **kw)

    def score(self, model: str, x, **kw) -> float:
        return self._call_op(model, "score", x, **kw)

    def _call_op(self, model: str, op: str, x, *,
                 version: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 request_id: Any = None):
        resp = self.request(model, op, x, version=version,
                            deadline_ms=deadline_ms,
                            request_id=request_id)
        return resp["result"]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"requests": self.requests, "retries": self.retries,
                    "hedges": self.hedges, "hedge_wins": self.hedge_wins,
                    "budget_denied": self.budget_denied,
                    "retry_tokens": round(self._tokens, 3)}

    # -- probes ----------------------------------------------------------

    def healthz(self) -> bool:
        return self._probe("/healthz")

    def readyz(self) -> bool:
        return self._probe("/readyz")

    def _probe(self, path: str) -> bool:
        try:
            status, _, _ = self._attempt("GET", path, None, None, None)
            return status == 200
        except OSError:
            return False

    # -- the retry engine ------------------------------------------------

    def request(self, model: str, op: str, x, *,
                version: Optional[int] = None,
                deadline_ms: Optional[float] = None,
                request_id: Any = None,
                encoding: Optional[str] = None) -> dict:
        """One scored request under the full policy. Returns the decoded
        response body of the first 200; raises :class:`GMMClientError`
        otherwise. ``encoding`` overrides the client default per
        request ('binary' sends one x-gmm-rows frame; the request id
        only rides JSON bodies)."""
        enc = encoding or self._encoding
        if enc not in ("json", "binary"):
            raise ValueError(
                f"encoding must be 'json' or 'binary', got {enc!r}")
        spec = model if version is None else f"{model}@{version}"
        path = f"/v1/models/{spec}:{op}"
        if enc == "binary":
            if request_id is not None:
                raise ValueError(
                    "binary encoding has no body field for request_id; "
                    "use encoding='json' when an id must round-trip")
            body = wire.encode_rows(np.asarray(x))
            headers = {"Content-Type": wire.CONTENT_TYPE}
        else:
            body = json.dumps(
                {"x": x, **({"id": request_id} if request_id is not None
                            else {})}).encode("utf-8")
            headers = None
        t_end = (time.perf_counter() + deadline_ms / 1e3
                 if deadline_ms else None)
        with self._lock:
            self.requests += 1
        last_status: Optional[int] = None
        last_body: Optional[dict] = None
        last_err = "no attempt ran"
        for attempt in range(self._retries + 1):
            remaining_ms = None
            if t_end is not None:
                remaining_ms = (t_end - time.perf_counter()) * 1e3
                if remaining_ms <= 0:
                    raise GMMClientError(
                        f"{path}: deadline of {deadline_ms}ms exhausted "
                        f"after {attempt} attempt(s)", last_status,
                        last_body)
            if attempt > 0 and not self._spend_retry_token():
                with self._lock:
                    self.budget_denied += 1
                raise GMMClientError(
                    f"{path}: retry budget exhausted (failing fast "
                    "instead of amplifying load): " + last_err,
                    last_status, last_body)
            try:
                status, resp_headers, decoded = self._attempt_hedged(
                    path, body, remaining_ms, headers)
            except OSError as e:
                last_err = f"connection failed: {e}"
                last_status, last_body = None, None
                self._sleep_backoff(attempt, None, t_end)
                continue
            last_status, last_body = status, decoded
            if status == 200:
                self._refill()
                return decoded or {}
            last_err = (f"HTTP {status}: "
                        f"{(decoded or {}).get('error', '?')}")
            if status not in RETRYABLE_STATUSES:
                raise GMMClientError(f"{path}: {last_err}", status,
                                     decoded)
            self._sleep_backoff(attempt,
                                resp_headers.get("Retry-After"), t_end)
        raise GMMClientError(
            f"{path}: retries exhausted after {self._retries + 1} "
            "attempts: " + last_err, last_status, last_body)

    def _spend_retry_token(self) -> bool:
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            self.retries += 1
            return True

    def _refill(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens_cap,
                               self._tokens + self._budget_ratio)

    def _sleep_backoff(self, attempt: int, retry_after: Optional[str],
                       t_end: Optional[float]) -> None:
        """Jittered doubling backoff, raised to the server's Retry-After
        when it asks for more, clipped to the remaining deadline."""
        with self._lock:
            jitter = self._rng.random()
        wait = self._backoff_base_s * (2.0 ** attempt) * (1.0 + jitter)
        if retry_after:
            try:
                wait = max(wait, float(retry_after))
            except ValueError:
                pass
        if t_end is not None:
            wait = min(wait, max(0.0, t_end - time.perf_counter()))
        if wait > 0:
            time.sleep(wait)

    # -- transport -------------------------------------------------------

    def _attempt_hedged(self, path: str, body: bytes,
                        remaining_ms: Optional[float],
                        req_headers: Optional[Dict[str, str]] = None):
        """One POST attempt, optionally racing a single hedge duplicate
        launched after ``hedge_ms`` of silence; first answer wins."""
        if self._hedge_ms is None:
            return self._attempt("POST", path, body, remaining_ms,
                                 req_headers)
        done = threading.Event()
        results: List[tuple] = []
        errors: List[BaseException] = []
        lock = threading.Lock()

        def run(is_hedge: bool):
            try:
                out = self._attempt("POST", path, body, remaining_ms,
                                    req_headers)
                with lock:
                    results.append((is_hedge, out))
            except OSError as e:
                with lock:
                    errors.append(e)
            finally:
                done.set()

        primary = threading.Thread(target=run, args=(False,), daemon=True)
        primary.start()
        hedged = False
        if not done.wait(self._hedge_ms / 1e3):
            hedged = True
            with self._lock:
                self.hedges += 1
            threading.Thread(target=run, args=(True,),
                             daemon=True).start()
        timeout = (remaining_ms / 1e3 + 5.0 if remaining_ms is not None
                   else self._timeout_s + 5.0)
        t_stop = time.perf_counter() + timeout
        while time.perf_counter() < t_stop:
            with lock:
                if results:
                    is_hedge, out = results[0]
                    if is_hedge and hedged:
                        with self._lock:
                            self.hedge_wins += 1
                    return out
                # every launched leg failed -> surface the first error
                if errors and len(errors) >= (2 if hedged else 1):
                    raise errors[0]
            done.wait(0.005)
            done.clear()
        raise TimeoutError(f"{path}: no leg answered in {timeout:.1f}s")

    def _attempt(self, method: str, path: str, body: Optional[bytes],
                 remaining_ms: Optional[float],
                 extra_headers: Optional[Dict[str, str]]):
        """One HTTP round trip. Returns (status, headers, decoded_body);
        raises OSError flavors on transport failure."""
        timeout = self._timeout_s
        if remaining_ms is not None:
            timeout = min(timeout, remaining_ms / 1e3 + 1.0)
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            if remaining_ms is not None:
                headers["X-GMM-Deadline-Ms"] = f"{remaining_ms:.1f}"
            headers.update(extra_headers or {})
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            decoded: Optional[dict] = None
            if raw:
                try:
                    decoded = json.loads(raw.decode("utf-8"))
                except ValueError:
                    decoded = None
            return resp.status, dict(resp.getheaders()), decoded
        finally:
            conn.close()
