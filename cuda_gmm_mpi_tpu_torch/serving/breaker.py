"""Per-route circuit breakers for the serving loop.

A registry model whose artifact scores non-finite densities (or whose
version directory went unreadable under the server) would otherwise fail
EVERY request routed to it, forever, while paying the full dispatch cost
each time -- the serving analog of the fit path's NaN-"converges" hole
(docs/ROBUSTNESS.md). The breaker contains that failure to its own
(model, version) route:

```
          consecutive failures >= threshold
 CLOSED  ----------------------------------->  OPEN
   ^                                            |
   | success                                    | backoff elapsed
   |                                            v
   +------------------------------------  HALF_OPEN
                     (a failed probe re-opens with doubled backoff)
```

- **closed**: requests dispatch normally; any success clears the
  consecutive-failure count.
- **open**: requests fast-fail with ``circuit_open`` BEFORE model
  resolution or dispatch -- a poisoned model costs a dict lookup, not an
  executor call -- while every other route keeps serving.
- **half-open**: after a jittered exponential backoff (the
  ``checkpoint_retries`` shape from utils/checkpoint.py: doubling base
  with +-25% deterministic jitter, seeded per (route, trip) so a fleet
  of servers desynchronizes their probes), traffic is admitted again;
  the first recorded outcome decides -- success closes the breaker,
  failure re-opens it with a doubled backoff.

What counts as a route failure is the caller's contract
(serving/server.py): a ``RegistryError`` at resolve, an executor
dispatch/compile error, or the cheap post-dispatch non-finite score
check. Request-content errors (bad D, NaN rows in ``x``) never touch
the breaker -- they are the client's fault, not the model's.

State transitions emit ``circuit`` telemetry events (stream rev v1.7,
docs/OBSERVABILITY.md) so an opened route is observable in the stream,
not just as a burst of failed requests.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, Hashable, Optional, Tuple

# First-reopen backoff; doubles per consecutive trip of one route.
BACKOFF_BASE_S = 1.0
BACKOFF_MAX_S = 60.0


def _jitter(route: Hashable, trip: int) -> float:
    """+-25% deterministic jitter (the checkpoint-retry recipe), seeded
    per (route, trip) so concurrent servers' half-open probes spread."""
    seed = hash((route, int(trip))) & 0xFFFFFFFF
    return 0.75 + 0.5 * random.Random(seed).random()


class _Route:
    __slots__ = ("state", "failures", "trips", "until", "last_reason")

    def __init__(self):
        self.state = "closed"
        self.failures = 0     # consecutive failures since the last success
        self.trips = 0        # consecutive opens (resets on close)
        self.until = 0.0      # monotonic time the open state ends
        self.last_reason: Optional[str] = None


class CircuitBreakers:
    """Breaker state for every (model, version) route of one server.

    ``threshold`` consecutive failures open a route; ``backoff_base_s``
    seeds the open window, doubling per consecutive trip up to
    ``backoff_max_s``. All methods are single-lock cheap -- the serve
    tick loop calls them on every dispatch.
    """

    def __init__(self, *, threshold: int = 3,
                 backoff_base_s: float = BACKOFF_BASE_S,
                 backoff_max_s: float = BACKOFF_MAX_S):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._routes: Dict[Hashable, _Route] = {}
        self._lock = threading.Lock()
        self.trips = 0        # total opens across every route
        self.closes = 0       # total recoveries (open/half-open -> closed)

    # -- admission --------------------------------------------------------

    def admit(self, route: Tuple[str, Optional[int]]
              ) -> Optional[Dict[str, Any]]:
        """None when ``route`` may dispatch; a fast-fail info dict
        (``{"retry_in_s": ...}``) while its breaker is open.

        An open route whose backoff elapsed transitions to half-open and
        IS admitted -- that dispatch is the probe whose outcome closes or
        re-opens the breaker.
        """
        with self._lock:
            r = self._routes.get(route)
            if r is None or r.state == "closed":
                return None
            if r.state == "open":
                now = time.monotonic()
                if now < r.until:
                    return {"retry_in_s": max(0.0, r.until - now)}
                r.state = "half_open"
                self._emit(route, r, "half_open")
                return None
            return None  # half_open: admit; the recorded outcome decides

    # -- outcomes ---------------------------------------------------------

    def record_success(self, route) -> None:
        """A dispatch on ``route`` produced finite scores: close."""
        with self._lock:
            r = self._routes.get(route)
            if r is None:
                return
            r.failures = 0
            if r.state != "closed":
                r.state = "closed"
                r.trips = 0
                self.closes += 1
                self._emit(route, r, "closed")

    def record_failure(self, route, reason: str) -> bool:
        """A dispatch (or resolve) on ``route`` failed; True when the
        route is now open. A half-open probe failure re-opens
        immediately with a doubled backoff."""
        with self._lock:
            r = self._routes.setdefault(route, _Route())
            r.failures += 1
            r.last_reason = reason
            if r.state != "half_open" and r.failures < self.threshold:
                return False
            r.trips += 1
            backoff = min(self.backoff_base_s * (2.0 ** (r.trips - 1)),
                          self.backoff_max_s) * _jitter(route, r.trips)
            r.state = "open"
            r.until = time.monotonic() + backoff
            self.trips += 1
            self._emit(route, r, "open", backoff_s=round(backoff, 4))
            return True

    def reset(self, route) -> None:
        """Forget ``route``'s state (hot-reload swapped its model: the
        new version starts with a clean, closed breaker)."""
        with self._lock:
            self._routes.pop(route, None)

    # -- observability ----------------------------------------------------

    def state(self, route) -> str:
        with self._lock:
            r = self._routes.get(route)
            return r.state if r is not None else "closed"

    def open_routes(self) -> int:
        with self._lock:
            return sum(1 for r in self._routes.values()
                       if r.state != "closed")

    def stats(self) -> Dict[str, int]:
        return {"trips": int(self.trips), "closes": int(self.closes),
                "open_routes": self.open_routes()}

    def _emit(self, route, r: _Route, state: str, **extra) -> None:
        # Called under self._lock; the recorder has its own lock and
        # never calls back into the breaker.
        from .. import telemetry

        rec = telemetry.current()
        if not rec.active:
            return
        name, version = route
        fields: Dict[str, Any] = {"model": name, "state": state,
                                  "failures": int(r.failures),
                                  "trips": int(r.trips)}
        if version is not None:
            fields["version"] = int(version)
        if r.last_reason:
            fields["reason"] = r.last_reason
        fields.update(extra)
        rec.emit("circuit", **fields)
        if state == "open":
            rec.metrics.count("serve_breaker_trips")
