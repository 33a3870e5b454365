"""Scoring executables with a bucketed LRU cache: CUDA-graph replays of S1
on the card, eager callables on the CPU.

The port of the JAX package's ``serving/executor.py``, with its public
surface and counters. What it bounds is the same:

- **Bucketing** (the sweep's pow2 policy, ``state.bucket_width``, applied
  to the EVENT axis): a request of N rows is padded up to the smallest
  power-of-two block >= N (clamped to [min_block, max_block]; larger
  requests split into max_block slices), and the model's K axis is padded
  to its pow2 bucket with algebraically inert inactive slots
  (``parallel.sharded_em.pad_state_clusters``). The executable universe is
  (kinds x log2 blocks x log2 K-buckets), independent of traffic.
- **Executables built once**: on a CUDA device each key (kind, block,
  K-bucket, D) is one ``torch.cuda.CUDAGraph`` over static device buffers,
  captured once (``capture_error_mode='thread_local'``, under the
  executor's lock, so the HTTP threads, the metrics sampler and the drift
  plane may use the card meanwhile). The graph holds one launch of S1
  (ops/kernels/score.py) at every precision: its expanded form under
  'expanded' or 'packed', its centered form under 'centered'. S1 computes
  at 'highest', whose class is inside the 'high' and 'default' classes, and
  keeps a row's bits whatever block, batch or K-pad carries it, which a
  library product does not. On the CPU a key is an eager callable over
  ``posteriors``. A build counts one compile on either device, under
  ``site_compile('serve', ...)``. Setting ``route = "torch"`` before the
  first call puts the torch-ops ``posteriors`` in the graphs instead: the
  yardstick a measurement holds S1 against, never a fallback.
- **Static buffers instead of donation**: each dispatch writes the request
  block into a pinned host staging buffer, copies it into the graph's
  static input, copies the route's operands (device to device) into the
  graph's static operand slots, replays, and reads the outputs back
  through pinned host buffers before the lock is released. The graphs of
  one executor share one memory pool; their inputs, operands and outputs
  are allocated outside it, so an evicted graph frees them.
- **LRU bound**: at most ``max_executables`` live programs; the least
  recently used is dropped (its graph and buffers freed) and rebuilt on
  next use -- counted, so an undersized cache is observable.

Operands are per route and prepared once: ``pin_state`` places a route's
padded state (and S1's operands) on the device, so warm dispatches copy
device to device and the executables stay shared across the models of a
family. The stacked program (``lax.map`` in the JAX package) is one graph
that runs the solo sequence once per lane, so each lane's bits equal a solo
dispatch's.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.estep import posteriors
from ..ops.kernels import score as s1
from ..state import GMMState
from ..telemetry import profiling as tl_profiling

# Executable kinds: 'proba' returns (responsibilities [B, K], logZ [B]);
# 'assign' returns (argmax labels int32 [B], logZ [B]) -- the hard-
# assignment path never transfers the [B, K] posterior block.
KINDS = s1.KINDS

_LEAVES = ("N", "pi", "constant", "avgvar", "means", "R", "Rinv", "active")


def pow2_bucket(n: int, lo: int = 1, hi: Optional[int] = None) -> int:
    """Smallest power of two >= ``n``, clamped to [lo, hi].

    The event-axis spelling of the sweep's ``state.bucket_width`` pow2
    policy: both bound the distinct compiled shapes to one per octave.
    ``hi`` callers split/pad beyond the cap themselves.
    """
    b = 1 << max(0, int(n) - 1).bit_length()
    b = max(b, int(lo))
    if hi is not None:
        b = min(b, int(hi))
    return b


def device_or_raise(device) -> torch.device:
    """``device`` as a torch device; 'cuda' without a GPU raises (the
    entry points' rule: no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' (--device=cpu) to run on the CPU")
    return dev


class _Route:
    """One prepared (state, K-bucket): the padded state on the device and
    the operands a dispatch copies into a program's slots (S1's A_ext and
    g, or the padded state's leaves on the torch-ops route; none on the
    CPU)."""

    __slots__ = ("state", "operands")

    def __init__(self, state: GMMState, operands):
        self.state = state
        self.operands = operands


class _EagerProgram:
    """A CPU executable: ``posteriors`` on each lane's zero-padded block."""

    def __init__(self, ex: "ScoringExecutor", kind: str, lanes: int,
                 block: int, kb: int, d: int):
        self._ex, self._kind, self._block, self._d = ex, kind, block, d
        self.device_bytes = 0
        self.capture_s = 0.0

    def run(self, lanes):
        out = []
        for route, x in lanes:
            m = x.shape[0]
            xb = torch.zeros((self._block, self._d), dtype=self._ex.torch_dtype)
            xb[:m] = torch.from_numpy(x)
            a, z = self._ex._score(route.state, xb, self._kind)
            out.append((a[:m].numpy(), z[:m].numpy()))
        return out


class _GraphProgram:
    """A CUDA executable: one captured graph over static buffers of
    ``lanes`` lanes (1 for a solo key), each lane the solo sequence."""

    def __init__(self, ex: "ScoringExecutor", kind: str, lanes: int,
                 block: int, kb: int, d: int):
        from ..models.em_program import Captured, warm_up

        dev, dt = ex.device, ex.torch_dtype
        t0 = time.perf_counter()
        self.x_host = torch.zeros((lanes, block, d), dtype=dt,
                                  pin_memory=True)
        self.x_dev = torch.zeros((lanes, block, d), dtype=dt, device=dev)
        self.slots = [ex._static_operands(kb, d) for _ in range(lanes)]
        a_dt = torch.int32 if kind == "assign" else dt
        a_shape = (lanes, block) if kind == "assign" else (lanes, block, kb)
        self.a_dev = torch.zeros(a_shape, dtype=a_dt, device=dev)
        self.z_dev = torch.zeros((lanes, block), dtype=dt, device=dev)
        self.a_host = torch.zeros(a_shape, dtype=a_dt, pin_memory=True)
        self.z_host = torch.zeros((lanes, block), dtype=dt, pin_memory=True)

        def body():
            for i in range(lanes):
                ex._score_into(self.slots[i], self.x_dev[i], kind,
                               self.a_dev[i], self.z_dev[i])

        with torch.cuda.device(dev):
            warm_up(body)
            self.captured = Captured(body, ex._pool(),
                                     capture_error_mode="thread_local")
        # Seconds the buffers, the warm-up launch and the capture took.
        self.capture_s = time.perf_counter() - t0
        self.device_bytes = sum(
            t.numel() * t.element_size()
            for t in [self.x_dev, self.a_dev, self.z_dev]
            + [s for slot in self.slots for s in slot])

    def run(self, lanes):
        xh = self.x_host.numpy()
        for i, (route, x) in enumerate(lanes):
            m = x.shape[0]
            xh[i, :m] = x
            xh[i, m:] = 0
        self.x_dev.copy_(self.x_host, non_blocking=True)
        for slot, (route, _) in zip(self.slots, lanes):
            for dst, src in zip(slot, route.operands):
                dst.copy_(src)
        self.captured.replay()
        self.a_host.copy_(self.a_dev, non_blocking=True)
        self.z_host.copy_(self.z_dev, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        a, z = self.a_host.numpy(), self.z_host.numpy()
        return [(a[i, :x.shape[0]].copy(), z[i, :x.shape[0]].copy())
                for i, (_, x) in enumerate(lanes)]


class ScoringExecutor:
    """Bucketed executable cache for predict/score under one numeric family
    (dtype x covariance structure x quad layout x precision) on one device.

    One executor serves any number of models sharing the family: the
    programs are keyed by (kind, block, K-bucket, D), so two 16-cluster
    models of the same D share every executable.
    """

    def __init__(self, *, dtype: str = "float32", diag_only: bool = False,
                 quad_mode: str = "expanded",
                 matmul_precision: str = "highest",
                 min_block: int = 256, max_block: int = 65536,
                 max_executables: int = 32, device="cpu"):
        if min_block < 1 or max_block < min_block:
            raise ValueError(
                f"need 1 <= min_block <= max_block, got "
                f"{min_block}/{max_block}")
        if max_executables < 1:
            raise ValueError("max_executables must be >= 1")
        self._dtype = np.dtype(dtype)
        self.torch_dtype = getattr(torch, self._dtype.name)
        self._diag_only = bool(diag_only)
        self._quad_mode = quad_mode
        self._centered = quad_mode == "centered"
        self._precision = matmul_precision
        self._min_block = int(min_block)
        self._max_block = int(max_block)
        self._max_execs = int(max_executables)
        self.device = device_or_raise(device)
        # S1 on the card for every precision and quad mode.
        self.route = "cpu" if self.device.type == "cpu" else "S1"
        self._lock = threading.RLock()
        self._graph_pool = None
        # key -> program, LRU order (oldest first).
        self._cache: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        # (id(state), k_bucket) -> (state ref, _Route). The strong state
        # ref pins the id against recycling; bounded LRU.
        self._state_memo: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        # Device-resident route states: same key shape as the memo, but
        # EXEMPT from its LRU bound -- a pinned route's prepared state stays
        # resident until release_state, so warm dispatches never re-place
        # leaves host->device. Bounded by the served route set.
        self._pinned: Dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self.evictions = 0
        # Dispatch-time state preparations that could NOT be served from
        # a pinned entry -- the silent fallback to per-request staging
        # the serve.host_staging counter makes observable.
        self.host_stagings = 0

    # -- observability ---------------------------------------------------

    @property
    def compile_count(self) -> int:
        """Total executable builds so far (the zero-recompile assertion
        target: warm traffic must not move this)."""
        return self.compiles

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles, "evictions": self.evictions,
                "live_executables": len(self._cache),
                "pinned_states": len(self._pinned),
                "host_stagings": self.host_stagings}

    def cached_keys(self) -> Tuple[tuple, ...]:
        return tuple(self._cache.keys())

    def device_bytes(self) -> int:
        """Device memory the cached programs hold: their static buffers
        and, on the card, the graphs' shared pool."""
        from ..models.em_program import pool_bytes

        held = sum(p.device_bytes for p in self._cache.values())
        if self._graph_pool is not None:
            held += pool_bytes(self._graph_pool)
        return held

    # -- bucketing -------------------------------------------------------

    def block_for(self, n: int) -> int:
        """The padded block size an ``n``-row slice dispatches at."""
        return pow2_bucket(n, lo=self._min_block, hi=self._max_block)

    def blocks_for(self, n: int):
        """(start, length, block) slices covering an N-row request."""
        out = []
        start = 0
        while start < n:
            m = min(n - start, self._max_block)
            out.append((start, m, self.block_for(m)))
            start += m
        return out or [(0, 0, self._min_block)]

    def padded_rows(self, n: int) -> int:
        """Total dispatched rows for an N-row request (telemetry)."""
        return sum(b for _, _, b in self.blocks_for(n)) if n else 0

    # -- state preparation ----------------------------------------------

    def _resolve_bucket(self, state: GMMState,
                        k_bucket: Optional[int]) -> int:
        kb = pow2_bucket(state.num_clusters_padded)
        if k_bucket is not None:
            kb = max(kb, int(k_bucket))
        return kb

    def _prepare(self, state: GMMState, kb: int) -> _Route:
        """``state`` cast to the executor dtype, placed on its device and
        K-padded to ``kb`` with inert slots, with the operands its
        dispatches copy -- the one host->device placement both the memo and
        pin planes cache."""
        from ..parallel.sharded_em import pad_state_clusters

        dt, dev = self.torch_dtype, self.device
        cast = GMMState(**{
            f: getattr(state, f).to(device=dev,
                                    dtype=torch.bool if f == "active" else dt)
            for f in _LEAVES})
        padded = pad_state_clusters(cast, kb)
        if self.route == "S1":
            # Formed at the model's own K, then padded: the same bits at
            # every K-bucket.
            operands = s1.pad_operands(
                *s1.score_operands(cast, self._diag_only, self._centered),
                kb)
        elif self.route == "torch":
            operands = tuple(getattr(padded, f) for f in _LEAVES)
        else:
            operands = None
        return _Route(padded, operands)

    def _pin(self, state: GMMState, k_bucket: Optional[int]) -> _Route:
        kb = self._resolve_bucket(state, k_bucket)
        key = (id(state), kb)
        hit = self._pinned.get(key)
        if hit is not None and hit[0] is state:
            return hit[1]
        route = self._prepare(state, kb)
        self._pinned[key] = (state, route)
        return route

    def pin_state(self, state: GMMState,
                  k_bucket: Optional[int] = None) -> GMMState:
        """Pin ``state``'s prepared form device-resident (the route-
        prepare half of the device-resident serving plane): later
        dispatches hit the resident handle instead of re-placing leaves,
        and the entry survives any amount of cross-route traffic --
        unlike the LRU-8 dispatch memo. Idempotent per (state, bucket);
        released by :meth:`release_state` exactly as the memo is."""
        with self._lock:
            return self._pin(state, k_bucket).state

    def _route_for(self, state: GMMState,
                   k_bucket: Optional[int] = None) -> _Route:
        kb = self._resolve_bucket(state, k_bucket)
        key = (id(state), kb)
        hit = self._pinned.get(key)
        if hit is not None and hit[0] is state:
            return hit[1]
        hit = self._state_memo.get(key)
        if hit is not None and hit[0] is state:
            self._state_memo.move_to_end(key)
            return hit[1]
        route = self._prepare(state, kb)
        if any(v[0] is state for v in self._pinned.values()):
            self._pinned[key] = (state, route)
            return route
        self.host_stagings += 1
        self._state_memo[key] = (state, route)
        while len(self._state_memo) > 8:
            self._state_memo.popitem(last=False)
        return route

    def prepared_state(self, state: GMMState,
                       k_bucket: Optional[int] = None) -> GMMState:
        """``state`` cast to the executor dtype and K-padded to its pow2
        bucket with inert inactive slots, on the executor's device; served
        from the pinned plane when the route was pinned (:meth:`pin_state`),
        else memoized per state object.

        ``k_bucket`` overrides the bucket upward (stacked cross-model
        dispatches pad every participant to the family's shared width;
        inactive slots are algebraically inert, so a wider pad never
        changes a model's scores). A wider-bucket variant of a PINNED
        state pins too, while preparing an unpinned state at dispatch time
        counts ``host_stagings``: the observable fallback to per-request
        staging."""
        with self._lock:
            return self._route_for(state, k_bucket).state

    def release_state(self, state: GMMState) -> int:
        """Drop ``state``'s prepared-state memo AND pinned entries (a
        hot-reload replaced its registry version, serving/server.py).
        Executables stay -- they are keyed by shapes and shared across
        models -- and a later pinned-version request simply re-prepares the
        state. Returns the number of entries released."""
        with self._lock:
            dead = [k for k, v in self._state_memo.items()
                    if v[0] is state]
            for k in dead:
                del self._state_memo[k]
            pinned_dead = [k for k, v in self._pinned.items()
                           if v[0] is state]
            for k in pinned_dead:
                del self._pinned[k]
            return len(dead) + len(pinned_dead)

    # -- the scoring functions a program holds ---------------------------

    def _score(self, state: GMMState, x: torch.Tensor, kind: str):
        """``posteriors`` of the family (then argmax labels for 'assign'):
        the CPU program's function, and the torch-ops route's."""
        w, logz = posteriors(state, x, diag_only=self._diag_only,
                             quad_mode=self._quad_mode,
                             matmul_precision=self._precision)
        if kind == "assign":
            return torch.argmax(w, dim=1).to(torch.int32), logz
        return w, logz

    def _static_operands(self, kb: int, d: int):
        """One lane's static operand slots on the card, holding an inert
        state until a dispatch copies a route in."""
        dt, dev = self.torch_dtype, self.device
        inert = GMMState(
            N=torch.zeros(kb, dtype=dt, device=dev),
            pi=torch.ones(kb, dtype=dt, device=dev),
            constant=torch.zeros(kb, dtype=dt, device=dev),
            avgvar=torch.zeros(kb, dtype=dt, device=dev),
            means=torch.zeros((kb, d), dtype=dt, device=dev),
            R=torch.eye(d, dtype=dt, device=dev).repeat(kb, 1, 1),
            Rinv=torch.eye(d, dtype=dt, device=dev).repeat(kb, 1, 1),
            active=torch.zeros(kb, dtype=torch.bool, device=dev))
        if self.route == "S1":
            return s1.score_operands(inert, self._diag_only, self._centered)
        return tuple(getattr(inert, f) for f in _LEAVES)

    def _score_into(self, slot, x, kind: str, a_out, z_out) -> None:
        """One lane of a graph: S1 on the slot's operands, or the torch-ops
        ``posteriors`` on the slot's state, into static outputs."""
        if self.route == "S1":
            a_ext, g = slot
            if kind == "assign":
                s1.score_launch(x, a_ext, g, z_out, diag=self._diag_only,
                                labels=a_out, centered=self._centered)
            else:
                s1.score_launch(x, a_ext, g, z_out, diag=self._diag_only,
                                w=a_out, centered=self._centered)
            return
        a, z = self._score(GMMState(*slot), x, kind)
        a_out.copy_(a)
        z_out.copy_(z)

    def _pool(self):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    # -- executables -----------------------------------------------------

    def _program(self, key: tuple, site: str, label: str, kind: str,
                 lanes: int, block: int, kb: int, d: int):
        prog = self._cache.get(key)
        if prog is not None:
            self.hits += 1
            self._cache.move_to_end(key)
            return prog
        self.misses += 1
        cls = _EagerProgram if self.device.type == "cpu" else _GraphProgram
        # site_compile: a passthrough with no CompileWatch active; under
        # one, the build is timed and lands on the stream as a ``compile``
        # event.
        prog = tl_profiling.site_compile(
            site, lambda: cls(self, kind, lanes, block, kb, d),
            memory=lambda p: {"device_bytes": int(p.device_bytes)},
            key=label)
        self.compiles += 1
        self._cache[key] = prog
        while len(self._cache) > self._max_execs:
            self._cache.popitem(last=False)
            self.evictions += 1
        return prog

    def _executable(self, kind: str, block: int, kb: int, d: int):
        if kind not in KINDS:
            raise ValueError(f"unknown executable kind {kind!r}")
        return self._program((kind, block, kb, d), "serve",
                             f"{kind}:{block}x{d}:k{kb}", kind, 1, block, kb,
                             d)

    def _executable_stacked(self, models: int, block: int, kb: int,
                            d: int):
        """The STACKED program: ``models`` lanes of (state, request block),
        each lane the solo 'proba' sequence -- ONE dispatch for several
        different models of one numeric family, bit-identical per lane to
        per-model dispatches. Shares the LRU cache/counters with the
        per-model programs under key ('stacked', M, block, kb, d)."""
        return self._program(("stacked", models, block, kb, d),
                             "serve_stacked",
                             f"stacked{models}:{block}x{d}:k{kb}", "proba",
                             models, block, kb, d)

    def stackable_rows(self, n: int) -> bool:
        """Whether an ``n``-row request fits one stacked lane (requests
        past ``max_block`` split into slices, which the stacked layout
        does not model -- they dispatch per-model instead)."""
        return 0 < int(n) <= self._max_block

    def infer_stacked(self, states, Xs):
        """Score several DIFFERENT models' requests in one dispatch.

        ``states[i]`` scores ``Xs[i]`` ([n_i, D], all same D and all
        within ``max_block``). Every lane pads to the family-shared
        (row-block, K-bucket) -- pad rows/slots are discarded before
        return, and the model axis pads to its pow2 bucket with
        duplicate lanes, so the executable universe stays bounded at
        (log2 models x log2 blocks x log2 K-buckets). Returns
        ``([(w [n_i, K_bucket_i], logz [n_i]), ...], padded_block)``
        with per-lane host numpy arrays sliced back to each model's own
        rows and K bucket.
        """
        if len(states) != len(Xs) or not states:
            raise ValueError("infer_stacked needs one X per state")
        M = len(states)
        xs = [np.ascontiguousarray(np.asarray(x, self._dtype))
              for x in Xs]
        d = xs[0].shape[1]
        for x in xs:
            if x.ndim != 2 or x.shape[1] != d:
                raise ValueError(
                    f"stacked requests must share D={d}, got {x.shape}")
            if not self.stackable_rows(x.shape[0]):
                raise ValueError(
                    f"stacked lane of {x.shape[0]} rows exceeds "
                    f"max_block={self._max_block}")
        block = max(self.block_for(x.shape[0]) for x in xs)
        own_kb = [pow2_bucket(s.num_clusters_padded) for s in states]
        kb = max(own_kb)
        with self._lock:
            routes = [self._route_for(s, k_bucket=kb) for s in states]
            mb = pow2_bucket(M)
            lanes = list(zip(routes, xs))
            lanes += [lanes[0]] * (mb - M)
            run = self._executable_stacked(mb, block, kb, d)
            outs = run.run(lanes)
        return ([(outs[i][0][:, :own_kb[i]], outs[i][1]) for i in range(M)],
                block)

    def warmup(self, state: GMMState, d: Optional[int] = None,
               kinds=("proba",), blocks=None) -> int:
        """Pre-build the executables a model's traffic will hit (cold
        servers call this before accepting requests). Returns the number
        of NEW builds."""
        with self._lock:
            ps = self._route_for(state).state
            d = int(d or ps.num_dimensions)
            kb = ps.num_clusters_padded
            before = self.compiles
            for kind in kinds:
                for block in (blocks or (self._min_block,)):
                    self._executable(kind, int(block), kb, d)
            return self.compiles - before

    # -- inference -------------------------------------------------------

    def infer(self, state: GMMState, X, *, want: str = "proba"):
        """Score ``X`` [N, D] under ``state``; returns host numpy arrays.

        ``want='proba'`` -> (w [N, K_bucket], logz [N]);
        ``want='assign'`` -> (labels int32 [N], logz [N]).
        N is bucketed/split per the block policy; every padded row is
        garbage discarded before return (rows are independent through
        the per-event log-sum-exp, so padding never perturbs real rows).
        """
        X = np.ascontiguousarray(np.asarray(X, self._dtype))
        if X.ndim != 2:
            raise ValueError(f"X must be [n_events, n_dims], got {X.shape}")
        n, d = X.shape
        with self._lock:
            route = self._route_for(state)
            ps = route.state
            if d != ps.num_dimensions:
                raise ValueError(
                    f"model has D={ps.num_dimensions} but X has D={d}")
            kb = ps.num_clusters_padded
            if n == 0:
                first = (np.zeros((0, kb), self._dtype) if want == "proba"
                         else np.zeros((0,), np.int32))
                return first, np.zeros((0,), self._dtype)
            outs_a, outs_z = [], []
            for start, m, block in self.blocks_for(n):
                run = self._executable(want, block, kb, d)
                [(a, z)] = run.run([(route, X[start:start + m])])
                outs_a.append(a)
                outs_z.append(z)
        if len(outs_a) == 1:  # one block: no second copy
            return outs_a[0], outs_z[0]
        return (np.concatenate(outs_a, axis=0),
                np.concatenate(outs_z, axis=0))

    def predict_proba(self, state: GMMState, X, k: Optional[int] = None):
        """Posterior responsibilities [N, k] (k = the model's true
        cluster count; defaults to the state's padded width)."""
        w, _ = self.infer(state, X, want="proba")
        return w[:, :int(k or state.num_clusters_padded)]

    def predict(self, state: GMMState, X):
        labels, _ = self.infer(state, X, want="assign")
        return labels

    def score_samples(self, state: GMMState, X):
        return self.infer(state, X, want="assign")[1]

    def score(self, state: GMMState, X) -> float:
        return float(np.mean(self.score_samples(state, X)))


@functools.lru_cache(maxsize=None)
def _shared_executor(dtype: str, diag_only: bool, quad_mode: str,
                     matmul_precision: str, max_block: int,
                     min_block: int = 256,
                     device: str = "cpu") -> ScoringExecutor:
    max_block = max(1, int(max_block))
    return ScoringExecutor(dtype=dtype, diag_only=diag_only,
                           quad_mode=quad_mode,
                           matmul_precision=matmul_precision,
                           # Small-chunk configs (tests fit with
                           # chunk_size < 256) cap the floor too.
                           min_block=min(int(min_block), max_block),
                           max_block=max_block, device=device)


def executor_for_config(config) -> ScoringExecutor:
    """The process-shared executor for one :class:`GMMConfig` family.

    Keyed by the fields that change the executables (dtype, covariance
    structure, quad layout, precision, block cap, device) so every
    estimator of a family shares one executable cache -- N estimators cost
    one build per bucket, not N.
    """
    device_or_raise(config.device)
    return _shared_executor(config.dtype, bool(config.diag_only),
                            config.quad_mode, config.matmul_precision,
                            int(config.chunk_size),
                            device=str(config.device))


def executor_for_model(model: "ServedModel",  # noqa: F821
                       **kw) -> ScoringExecutor:
    """The shared executor for one registry :class:`ServedModel` on
    ``device`` (default 'cuda'; raises without a GPU)."""
    device = str(kw.pop("device", "cuda"))
    device_or_raise(device)
    return _shared_executor(model.dtype, model.diag_only,
                            kw.pop("quad_mode", "expanded"),
                            kw.pop("matmul_precision", "highest"),
                            kw.pop("max_block", 65536),
                            kw.pop("min_block", 256), device=device)
