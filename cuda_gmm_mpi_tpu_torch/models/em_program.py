"""The EM loop with its control on the device: run eagerly, or captured
once as CUDA graphs and replayed.

The JAX package runs each K's EM as one ``lax.while_loop`` inside one jit
(models/gmm.py there): the loop test, the counters and the loglik
trajectory live on the device, and the host dispatches once. Here the
same carry lives in device tensors (:class:`EMCarry`), and one EM
iteration is a pure function of it (:func:`em_step`): M-step, E-step, the
armed ``nan_loglik`` (a device compare against ``nan_iter``, -1 when
unarmed), the change, the health counters, the loop test

    more = ~fatal & (iters < min | (~(|change| <= eps) & iters < max))

and every field written back with ``torch.where(running, new, old)``, so
a step taken after the loop has ended is the identity, bit for bit.

:class:`EMProgram` runs that function one of two ways:

- eagerly (CPU tensors, a mesh whose collectives cannot be captured):
  each step dispatches its ops, and the host reads one scalar to decide
  whether to step again;
- captured (one CUDA device): the initial E-step and one iteration are
  each captured once as a ``torch.cuda.CUDAGraph`` on the static carry,
  and every iteration is one replay of the second. The program is the
  port's counterpart of the JAX package's one executable per padded
  width: it is cached on the model (``GMMModel.em_program``) and reused
  for every K at that width.

Either way the host reads at most one scalar per iteration (the packed
``iters``/``fatal``/``more`` status). While ``iters < min_iters`` it
enqueues the iterations without reading: only a fatal word can end the
loop early, and a fatal word freezes the carry. It stops at the run
supervisor's poll iterations (every ``poll_iters``, an armed ``preempt``)
as :func:`models.gmm._em_loop` does, which the captured loop is held to.

A capture that fails raises: there is no silent fallback to the eager
loop on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import health
from ..ops.kernels.counts import held_launches
from ..ops.mstep import SuffStats
from ..state import GMMState
from ..telemetry import profiling as tl_profiling


def leaves(obj) -> list:
    """The tensors of a dataclass of tensors, nested dataclasses flattened,
    in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out.extend(leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def select(mask: torch.Tensor, new, old):
    """``torch.where(mask, new, old)`` on every leaf of two dataclasses of
    tensors of one type (``mask`` 0-d)."""
    return type(old)(**{
        f.name: torch.where(mask, getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)})


def clone_tree(obj):
    """A copy of a dataclass of tensors whose leaves share no storage."""
    if not dataclasses.is_dataclass(obj):
        return obj.clone()
    return type(obj)(**{f.name: clone_tree(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


def copy_into(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst``."""
    for d, s in zip(leaves(dst), leaves(src)):
        if d is not s:
            d.copy_(s)


@dataclasses.dataclass
class EMControl:
    """The loop's inputs, as device tensors the host fills before a run:
    epsilon, the regression tolerance and the initial change (the data's
    dtype), the iteration bounds, the armed ``nan_loglik`` iteration (-1:
    unarmed) and a resume position (iteration, trajectory [L] float64 and
    its last slot)."""

    eps: torch.Tensor
    reg_tol: torch.Tensor
    change0: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    nan_iter: torch.Tensor
    iters0: torch.Tensor
    pos0: torch.Tensor
    resumed: torch.Tensor
    lls0: torch.Tensor

    @classmethod
    def alloc(cls, dtype, device, length: int) -> "EMControl":
        f = lambda dt: torch.zeros((), dtype=dt, device=device)
        i64 = torch.int64
        return cls(eps=f(dtype), reg_tol=f(dtype), change0=f(dtype),
                   lo=f(i64), hi=f(i64), nan_iter=f(i64), iters0=f(i64),
                   pos0=f(i64), resumed=f(torch.bool),
                   lls0=torch.zeros((length,), dtype=torch.float64,
                                    device=device))

    def set(self, epsilon: float, min_iters: int, max_iters: int,
            nan_iter: Optional[int], regression_scale: float,
            resume: Optional[dict]) -> None:
        """Fill the inputs of one run, with :func:`models.gmm._em_loop`'s
        arithmetic: epsilon and the tolerance rounded to the data's dtype,
        the change of a resumed trajectory's last two logliks in it."""
        dt = self.eps.dtype
        eps_t = torch.tensor(epsilon, dtype=dt)
        eps = float(eps_t)
        lls = []
        iters0 = 0
        if resume:
            iters0 = int(resume.get("em_iter", 0))
            lls = [float(x) for x in np.asarray(
                resume.get("em_lls", ()), np.float64).reshape(-1)]
        change = 2.0 * eps + 1.0  # gaussian.cu:525
        if len(lls) >= 2:
            change = float(torch.tensor(lls[-1], dtype=dt)
                           - torch.tensor(lls[-2], dtype=dt))
        self.eps.fill_(eps)
        self.reg_tol.fill_(float(regression_scale * eps_t))
        self.change0.fill_(change)
        self.lo.fill_(int(min_iters))
        self.hi.fill_(int(max_iters))
        self.nan_iter.fill_(-1 if nan_iter is None else int(nan_iter))
        self.iters0.fill_(iters0)
        self.pos0.fill_(max(len(lls) - 1, 0))
        self.resumed.fill_(bool(lls))
        if lls:
            buf = torch.full(self.lls0.shape, torch.nan, dtype=torch.float64)
            n = min(len(lls), buf.shape[0])
            buf[:n] = torch.tensor(lls[:n], dtype=torch.float64)
            self.lls0.copy_(buf)
        else:
            self.lls0.fill_(torch.nan)


@dataclasses.dataclass
class EMCarry:
    """The EM loop's state on the device: the model state and the
    statistics the next M-step reads, the loglik and its change (the data's
    dtype), the iterations run, the loglik trajectory (float64 [L], slot
    ``pos`` the newest), the health totals (int64 [NUM_FLAGS]), and whether
    a fatal word was seen and whether the loop runs on."""

    state: GMMState
    stats: SuffStats
    ll: torch.Tensor
    change: torch.Tensor
    iters: torch.Tensor
    pos: torch.Tensor
    lls: torch.Tensor
    totals: torch.Tensor
    fatal: torch.Tensor
    more: torch.Tensor


def _more(iters, change, fatal, ctrl: EMControl) -> torch.Tensor:
    """The loop test (gaussian.cu:532, NaN-safe; a fatal word ends it)."""
    return ~fatal & ((iters < ctrl.lo) | (~(change.abs() <= ctrl.eps)
                                          & (iters < ctrl.hi)))


def _counts(count, *args) -> torch.Tensor:
    """One iteration's health counters as int64 (the host loop's rint)."""
    return torch.round(count(*args)).to(torch.int64)


def em_init(state, estep: Callable, count: Callable,
            ctrl: EMControl) -> EMCarry:
    """The carry after the initial E-step (gaussian.cu:487-516), at the
    resume position ``ctrl`` holds."""
    stats = estep(state)
    ll = stats.loglik
    totals = _counts(count, state, stats, ll)
    slot = torch.arange(ctrl.lls0.shape[0], device=ll.device)
    lls = torch.where((slot == 0) & ~ctrl.resumed, ll.to(torch.float64),
                      ctrl.lls0)
    fatal = health.fatal(totals)
    iters, change = ctrl.iters0.clone(), ctrl.change0.clone()
    return EMCarry(state=state, stats=stats, ll=ll, change=change,
                   iters=iters, pos=ctrl.pos0.clone(), lls=lls,
                   totals=totals, fatal=fatal,
                   more=_more(iters, change, fatal, ctrl))


def em_step(c: EMCarry, estep: Callable, mstep: Callable, count: Callable,
            ctrl: EMControl) -> EMCarry:
    """One EM iteration (gaussian.cu:541-751) where ``c.more`` holds; the
    identity where it does not."""
    run = c.more
    state = mstep(c.state, c.stats)  # :541-701
    stats = estep(state)  # :713-741
    ll = stats.loglik
    ll = torch.where(c.iters + 1 == ctrl.nan_iter,
                     torch.full_like(ll, torch.nan), ll)
    counts = _counts(count, state, stats, ll, c.ll, ctrl.reg_tol)
    step = run.to(torch.int64)
    pos = c.pos + step
    slot = torch.arange(c.lls.shape[0], device=ll.device)
    iters = c.iters + step
    change = torch.where(run, ll - c.ll, c.change)  # :748
    fatal = c.fatal | (run & health.fatal(counts))
    return EMCarry(
        state=select(run, state, c.state), stats=select(run, stats, c.stats),
        ll=torch.where(run, ll, c.ll), change=change, iters=iters, pos=pos,
        lls=torch.where(run & (slot == pos), ll.to(torch.float64), c.lls),
        totals=c.totals + torch.where(run, counts, torch.zeros_like(counts)),
        fatal=fatal, more=_more(iters, change, fatal, ctrl))


def _launch_counters():
    """The kernel wrappers whose launch counters a replay must advance."""
    from ..ops.kernels import fused_stats as fs
    from ..ops.kernels import score as s1

    return (fs.fused_stats, fs.mstep, fs.fused_stats_batched,
            fs.mstep_batched, fs.local_lse, fs.stats_logz, s1.score,
            s1.centered_form, fs.fused_stats_narrow,
            fs.fused_stats_batched_narrow)


def add_launches(delta: tuple) -> None:
    for fn, n in zip(_launch_counters(), delta):
        fn.launches += n


class Captured:
    """A function of static device buffers captured as one CUDA graph.

    ``warm`` runs it once eagerly on a side stream (library loading,
    solver handles, the allocator), then ``capture`` records it into the
    shared ``pool``. Each wrapper counts its launch where it runs; warming
    up and capturing (which launches nothing) hold this thread's counts
    aside (``ops.kernels.counts.held_launches``), and every :meth:`replay`
    adds the launches the graph holds. ``capture_error_mode`` is
    ``torch.cuda.graph``'s: 'thread_local' lets other threads use the card,
    and count their launches, while this one captures."""

    def __init__(self, fn: Callable, pool,
                 capture_error_mode: str = "global") -> None:
        self.graph = torch.cuda.CUDAGraph()
        with held_launches() as tally, torch.cuda.graph(
                self.graph, pool=pool,
                capture_error_mode=capture_error_mode):
            fn()
        self.launches = tuple(tally.get(w, 0) for w in _launch_counters())

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


def pool_bytes(pool) -> int:
    """Device memory held by the CUDA-graph memory pool ``pool`` (the
    caching allocator's segments of that pool)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def warm_up(fn: Callable):
    """``fn()`` once on a side stream, as CUDA graph capture needs; this
    thread's launches are held aside, not counted. Returns ``fn``'s
    result."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with held_launches(), torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class EMProgram:
    """One padded width's EM loop (see the module docstring): ``estep``,
    ``mstep`` and ``count`` from ``models.gmm.em_hooks`` on this program's
    events, a trajectory of ``length`` slots, and ``capture`` (one CUDA
    device) or not. ``state_like`` gives the width and the static input's
    shapes.

    After capture, ``capture_s`` holds the seconds the warm-up and the two
    captures took (:func:`pool_bytes` gives the shared pool's size); under
    an active compile watch the capture is one ``em_program`` compile
    event with its width and the pool's bytes."""

    def __init__(self, estep: Callable, mstep: Callable, count: Callable,
                 state_like: GMMState, length: int, *, capture: bool,
                 pool=None) -> None:
        self.fns = (estep, mstep, count)
        self.ctrl = EMControl.alloc(state_like.means.dtype,
                                    state_like.N.device, length)
        self.captured = capture
        self.state_in = state_like
        self.carry: Optional[EMCarry] = None
        self.capture_s = 0.0
        if capture:
            tl_profiling.site_compile(
                "em_program", lambda: self._capture(state_like, pool),
                memory=lambda _: {"graph_pool_bytes": pool_bytes(pool)},
                width=int(state_like.num_clusters_padded))

    def _init(self) -> EMCarry:
        estep, _, count = self.fns
        return em_init(self.state_in, estep, count, self.ctrl)

    def _step(self) -> EMCarry:
        estep, mstep, count = self.fns
        return em_step(self.carry, estep, mstep, count, self.ctrl)

    def _capture(self, state_like: GMMState, pool) -> None:
        dev = state_like.N.device
        t0 = time.perf_counter()
        self.state_in = clone_tree(state_like)
        self.ctrl.set(1.0, 1, 1, None, 1.0, None)
        self.carry = warm_up(self._init)
        warm_up(self._step)
        # The static carry lives outside the graphs' pool, so no graph's
        # scratch memory ever aliases it.
        self.carry = clone_tree(self.carry)
        self.init_graph = Captured(
            lambda: copy_into(self.carry, self._init()), pool)
        self.step_graph = Captured(
            lambda: copy_into(self.carry, self._step()), pool)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def start(self, state: Optional[GMMState] = None) -> None:
        """The initial E-step on ``state`` (None: the state already in the
        program's input, where the fused sweep's per-K step put it)."""
        if not self.captured:
            if state is not None:
                self.state_in = state
            self.carry = self._init()
            return
        if state is not None:
            copy_into(self.state_in, state)
        self.init_graph.replay()

    def advance(self, n: int) -> None:
        """``n`` iterations, no read."""
        for _ in range(n):
            if self.captured:
                self.step_graph.replay()
            else:
                self.carry = self._step()

    def status(self):
        """(iters, fatal, more): the one scalar the host reads."""
        c = self.carry
        word = int((c.iters * 4 + c.fatal.to(torch.int64) * 2
                    + c.more.to(torch.int64)).item())
        return word >> 2, bool(word & 2), bool(word & 1)

    def drive(self, min_iters: int,
              should_stop: Optional[Callable[[int], bool]] = None,
              poll_iters: int = 25, resume: Optional[dict] = None) -> bool:
        """Run the started loop to its end; returns whether
        ``should_stop`` stopped it. ``should_stop(iters)`` is asked where
        :func:`models.gmm._em_loop` asks it."""
        from .gmm import _preempt_iter

        it, fatal, more = self.status()
        stopped = False
        preempt = _preempt_iter() if should_stop is not None else None
        seg0 = it
        if should_stop is not None and not fatal and not more and not resume:
            stopped = should_stop(it)
        while not (fatal or stopped) and more:
            n = max(min_iters - it, 1)
            if should_stop is not None:
                n = min(n, max(seg0 + poll_iters - it, 1))
                if preempt is not None and preempt > it:
                    n = min(n, preempt - it)
            self.advance(n)
            it, fatal, more = self.status()
            if should_stop is not None and not fatal and (
                    not more or it == preempt or it - seg0 >= poll_iters):
                seg0 = it
                stopped = should_stop(it)
        return stopped

    def run(self, state: GMMState, *, epsilon: float, min_iters: int,
            max_iters: int, nan_iter: Optional[int] = None,
            regression_scale: float = 10.0,
            should_stop: Optional[Callable[[int], bool]] = None,
            poll_iters: int = 25, resume: Optional[dict] = None):
        """One EM run from ``state``: :func:`models.gmm._em_loop`'s
        arguments and its :class:`models.gmm.EMRun`. The returned state
        shares no storage with the program's buffers."""
        from .gmm import EMRun

        self.ctrl.set(epsilon, min_iters, max_iters, nan_iter,
                      regression_scale, resume)
        self.start(state)
        stopped = self.drive(min_iters, should_stop, poll_iters, resume)
        c = self.carry
        vals = torch.cat([c.lls, c.totals.to(torch.float64),
                          c.iters.reshape(1).to(torch.float64),
                          c.pos.reshape(1).to(torch.float64)]).tolist()
        L = c.lls.shape[0]
        pos = int(vals[-1])
        lls = vals[:pos + 1]
        totals = np.rint(vals[L:L + health.NUM_FLAGS]).astype(np.int64)
        out_state = clone_tree(c.state) if self.captured else c.state
        extra = {"em_lls": np.asarray(lls, np.float64)} if stopped else {}
        return EMRun(out_state, lls[-1], int(vals[-2]), totals, lls, stopped,
                     extra)
