"""The whole model-order sweep with its control on the device.

The port of the JAX package's ``models/fused_sweep.py``, which runs every
K of the sweep inside one ``lax.while_loop``: EM, the score, the
best-model save, the per-K log row, empty-cluster elimination, the pair
scan and the merge, with no host round trip between Ks. Here one K is two
programs on the device:

- the EM program of the sweep's width (models/em_program.py), shared with
  the host-driven sweep at that width;
- the per-K step (:func:`k_step`): the score (float64, as the JAX
  package's ``riss_of``), a non-finite score flagged in
  ``NONFINITE_SCORE`` and never saved, the save rule of gaussian.cu:839,
  the log row ``(k, loglik, score, iters, health word)``, the order
  reduction (``ops.merge.eliminate_and_reduce_device``) and the test

      cont = ~stop_now & can_merge & (k_active - 1 >= stop_number) & ~fatal_k

On one CUDA device both are CUDA graphs, replayed: the host reads the EM
program's one status scalar per iteration past ``min_iters`` and one
``done`` scalar per K, nothing else unless a per-K emission is on. On the
CPU both run eagerly, the same functions. A fatal per-K health word ends
the sweep (the caller falls back to the host-driven sweep's recovery
ladder, as in the JAX package).

FIXED-WIDTH BY DESIGN, as in the JAX package: every K runs at the starting
padded width, where the host-driven sweep (``sweep_k_buckets='pow2'``)
would shrink it as K drops. Its only saving over the host-driven sweep at
``sweep_k_buckets='off'`` is the order reduction on the device.

``emit_cb(payload)`` is called on the host after each K with the sweep
position (the JAX package's ordered ``io_callback``): the checkpoint and
per-K timing hook, and the only point where a cooperative stop can land.
With ``emit_light`` the payload holds only ``step`` and ``done``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import health
from ..ops.formulas import model_score
from ..ops.merge import eliminate_and_reduce_device
from ..state import GMMState
from ..telemetry import profiling as tl_profiling
from .em_program import (
    Captured, EMProgram, clone_tree, copy_into, pool_bytes, select, warm_up,
)


@dataclasses.dataclass
class SweepCarry:
    """The sweep's state on the device: the current state and its K, the
    best state with its loglik (the data's dtype) and score (float64), the
    per-K log [start_k, 5] (float64), the step, whether the sweep is done,
    the health totals (int64) and the last K's counters."""

    state: GMMState
    k: torch.Tensor
    best_state: GMMState
    best_ll: torch.Tensor
    best_riss: torch.Tensor
    log: torch.Tensor
    step: torch.Tensor
    done: torch.Tensor
    health: torch.Tensor
    h_last: torch.Tensor


def k_step(c: SweepCarry, em, *, start_k: int, stop_number: int,
           target_k: int, num_events: int, num_dimensions: int,
           criterion: str, covariance_type: Optional[str],
           diag_only: bool) -> SweepCarry:
    """The sweep's work after one K's EM (``em``, its
    :class:`~models.em_program.EMCarry`): the body of the JAX package's
    ``fused_sweep`` after its ``em`` call."""
    k = c.k
    s, ll, iters = em.state, em.ll, em.iters
    dt = ll.dtype
    riss = model_score(ll.to(torch.float64), k.to(torch.float64), num_events,
                       num_dimensions, criterion=criterion,
                       covariance_type=covariance_type)
    score_ok = torch.isfinite(riss)
    lane = torch.arange(health.NUM_FLAGS, device=ll.device)
    h_k = em.totals + ((lane == health.NONFINITE_SCORE)
                       & ~score_ok).to(torch.int64)
    fatal_k = health.fatal(h_k)
    # gaussian.cu:839, and a finite score.
    better = (riss < c.best_riss) if target_k == 0 else torch.zeros_like(
        score_ok)
    save = ((c.step == 0) | better | (k == target_k)) & score_ok
    f64 = torch.float64
    row = torch.stack([k.to(f64), ll.to(f64), riss, iters.to(f64),
                       health.pack_word_traced(h_k).to(f64)])
    rows = torch.arange(start_k, device=ll.device)
    log = torch.where((rows == c.step)[:, None], row[None, :], c.log)
    stop_now = k <= stop_number
    next_state, k_active, min_d, _ = eliminate_and_reduce_device(
        s, diag_only=diag_only)
    can_merge = (k_active >= 2) & torch.isfinite(min_d)
    # A count that elimination drops below the target runs no EM there
    # (the host loop's `while k >= stop_number`); a fatal word ends it too.
    cont = ~stop_now & can_merge & (k_active - 1 >= stop_number) & ~fatal_k
    return SweepCarry(
        state=select(cont, next_state, s),
        k=torch.where(cont, k_active - 1, k),
        best_state=select(save, s, c.best_state),
        best_ll=torch.where(save, ll.to(dt), c.best_ll),
        best_riss=torch.where(save, riss, c.best_riss),
        log=log, step=c.step + 1, done=~cont, health=c.health + h_k,
        h_last=h_k)


class FusedSweep:
    """The sweep at one width: the EM program and the per-K step, captured
    on one CUDA device (``capture``) or run eagerly."""

    def __init__(self, em: EMProgram, state_like: GMMState, *, capture: bool,
                 pool=None, **static) -> None:
        self.em = em
        self.static = static
        self.captured = capture
        self.carry = self._carry0(state_like, None)
        if capture:
            # Static buffers, outside the graphs' pool (the EM carry holds
            # its warm-up values: any values do for warming up).
            self.carry = clone_tree(self.carry)
            self.graph = tl_profiling.site_compile(
                "fused_sweep", lambda: self._capture(pool),
                memory=lambda _: {"graph_pool_bytes": pool_bytes(pool)},
                width=int(state_like.num_clusters_padded))

    def _capture(self, pool) -> Captured:
        """The per-K step's graph (one ``fused_sweep`` compile event under
        an active compile watch)."""
        warm_up(self._k_step)
        return Captured(self._k_step_into_static, pool)

    def _carry0(self, state, resume) -> SweepCarry:
        """A fresh sweep position at ``state`` (or ``resume``'s)."""
        dev = state.N.device
        dt = state.means.dtype
        i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
        start_k = self.static["start_k"]
        c = SweepCarry(
            state=state, k=i64(start_k), best_state=state,
            best_ll=torch.zeros((), dtype=dt, device=dev),
            best_riss=torch.tensor(torch.inf, dtype=torch.float64,
                                   device=dev),
            log=torch.zeros((start_k, 5), dtype=torch.float64, device=dev),
            step=i64(0), done=torch.tensor(False, device=dev),
            health=torch.zeros(health.NUM_FLAGS, dtype=torch.int64,
                               device=dev),
            h_last=torch.zeros(health.NUM_FLAGS, dtype=torch.int64,
                               device=dev))
        if resume is not None:
            c.best_state = resume["best_state"].to(dev)
            c.k = i64(int(resume["k"]))
            c.best_ll = torch.tensor(float(resume["best_ll"]), dtype=dt,
                                     device=dev)
            c.best_riss = torch.tensor(float(resume["best_riss"]),
                                       dtype=torch.float64, device=dev)
            c.log = torch.as_tensor(resume["log"]).to(dtype=torch.float64,
                                                      device=dev)
            c.step = i64(int(resume["step"]))
        return c

    def _k_step(self) -> SweepCarry:
        return k_step(self.carry, self.em.carry, **self.static)

    def _k_step_into_static(self) -> None:
        new = self._k_step()
        copy_into(self.carry, new)
        # The next K's EM starts from the sweep's new state.
        copy_into(self.em.state_in, new.state)

    def run(self, state, epsilon: float, min_iters: int, max_iters: int,
            resume: Optional[dict] = None, *, nan_iter: Optional[int] = None,
            regression_scale: float = 10.0,
            emit_cb: Optional[Callable] = None, emit_light: bool = False):
        """The sweep from ``state`` (or ``resume``'s position): returns
        ``(best_state, best_ll, best_riss, log, steps, health)`` on the
        device."""
        start_k = self.static["start_k"]
        em = self.em
        em.ctrl.set(epsilon, min_iters, max_iters, nan_iter,
                    regression_scale, None)
        c0 = self._carry0(state, resume)
        if self.captured:
            copy_into(self.carry, c0)
            copy_into(em.state_in, state)
        else:
            self.carry = c0
            em.state_in = state
        step = int(c0.step)
        done = False
        while not done and step < start_k:
            em.start(None)
            em.drive(min_iters)
            if self.captured:
                self.graph.replay()
            else:
                self.carry = self._k_step()
                em.state_in = self.carry.state
            done = bool(self.carry.done.item())
            if emit_cb is not None:
                emit_cb(self._payload(step, emit_light))
            step += 1
        out = (self.carry.best_state, self.carry.best_ll,
               self.carry.best_riss, self.carry.log, self.carry.step,
               self.carry.health)
        # The static buffers belong to the program, which the next run
        # overwrites: a caller gets copies.
        return tuple(map(clone_tree, out)) if self.captured else out

    def _payload(self, step: int, light: bool) -> dict:
        """The host's view of a completed K (the JAX package's emission
        payload; ``light``: the step scalars only)."""
        c = self.carry
        if light:
            return dict(step=step, done=bool(c.done))
        row = c.log[step].tolist()
        return dict(
            step=step, k=int(row[0]), ll=row[1], iters=int(row[3]),
            state=c.state.to("cpu"), best_state=c.best_state.to("cpu"),
            best_ll=float(c.best_ll), best_riss=float(c.best_riss),
            log=c.log.cpu().numpy(), next_k=int(c.k), done=bool(c.done),
            health=c.h_last.cpu().numpy())


def fused_sweep(state, data_chunks, wts_chunks, epsilon, min_iters,
                max_iters, resume=None, *, model, start_k: int,
                stop_number: int, target_k: int, num_events: int,
                num_dimensions: int, emit_cb: Optional[Callable] = None,
                emit_light: bool = False):
    """Run the whole K-sweep on the device (``model``'s statistics,
    M-step and numerics; its EM program at the state's width).

    Returns ``(best_state, best_ll, best_riss, log, steps, health)``:
    ``log`` is a [start_k, 5] float64 tensor of per-K rows ``(k, loglik,
    score, em_iters, health_word)`` (rows beyond ``steps`` are zero; the
    JAX package keeps it in the data's dtype, which rounds a float32 run's
    scores: here they are the host sweep's, and a checkpoint's
    ``fused_log`` loads in either package) and
    ``health`` the sweep's summed int64 counter vector. A fatal per-K
    health word stops the sweep; a non-finite score never takes the best
    slot (``NONFINITE_SCORE`` counts it). ``resume`` restores a position
    an earlier run emitted: ``best_state``, ``k``, ``step``, ``best_ll``,
    ``best_riss``, ``log``. ``emit_cb``/``emit_light``: the module
    docstring.
    """
    cfg = model.config
    static = dict(start_k=int(start_k), stop_number=int(stop_number),
                  target_k=int(target_k), num_events=int(num_events),
                  num_dimensions=int(num_dimensions),
                  criterion=cfg.criterion,
                  covariance_type=cfg.covariance_type,
                  diag_only=cfg.diag_only)
    length = max(int(min_iters), int(max_iters), cfg.max_iters) + 1
    em = model.em_program(state, data_chunks, wts_chunks, num_events, length)
    cache = model.programs(data_chunks, wts_chunks, num_events)
    key = ("fused", state.num_clusters_padded, length,
           tuple(sorted(static.items())))
    sweep = cache.get(key)
    if sweep is None:
        sweep = cache[key] = FusedSweep(
            em, state, capture=model.captures,
            pool=model.graph_pool() if model.captures else None, **static)
    # One armed ``nan_loglik`` plan per fused program, firing in every K's
    # EM (the JAX package traces its EM body once into the sweep).
    inj = model.armed_fault(state, data_chunks, sweep="fused")
    return sweep.run(state, epsilon, min_iters, max_iters, resume,
                     nan_iter=None if inj is None else int(inj["iter"]),
                     regression_scale=cfg.health_regression_scale,
                     emit_cb=emit_cb, emit_light=emit_light)
