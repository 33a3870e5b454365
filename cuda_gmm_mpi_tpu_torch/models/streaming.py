"""Out-of-core EM: the events stream through the device block by block.

The port of the JAX package's ``models/streaming.py``. ``GMMModel`` uploads
the whole chunk grid once; here the chunks stay on the host (a resident
numpy array, or with ``ingest='pipelined'`` a
:class:`~..io.pipeline.PipelinedBlockSource` that reads them from the file
on a worker thread) and every E-step pass streams them through the device
one chunk (one block) at a time. The device holds two blocks and the
statistics, so N is bounded by host memory, or by the disk.

Per block, on the card at float32 under the routing table
(ops/kernels/__init__.py), the statistics are one K1 launch on that block's
``[B, D]`` rows, with K1's parameter operands prepared once per pass; each
M-step is one K2 launch (full/diag; 'spherical'/'tied' keep the torch-ops
``apply_mstep``). On the CPU and at float64 the torch-ops ``chunk_stats``
runs per block. The blocks add, in block order, into one accumulator on
the device (in place), so the float64 trajectory is the in-memory path's
(and the JAX package's streaming one) to summation-order noise.

Copy and compute overlap on the card: two pinned host buffers and two
device buffers of one block, reused for the whole fit. Block j+1 is copied
into a pinned buffer (after that buffer's previous copy finished) and onto
the device on a side stream while the card computes block j; the compute
stream waits on the copy's event, and the side stream on the event of the
last launch that read the device buffer. (A pageable ``.to('cuda',
non_blocking=True)`` would be synchronous and overlap nothing.)

The EM loop is host-driven by design: one pass per iteration, its loglik
read on the host, no CUDA-graph capture (``GMMModel.em_program`` is not
taken), no fused sweep, no batched restarts (``n_init`` runs the inits one
after another). Loop semantics and health counting are the JAX package's
streaming loop's: the loglik lanes per pass, the state lanes once at exit.
``em_mode='minibatch'`` runs stepwise EM (Cappe & Moulines 2009) on the
same block loop.

Supervision: ``should_stop`` is asked before every pass (every step in
minibatch mode) and ``block_stop(pass, block)`` after every block but a
pass's last, so a stop loses at most one block: the partial accumulator
rides the emergency sub-step (``stream_pass``/``stream_block``/
``stream_acc``; ``mb_step``/``mb_cursor``/``mb_acc`` for stepwise EM) and
the resumed run continues bit for bit.

On a data mesh ``(S, 1)`` (one rank per data index) each rank streams its
``host_chunk_bounds`` slice and one all_reduce over the data group sums
the pass's accumulator (the in-memory sharded model's reduction); a stop
rounds up to the pass boundary there, since the partial accumulators are
per rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import health, telemetry
from ..config import GMMConfig
from ..ops.mstep import SuffStats, apply_mstep, chunk_stats
from ..state import compact_to
from ..testing import faults
from .gmm import GMMModel


class _StreamPreempt(Exception):
    """A stop inside a pass: the partial block accumulator (before the
    mesh reduction), the next block to process and the pass index."""

    def __init__(self, acc, next_block: int, pass_idx: int):
        super().__init__(f"stream pass {pass_idx} stopped before block "
                         f"{next_block}")
        self.acc = acc
        self.next_block = next_block
        self.pass_idx = pass_idx


def _add_(acc: SuffStats, s: SuffStats) -> SuffStats:
    """``acc += s`` leaf by leaf, in place (the JAX package's donated
    ``_add``)."""
    for f in dataclasses.fields(acc):
        getattr(acc, f.name).add_(getattr(s, f.name))
    return acc


def _stats_to_host(stats: SuffStats) -> dict:
    return {f.name: getattr(stats, f.name).cpu().numpy()
            for f in dataclasses.fields(stats)}


class _Staging:
    """Two pinned host buffers and two device buffers of one block
    ([B, D] events, [B] weights) and a side stream for the copies."""

    def __init__(self, B: int, D: int, dtype: torch.dtype,
                 device: torch.device):
        self.shape = (B, D, dtype)
        self.x_host = [torch.empty((B, D), dtype=dtype, pin_memory=True)
                       for _ in range(2)]
        self.w_host = [torch.empty((B,), dtype=dtype, pin_memory=True)
                       for _ in range(2)]
        self.x_dev = [torch.empty((B, D), dtype=dtype, device=device)
                      for _ in range(2)]
        self.w_dev = [torch.empty((B,), dtype=dtype, device=device)
                      for _ in range(2)]
        self.stream = torch.cuda.Stream(device)
        for t in self.x_dev + self.w_dev:
            t.record_stream(self.stream)
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.consumed = [torch.cuda.Event() for _ in range(2)]
        self.used = [False, False]

    def put(self, slot: int, x: np.ndarray, w: np.ndarray) -> None:
        """Copy one host block into pinned buffer ``slot`` and onto the
        device on the side stream."""
        if self.used[slot]:
            self.copied[slot].synchronize()  # the pinned buffer is free
        np.copyto(self.x_host[slot].numpy(), x)
        np.copyto(self.w_host[slot].numpy(), w)
        with torch.cuda.stream(self.stream):
            if self.used[slot]:
                # The last launch that read this device buffer is done.
                self.stream.wait_event(self.consumed[slot])
            self.x_dev[slot].copy_(self.x_host[slot], non_blocking=True)
            self.w_dev[slot].copy_(self.w_host[slot], non_blocking=True)
            self.copied[slot].record(self.stream)
        self.used[slot] = True

    def take(self, slot: int):
        """The device block of ``slot``, once its copy has landed (the
        compute stream waits on the copy's event)."""
        torch.cuda.current_stream().wait_event(self.copied[slot])
        return self.x_dev[slot], self.w_dev[slot]

    def release(self, slot: int) -> None:
        """Mark the launches enqueued so far as the buffer's last readers."""
        self.consumed[slot].record(torch.cuda.current_stream())

    def close(self) -> None:
        self.stream.synchronize()


class StreamingGMMModel(GMMModel):
    """``GMMModel`` with host-resident (or file-resident) chunks and a
    host-driven, block-streaming EM loop. ``mesh`` (or ``mesh_shape``, or
    a world of more than one rank) makes it one rank of a data mesh
    ``(S, 1)``. ``_sync_copy`` (tests and chip_smoke.py) copies each block
    with a plain synchronous ``.to(device)`` instead of the double
    buffer."""

    supports_fused_emit = False
    make_fused_sweep = None  # the sweep's data is not on the device
    supports_batched_restarts = False
    # No single EM program to map a fleet's tenants over (the JAX package's
    # StreamingGMMModel.supports_fleet).
    supports_fleet = False
    streams = True

    def __init__(self, config: GMMConfig = GMMConfig(), mesh=None, *,
                 _sync_copy: bool = False):
        from ..parallel import distributed

        super().__init__(config)
        self.mesh = None
        self._reduce = None
        if (mesh is not None or config.mesh_shape is not None
                or distributed.world_size() > 1):
            from ..parallel.mesh import make_mesh
            from ..parallel.sharded_em import make_psum_reduce

            mesh = mesh if mesh is not None else make_mesh(config.mesh_shape)
            if mesh.cluster_size != 1:
                raise ValueError("stream_events shards events only; the "
                                 "cluster mesh axis must be 1")
            self.mesh = mesh
            self._reduce = make_psum_reduce(mesh.data_group)
        self.collective_backend = distributed.backend() or "none"
        self._sync_copy = _sync_copy
        self._staging: Optional[_Staging] = None
        self._k_cols = None
        self._n_local = None
        self._pass_index = 0
        # Per-iteration (per-step) wall seconds of the latest run, measured
        # on the host loop.
        self.last_iter_seconds: list = []

    # -- the GMMModel/ShardedGMMModel surface order_search drives -----------

    @property
    def captures(self) -> bool:
        return False

    def place(self, array) -> np.ndarray:
        """The chunk grid stays on the host, in the compute dtype."""
        return np.ascontiguousarray(array, dtype=np.dtype(self.config.dtype))

    def prepare_state(self, state):
        self._k_cols = state.num_clusters_padded
        return state.to(self.device)

    def gather_state(self, state):
        return state  # the clusters are not sharded

    def rebucket_state(self, full_state, num_clusters: int):
        if num_clusters < full_state.num_clusters_padded:
            full_state = compact_to(full_state, num_clusters)
        return self.prepare_state(full_state)

    def assert_same_merge(self, k_active: int, pair) -> None:
        from ..parallel.sharded_em import ShardedGMMModel

        ShardedGMMModel.assert_same_merge(self, k_active, pair)

    def release_programs(self) -> None:
        super().release_programs()
        if self._staging is not None:
            self._staging.close()
            self._staging = None

    # -- one block's statistics -------------------------------------------

    def _block_stats(self, state) -> Callable:
        """``f(x [B, D], w [B], rows) -> SuffStats`` under ``state`` for this
        pass. On the kernel route K1's parameter operands are prepared here,
        once per pass, and each call is one K1 launch on the block's first
        ``rows`` rows (the rest are padding of weight 0); else the torch-ops
        ``chunk_stats`` on the whole block."""
        cfg = self.config
        if self.estep_backend == "cuda":
            from ..ops.kernels import fused_stats as fs

            K, d = state.means.shape
            diag = cfg.diag_only
            A, h, g = fs._prep_params(state, d, diag)

            def stats(x, w, rows):
                ll, nk, m1, m2 = fs.fused_stats(
                    x[:rows], w[:rows], A, h, g, diag=diag,
                    block_b=cfg.pallas_block_b,
                    precision=cfg.matmul_precision)
                dt = x.dtype
                return SuffStats(
                    loglik=ll[0, 0].to(dt), Nk=nk[0].to(dt), M1=m1.to(dt),
                    M2=(m2 if diag else m2.reshape(K, d, d)).to(dt))
            return stats
        kw = self.numerics
        return lambda x, w, rows: chunk_stats(state, x, w, **kw)

    def _mstep(self, state, stats: SuffStats):
        """One M-step: K2 on the kernel route (full/diag), else torch ops."""
        if self.mstep_fn is not None:
            return self.mstep_fn(state, stats)
        return apply_mstep(state, stats, diag_only=self.config.diag_only,
                           covariance_type=self.config.covariance_type)

    def _state_counts(self, state, Nk) -> np.ndarray:
        c = health.state_counts(
            state, Nk=Nk, dynamic_range=self.config.covariance_dynamic_range)
        return np.rint(c.cpu().numpy()).astype(np.int64)

    # -- the block stream --------------------------------------------------

    @staticmethod
    def _num_blocks(chunks) -> int:
        return (chunks.num_blocks if hasattr(chunks, "get_block")
                else int(chunks.shape[0]))

    def _rows(self, j: int, B: int) -> int:
        """Real rows of block j (at least 1: a block of padding still
        hands K1 a row, of weight 0)."""
        if self._n_local is None:
            return B
        return min(max(self._n_local - j * B, 1), B)

    def _host_block(self, chunks, wts, j: int):
        """Block j on the host (events, weights, the ingestion wait), after
        an armed ``poison_block`` fault."""
        if hasattr(chunks, "get_block"):
            x, w = chunks.get_block(j)
            wait = chunks.last_wait_s
        else:
            x, w, wait = chunks[j], wts[j], 0.0
        x, w = faults.maybe_poison_block(x, w, j)
        return x, w, wait

    def _stream(self, chunks, wts, js):
        """Yield ``(j, x, w, wait_s, nbytes)`` for the blocks ``js`` on the
        model's device. On the card (unless ``_sync_copy``) block j+1's
        copy is enqueued after block j's launches, which the consumer makes
        before it asks for the next block."""
        js = list(js)
        if not js:
            return
        dev = self.device
        if dev.type != "cuda" or self._sync_copy:
            for j in js:
                x, w, wait = self._host_block(chunks, wts, j)
                x = np.ascontiguousarray(x)
                w = np.ascontiguousarray(w)
                yield (j, torch.as_tensor(x).to(dev),
                       torch.as_tensor(w).to(dev), wait,
                       int(x.nbytes) + int(w.nbytes))
            return
        _, B, D = chunks.shape
        dt = getattr(torch, self.config.dtype)
        if self._staging is None or self._staging.shape != (B, D, dt):
            if self._staging is not None:
                self._staging.close()
            self._staging = _Staging(B, D, dt, dev)
        st = self._staging
        x, w, wait = self._host_block(chunks, wts, js[0])
        nbytes = int(x.nbytes) + int(w.nbytes)
        st.put(0, x, w)
        for i, j in enumerate(js):
            slot = i % 2
            xd, wd = st.take(slot)
            try:
                yield j, xd, wd, wait, nbytes
            finally:  # also when the consumer stops inside the pass
                st.release(slot)
            if i + 1 < len(js):
                x, w, wait = self._host_block(chunks, wts, js[i + 1])
                nbytes = int(x.nbytes) + int(w.nbytes)
                st.put((i + 1) % 2, x, w)

    def _stream_stats(self, state, chunks, wts, js, emit_iter: int,
                      stop_check=None, acc=None):
        """The accumulated statistics of blocks ``js`` (in order) under
        ``state``, one ``chunk_flush`` record and ``h2d_bytes`` count per
        block on an active recorder; ``stop_check(j)`` after each block may
        raise :class:`_StreamPreempt`."""
        rec = telemetry.current()
        emit = rec.active
        stats = self._block_stats(state)
        B = int(chunks.shape[1])
        for j, x, w, wait, nbytes in self._stream(chunks, wts, js):
            t0 = time.perf_counter()
            s = stats(x, w, self._rows(j, B))
            acc = s if acc is None else _add_(acc, s)
            compute_s = time.perf_counter() - t0
            if emit:
                # iter is the pass (0 = the initial E-step) or the step;
                # prefetch_wait_s/compute_s split the block's host wall.
                rec.metrics.count("h2d_bytes", nbytes)
                rec.emit("chunk_flush", iter=int(emit_iter), block=int(j),
                         chunks=1, bytes=nbytes,
                         prefetch_wait_s=round(wait, 6),
                         compute_s=round(compute_s, 6))
                rec.heartbeat("stream")
            if stop_check is not None:
                stop_check(j, acc)
        return acc

    def _estep_all(self, state, chunks, wts, *, stop_check=None,
                   start_block: int = 0, acc0=None):
        """One full pass, block by block, then the mesh reduction.
        ``stop_check(pass, block)`` is asked after every block but the last;
        a stop raises :class:`_StreamPreempt` with the partial accumulator.
        ``start_block``/``acc0`` continue such a pass: the restored
        accumulator stands for the blocks before ``start_block``, so the
        addition order, and the statistics, are the uninterrupted pass's."""
        blocks = self._num_blocks(chunks)
        pass_idx, self._pass_index = self._pass_index, self._pass_index + 1

        def check(j, acc):
            if (stop_check is not None and j + 1 < blocks
                    and stop_check(pass_idx, j)):
                raise _StreamPreempt(acc, j + 1, pass_idx)

        acc = self._stream_stats(state, chunks, wts,
                                 range(start_block, blocks), pass_idx,
                                 stop_check=check, acc=acc0)
        return acc if self._reduce is None else self._reduce(acc)

    def _restore_stats(self, saved: dict) -> SuffStats:
        """A checkpointed accumulator on the device, in the compute dtype
        (the JAX package writes ``sanitized`` as int32)."""
        dt = getattr(torch, self.config.dtype)
        return SuffStats(**{k: torch.as_tensor(np.asarray(v)).to(
            device=self.device, dtype=dt) for k, v in saved.items()})

    # -- stepwise EM --------------------------------------------------------

    def _minibatch_setup(self, chunks, wts):
        """(blocks, blocks per step, W_total): ``W_total`` the global event
        weight (an all-gather over the world on a mesh)."""
        from ..parallel import distributed

        blocks = self._num_blocks(chunks)
        events_per_block = self.config.chunk_size * (
            1 if self.mesh is None else self.mesh.data_size)
        mb = int(self.config.minibatch_size)
        mb_blocks = max(1, -(-mb // events_per_block)) if mb > 0 else 1
        mb_blocks = min(mb_blocks, blocks)
        if hasattr(chunks, "get_block"):
            w_local = float(chunks.total_weight)
        else:
            w_local = float(np.asarray(wts, np.float64).sum())
        if distributed.world_size() > 1:
            w_local = float(distributed.allgather_host(
                np.asarray([w_local], np.float64)).sum())
        return blocks, mb_blocks, w_local

    def _minibatch_core(self, state, chunks, wts, epsilon, lo, hi, *,
                        should_stop=None, resume=None):
        """The stepwise-EM loop: each step streams ``mb_blocks`` blocks from
        the cursor (wrapping), folds their statistics into the running
        estimate ``S <- (1 - gamma_t) S + gamma_t scale s`` with ``gamma_t =
        (t + t0) ** -alpha`` and ``scale = W_total / W_batch`` (the batch
        rescaled to the full weight, so the absolute Nk thresholds keep
        their meaning), in the statistics' dtype, and runs the M-step on
        it. The step's loglik is the proxy ``scale * batch loglik``; one
        full pass at the end gives the true loglik and the exit health
        check. A stop's payload is ``mb_step``/``mb_cursor``/``mb_acc``.
        Returns ``(state, lls, steps, counts, stopped, extra)``."""
        counts = np.zeros((health.NUM_FLAGS,), np.int64)
        reg_tol = float(self.config.health_regression_scale) * float(epsilon)
        eps_f = abs(float(epsilon))
        blocks, mb_blocks, w_total = self._minibatch_setup(chunks, wts)
        t0_decay = float(self.config.minibatch_t0)
        alpha = float(self.config.minibatch_alpha)
        dt = getattr(torch, self.config.dtype)

        def observe(ll, ll_prev=None):
            if not np.isfinite(ll):
                counts[health.NONFINITE_LOGLIK] += 1
                return True
            if ll_prev is not None and np.isfinite(ll_prev) \
                    and ll < ll_prev - reg_tol:
                counts[health.LOGLIK_REGRESSION] += 1
            return False

        resume = resume or {}
        running = None
        cursor, t = 0, 0
        lls: list = []
        if "mb_step" in resume:
            cursor = int(resume["mb_cursor"])
            t = int(resume["mb_step"])
            lls = [float(x) for x in
                   np.asarray(resume.get("em_lls", ())).reshape(-1)]
            if "mb_acc" in resume:  # absent only for a stop at step 0
                running = self._restore_stats(resume["mb_acc"])
        ll_old = lls[-1] if lls else None
        change = (lls[-1] - lls[-2]) if len(lls) >= 2 \
            else abs(2.0 * eps_f) + 1.0
        fatal = False
        inj = faults.peek("nan_loglik")  # consumed at run time
        while not fatal and (
                t < lo or (not abs(change) <= eps_f and t < hi)):
            if should_stop is not None and should_stop(t):
                extra = {"mb_step": int(t), "mb_cursor": int(cursor)}
                if running is not None:
                    extra["mb_acc"] = _stats_to_host(running)
                return state, lls, t, counts, True, extra
            t_wall = time.perf_counter()
            js = [(cursor + i) % blocks for i in range(mb_blocks)]
            s_batch = self._stream_stats(state, chunks, wts, js, t)
            if self._reduce is not None:
                s_batch = self._reduce(s_batch)
            cursor = (cursor + mb_blocks) % blocks
            counts[health.SANITIZED_LANES] += int(s_batch.sanitized)
            w_batch = float(torch.sum(s_batch.Nk))
            if w_batch <= 0.0:
                # A minibatch of padding: nothing to learn from.
                self.last_iter_seconds.append(time.perf_counter() - t_wall)
                t += 1
                continue
            scale = w_total / w_batch
            ll = float(s_batch.loglik) * scale
            if inj is not None and t + 1 == int(inj["iter"]) \
                    and faults.take("nan_loglik") is not None:
                ll = float("nan")
            sc = torch.tensor(scale, dtype=dt, device=self.device)
            if running is None:
                running = SuffStats(*(sc * getattr(s_batch, f.name)
                                      for f in dataclasses.fields(s_batch)
                                      if f.name != "sanitized"),
                                    sanitized=s_batch.sanitized)
            else:
                g = torch.tensor((float(t) + t0_decay) ** (-alpha),
                                 dtype=dt, device=self.device)

                def blend(a, b):
                    return (1.0 - g) * a + g * (sc * b)

                running = SuffStats(
                    blend(running.loglik, s_batch.loglik),
                    blend(running.Nk, s_batch.Nk),
                    blend(running.M1, s_batch.M1),
                    blend(running.M2, s_batch.M2), s_batch.sanitized)
            state = self._mstep(state, running)
            fatal = observe(ll, ll_old)
            self.last_iter_seconds.append(time.perf_counter() - t_wall)
            lls.append(ll)
            change = ll - ll_old if ll_old is not None \
                else abs(2.0 * eps_f) + 1.0
            ll_old = ll
            t += 1
        if fatal:
            if running is not None:
                counts[:] += self._state_counts(state, running.Nk)
            return state, lls, t, counts, False, {}
        # The true final loglik and the exit health check: one full pass,
        # its chunk_flush records at iter = t.
        self._pass_index = t
        stats = self._estep_all(state, chunks, wts)
        ll_final = float(stats.loglik)
        counts[health.SANITIZED_LANES] += int(stats.sanitized)
        if not np.isfinite(ll_final):
            counts[health.NONFINITE_LOGLIK] += 1
        lls.append(ll_final)
        counts[:] += self._state_counts(state, stats.Nk)
        return state, lls, t, counts, False, {}

    # -- the EM loop ----------------------------------------------------------

    def run_em(self, state, data_chunks, wts_chunks, epsilon: float,
               min_iters: Optional[int] = None,
               max_iters: Optional[int] = None,
               n_events: Optional[int] = None, *, sweep: bool = False):
        """Full EM (or stepwise EM) at the current K over the streamed
        blocks. Returns (state, loglik, iters); the health counters land on
        ``last_health``, the loglik trajectory on ``last_lls`` and the
        measured per-iteration seconds on ``last_iter_seconds``."""
        state, ll, iters, _, _, _ = self.run_em_resumable(
            state, data_chunks, wts_chunks, epsilon, min_iters, max_iters,
            n_events=n_events, sweep=sweep)
        return state, ll, iters

    def _set_local_rows(self, chunks, n_events: Optional[int]) -> None:
        if hasattr(chunks, "get_block"):
            self._n_local = int(chunks.stop - chunks.start)
        elif n_events is None:
            self._n_local = None
        else:
            rows = int(chunks.shape[0]) * int(chunks.shape[1])
            lo = (0 if self.mesh is None else self.mesh.data_index) * rows
            self._n_local = min(max(int(n_events) - lo, 0), rows)

    def run_em_resumable(self, state, data_chunks, wts_chunks, epsilon,
                         min_iters: Optional[int] = None,
                         max_iters: Optional[int] = None,
                         n_events: Optional[int] = None, *,
                         sweep: bool = False, poll_iters: int = 25,
                         should_stop=None, block_stop=None,
                         resume: Optional[dict] = None):
        """The streaming loop under a run supervisor (the JAX package's
        ``StreamingGMMModel.run_em_resumable``): ``should_stop(done)``
        before every pass (every pass is a host round trip already, so
        ``poll_iters`` is not used), ``block_stop(pass, block)`` after every
        block but a pass's last (one device only; on a mesh a stop rounds
        up to the pass boundary). ``resume`` takes the in-memory keys
        (``em_iter``/``em_lls``: one recomputed pass rebuilds the
        statistics the next M-step needs, bit for bit) and the streaming
        ones (``stream_pass``/``stream_block``/``stream_acc``, and
        ``mb_step``/``mb_cursor``/``mb_acc`` for stepwise EM). Returns
        (state, loglik, iters, lls, stopped, extra)."""
        cfg = self.config
        lo = int(cfg.min_iters if min_iters is None else min_iters)
        hi = int(cfg.max_iters if max_iters is None else max_iters)
        self.last_iter_seconds = []
        self._set_local_rows(data_chunks, n_events)
        chunks, wts = data_chunks, wts_chunks
        if cfg.em_mode == "minibatch":
            self._pass_index = 0
            state, lls, iters, counts, stopped, extra = self._minibatch_core(
                state, chunks, wts, epsilon, lo, hi,
                should_stop=should_stop, resume=resume)
            if stopped:
                extra = dict(extra, em_lls=np.asarray(lls, np.float64))
            self.last_health, self.last_lls = counts, lls
            ll_out = lls[-1] if lls else float("nan")
            return state, ll_out, iters, lls, stopped, extra

        counts = np.zeros((health.NUM_FLAGS,), np.int64)
        reg_tol = float(cfg.health_regression_scale) * float(epsilon)
        eps_f = abs(float(epsilon))

        def observe(ll, ll_prev=None):
            if not np.isfinite(ll):
                counts[health.NONFINITE_LOGLIK] += 1
                return True
            if ll_prev is not None and np.isfinite(ll_prev) \
                    and ll < ll_prev - reg_tol:
                counts[health.LOGLIK_REGRESSION] += 1
            return False

        bstop = block_stop if self.mesh is None else None

        def stop_payload(sp: _StreamPreempt) -> dict:
            return {"stream_pass": int(sp.pass_idx),
                    "stream_block": int(sp.next_block),
                    "stream_acc": _stats_to_host(sp.acc)}

        def finish(state, stopped, extra, lls, iters, stats=None):
            if stats is not None:
                counts[:] += self._state_counts(state, stats.Nk)
            if stopped:
                extra = dict(extra, em_lls=np.asarray(lls, np.float64))
            self.last_health, self.last_lls = counts, lls
            ll_out = lls[-1] if lls else float("nan")
            return state, ll_out, iters, lls, stopped, extra

        lls: list = []
        iters = 0
        resume = resume or {}
        try:
            if "stream_acc" in resume:
                # The saved state is the one the interrupted pass p was
                # scanning (after its M-step): continue from its first
                # unprocessed block.
                p = int(resume["stream_pass"])
                self._pass_index = p
                lls = [float(x) for x in
                       np.asarray(resume.get("em_lls", ())).reshape(-1)]
                iters = max(p - 1, 0)
                stats = self._estep_all(
                    state, chunks, wts, stop_check=bstop,
                    start_block=int(resume["stream_block"]),
                    acc0=self._restore_stats(resume["stream_acc"]))
            elif resume:
                # A stop at a pass boundary: the saved state is iteration
                # ``em_iter``'s, and one pass rebuilds its statistics.
                iters = int(resume.get("em_iter", 0))
                lls = [float(x) for x in
                       np.asarray(resume.get("em_lls", ())).reshape(-1)]
                self._pass_index = iters
                stats = self._estep_all(state, chunks, wts, stop_check=bstop)
            else:
                self._pass_index = 0
                stats = self._estep_all(state, chunks, wts, stop_check=bstop)
        except _StreamPreempt as sp:
            return finish(state, True, stop_payload(sp), lls, iters)

        if "stream_acc" in resume and int(resume["stream_pass"]) > 0:
            # The resumed pass was iteration p: its loglik goes in now.
            p = int(resume["stream_pass"])
            ll = float(stats.loglik)
            counts[health.SANITIZED_LANES] += int(stats.sanitized)
            fatal = observe(ll, lls[-1] if lls else None)
            lls.append(ll)
            iters = p
        elif not lls:  # a fresh run, or a resumed pass 0
            ll0 = float(stats.loglik)
            counts[health.SANITIZED_LANES] += int(stats.sanitized)
            fatal = observe(ll0)
            lls = [ll0]
        else:
            # A boundary resume: lls ends with this pass's loglik already.
            counts[health.SANITIZED_LANES] += int(stats.sanitized)
            fatal = observe(lls[-1])
        ll_old = lls[-1]
        change = (lls[-1] - lls[-2]) if len(lls) >= 2 \
            else abs(2.0 * eps_f) + 1.0

        inj = faults.peek("nan_loglik")  # consumed at run time
        while not fatal and (
                iters < lo or (not abs(change) <= eps_f and iters < hi)):
            if should_stop is not None and should_stop(iters):
                return finish(state, True, {}, lls, iters, stats)
            t0 = time.perf_counter()
            state = self._mstep(state, stats)
            try:
                stats = self._estep_all(state, chunks, wts, stop_check=bstop)
            except _StreamPreempt as sp:
                return finish(state, True, stop_payload(sp), lls, iters)
            ll = float(stats.loglik)
            if inj is not None and iters + 1 == int(inj["iter"]) \
                    and faults.take("nan_loglik") is not None:
                ll = float("nan")
            counts[health.SANITIZED_LANES] += int(stats.sanitized)
            fatal = observe(ll, ll_old)
            self.last_iter_seconds.append(time.perf_counter() - t0)
            lls.append(ll)
            change, ll_old = ll - ll_old, ll
            iters += 1
        return finish(state, False, {}, lls, iters, stats)
