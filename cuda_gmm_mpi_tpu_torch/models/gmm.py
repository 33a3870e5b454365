"""GMM-EM model: the EM loop for a fixed (masked) cluster count.

The reference's EM while-loop (``gaussian.cu:479-755``) as a host loop that
reads the loglik once per iteration, as the reference does
(gaussian.cu:741-748). Loop semantics match ``gaussian.cu:525-755``:

  change = 2*epsilon (+1) initially (:525)
  while iters < MIN_ITERS or (|change| > epsilon and iters < MAX_ITERS): (:532)
      params  <- M-step(stats) + constants                  (:541-701)
      stats   <- fused E-step(params); loglik = stats.loglik (:713-741)
      change  = loglik - old_loglik                         (:748)

with ``|change| > epsilon`` spelled ``not (|change| <= epsilon)``, so a
non-finite change reads as not converged.

``em_while_loop_batched`` runs the same loop for a batch of restarts (a
state with a leading restart axis R) with per-lane bounds and masked
freeze-out: each lane iterates exactly as its own ``em_while_loop`` would.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import GMMConfig
from ..ops.estep import features, posteriors
from ..ops.mstep import SuffStats, accumulate_stats, apply_mstep, zeros_stats
from ..state import lane, stack_states, where_lanes


def resolve_device(config: GMMConfig) -> torch.device:
    """The torch device of an entry point. There is no silent fallback: a
    CUDA request on a machine without a GPU raises."""
    if config.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' (--device=cpu) to run on the CPU")
    return torch.device(config.device)


def setup_device(config: GMMConfig) -> torch.device:
    """:func:`resolve_device`; on CUDA, TF32 is turned off for the torch-ops
    products (matmul) and any cuDNN call, which then run in full fp32 at
    every ``matmul_precision``: 'high' and 'default' spell their bf16
    passes out themselves (ops/estep.py::kdot), as the kernels do
    (csrc/fused_stats.cu)."""
    device = resolve_device(config)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def resolve_iters_batched(config: GMMConfig, num_restarts: int,
                          min_iters, max_iters):
    """Per-restart iteration bounds as int64 [R] vectors (lo, hi).

    Scalars (or None -> the config's values) broadcast to every restart;
    [R] vectors pass through. lo is clamped to hi. A restart whose
    ``max_iters`` is 0 runs no EM iteration: the batched restart paths' handle
    for freezing a lane.
    """
    lo = config.min_iters if min_iters is None else min_iters
    hi = config.max_iters if max_iters is None else max_iters
    lo = np.broadcast_to(np.asarray(lo, np.int64), (num_restarts,))
    hi = np.broadcast_to(np.asarray(hi, np.int64), (num_restarts,))
    return np.minimum(lo, hi), hi.copy()


def lane_loop_stats(stats_fn: Callable, diag_only: bool = False) -> Callable:
    """A batched stats hook that runs the unbatched ``stats_fn`` lane by
    lane (the torch-ops backend of the batched loop); frozen lanes get zero
    statistics, as K3 gives them."""
    def batched(states, data_chunks, wts_chunks, lane_mask=None):
        R, K, D = states.means.shape
        live = [True] * R if lane_mask is None else lane_mask.tolist()
        return stack_states([
            stats_fn(lane(states, r), data_chunks, wts_chunks) if live[r]
            else zeros_stats(K, D, data_chunks.dtype, data_chunks.device,
                             diag_only=diag_only)
            for r in range(R)])

    return batched


def lane_loop_mstep(mstep_fn: Callable) -> Callable:
    """A batched M-step hook that runs the unbatched ``mstep_fn`` lane by
    lane (the torch-ops backend of the batched loop)."""
    def batched(states, stats):
        return stack_states([mstep_fn(lane(states, r), lane(stats, r))
                             for r in range(states.N.shape[0])])

    return batched


def chunk_events(data: np.ndarray, chunk_size: int, num_shards: int = 1,
                 num_chunks: Optional[int] = None,
                 sample_weight: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and reshape events to [num_chunks, chunk_size, D] plus a [num_chunks,
    chunk_size] weight row (1 for events, 0 for padding). The chunk count is
    padded to a multiple of ``num_shards`` (the data-axis size), so every
    data shard holds the same number of chunks.

    ``sample_weight`` ([n] nonnegative) replaces the 1s of the weight row
    (padding stays 0). Every statistic multiplies the posteriors and the
    log-evidence by this row, so an integer weight w equals replicating the
    event w times."""
    n, d = data.shape
    if sample_weight is not None and np.asarray(sample_weight).shape != (n,):
        raise ValueError(
            f"sample_weight must be [{n}], got "
            f"{np.asarray(sample_weight).shape}")
    if num_chunks is not None:
        total = num_chunks * chunk_size
        if total < n:
            raise ValueError(
                f"num_chunks={num_chunks} x chunk_size={chunk_size} < {n} events")
        if num_chunks % max(num_shards, 1):
            raise ValueError(
                f"num_chunks={num_chunks} not divisible by num_shards={num_shards}")
    else:
        step = chunk_size * num_shards
        total = n + ((-n) % step)
    padded = np.zeros((total, d), dtype=data.dtype)
    padded[:n] = data
    wts = np.zeros((total,), dtype=data.dtype)
    wts[:n] = 1.0 if sample_weight is None else sample_weight
    num_chunks = total // chunk_size
    return (padded.reshape(num_chunks, chunk_size, d),
            wts.reshape(num_chunks, chunk_size))


class GMMModel:
    """EM for a Gaussian mixture with fixed padded K; active clusters masked.

    ``estep_backend``/``estep_backend_reason`` name the statistics path that
    runs ('cuda' = kernels K1/K2, and K3/K4 for restart batches; 'torch' =
    torch ops) and why.
    """

    # Bucket widths must be a multiple of this (the cluster-axis size on
    # parallel.ShardedGMMModel).
    bucket_multiple = 1
    # The (data, cluster) mesh of parallel.ShardedGMMModel; None: one device.
    mesh = None

    def __init__(self, config: GMMConfig = GMMConfig(),
                 stats_fn: Optional[Callable] = None,
                 mstep_fn: Optional[Callable] = None):
        self.config = config
        self.device = setup_device(config)
        if stats_fn is None and mstep_fn is None:
            from ..ops.kernels import (
                make_batched_stats_fn, make_mstep_fn, make_stats_fn,
                resolve_estep_backend,
            )

            self.estep_backend, self.estep_backend_reason = \
                resolve_estep_backend(config)
            stats_fn = make_stats_fn(config)
            mstep_fn = make_mstep_fn(config)
            self.batched_stats_fn = make_batched_stats_fn(config)
            self.batched_mstep_fn = make_mstep_fn(config, batched=True)
        else:
            self.estep_backend = "custom"
            self.estep_backend_reason = "caller-supplied stats_fn/mstep_fn"
            self.batched_stats_fn = self.batched_mstep_fn = None
        self.stats_fn = stats_fn
        self.mstep_fn = mstep_fn
        diag_only = config.diag_only
        # The batched loop's hooks where no batched kernel serves: the
        # unbatched hooks (or torch ops) lane by lane.
        if self.batched_stats_fn is None:
            self.batched_stats_fn = lane_loop_stats(
                stats_fn or functools.partial(accumulate_stats,
                                              **self.numerics),
                diag_only=diag_only)
        if self.batched_mstep_fn is None:
            self.batched_mstep_fn = lane_loop_mstep(
                mstep_fn or functools.partial(
                    apply_mstep, diag_only=diag_only,
                    covariance_type=config.covariance_type))

    @property
    def numerics(self) -> dict:
        """The torch-ops E-step's switches from the config."""
        cfg = self.config
        return dict(diag_only=cfg.diag_only, quad_mode=cfg.quad_mode,
                    matmul_precision=cfg.matmul_precision)

    def place(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a tensor of the model's device and dtype."""
        return torch.as_tensor(np.asarray(array, self.config.dtype),
                               device=self.device)

    def run_em(self, state, data_chunks, wts_chunks, epsilon: float,
               min_iters: Optional[int] = None,
               max_iters: Optional[int] = None,
               n_events: Optional[int] = None):
        """Full EM at the current active K. Returns (state, loglik, iters).

        ``n_events`` (the real events, in front of the chunk grid's
        zero-weight padding) lets K1 skip the padding rows."""
        cfg = self.config
        stats_fn = self.stats_fn
        if n_events is not None and self.estep_backend == "cuda":
            stats_fn = functools.partial(stats_fn, n_events=n_events)
        return em_while_loop(
            state, data_chunks, wts_chunks, epsilon,
            cfg.min_iters if min_iters is None else min_iters,
            cfg.max_iters if max_iters is None else max_iters,
            stats_fn=stats_fn, mstep_fn=self.mstep_fn,
            precompute_features=cfg.precompute_features,
            covariance_type=cfg.covariance_type, **self.numerics)

    def run_em_batched(self, states, data_chunks, wts_chunks, epsilon: float,
                       min_iters=None, max_iters=None,
                       n_events: Optional[int] = None):
        """Full EM for a batch of restarts: ``states`` has a leading restart
        axis R on every leaf. Returns (states, loglik [R], iters [R]), the
        last two as numpy arrays.

        ``min_iters``/``max_iters`` take scalars or [R] vectors; a lane
        with ``max_iters=0`` is frozen: it runs no E-step, its state passes
        through untouched and its loglik is NaN. ``n_events`` as in
        :meth:`run_em`.
        """
        lo, hi = resolve_iters_batched(self.config, states.N.shape[0],
                                       min_iters, max_iters)
        stats_fn = self.batched_stats_fn
        if n_events is not None and self.estep_backend == "cuda":
            stats_fn = functools.partial(stats_fn, n_events=n_events)
        cfg = self.config
        # No unbatched stats_fn: the batched E-step is torch ops lane by lane.
        feats = (hoisted_features(
            data_chunks, precompute_features=cfg.precompute_features,
            diag_only=cfg.diag_only, quad_mode=cfg.quad_mode)
            if self.stats_fn is None else None)
        if feats is not None:
            stats_fn = lane_loop_stats(
                functools.partial(accumulate_stats, feats_chunks=feats,
                                  **self.numerics),
                diag_only=cfg.diag_only)
        return em_while_loop_batched(
            states, data_chunks, wts_chunks, epsilon, lo, hi,
            batched_stats_fn=stats_fn, mstep_fn=self.batched_mstep_fn)

    @property
    def inference_block(self) -> int:
        """Events per output-path step."""
        return self.config.chunk_size

    def infer_posteriors(self, state, xb):
        """(w [B, K], logZ [B]) for one block of events (torch-ops path)."""
        return posteriors(state, torch.as_tensor(xb, device=self.device),
                          **self.numerics)

    def memberships(self, state, data_chunks, return_logz: bool = False):
        """Posteriors [N_padded, K] recomputed from the final parameters
        (the loop ends on an E-step, so these are its memberships). Padded
        tail rows are garbage; callers slice to the true event count. With
        ``return_logz`` also the per-event log evidence [N_padded]."""
        return _memberships(self, state, data_chunks, return_logz)


def _memberships(model, state, data_chunks, return_logz: bool):
    """``memberships`` of a model with ``infer_posteriors``: the chunks'
    posteriors (and log evidence) copied to the host."""
    outs = [model.infer_posteriors(state, data_chunks[i])
            for i in range(data_chunks.shape[0])]
    w = np.concatenate([o[0].cpu().numpy() for o in outs], axis=0)
    if return_logz:
        return w, np.concatenate([o[1].cpu().numpy() for o in outs], axis=0)
    return w


def hoisted_features(data_chunks: torch.Tensor, *, precompute_features: bool,
                     diag_only: bool, quad_mode: str):
    """The [C, B, F] features of ``quad_mode`` for every chunk, when
    ``precompute_features`` applies to the torch-ops E-step (full
    covariance, 'expanded' or 'packed'); else None. Built by the same
    function the inline path calls on each chunk."""
    if (not precompute_features or diag_only
            or quad_mode not in ("expanded", "packed")):
        return None
    return torch.stack([features(c, quad_mode) for c in data_chunks])


def em_while_loop(state, data_chunks, wts_chunks, epsilon: float,
                  min_iters: int, max_iters: int, *, diag_only: bool = False,
                  quad_mode: str = "expanded",
                  matmul_precision: str = "highest",
                  precompute_features: bool = False,
                  stats_fn: Optional[Callable] = None,
                  mstep_fn: Optional[Callable] = None,
                  reduce_stats: Optional[Callable] = None,
                  cluster_group=None,
                  covariance_type: Optional[str] = None):
    """The per-K EM algorithm as a host loop. Returns (state, loglik, iters).

    ``stats_fn(state, data_chunks, wts_chunks) -> SuffStats`` replaces the
    torch-ops statistics pass (K1 rides this hook); ``mstep_fn(state,
    stats) -> state`` replaces ``apply_mstep`` (K2 + constants).
    ``reduce_stats(stats) -> SuffStats`` is applied to every E-step's
    statistics before the loglik is read (the data-axis all_reduce of a
    mesh, parallel/sharded_em.py); ``cluster_group`` is the process group
    of a sharded cluster axis, handed to the torch-ops E- and M-step.
    ``quad_mode`` and ``matmul_precision`` are the torch-ops E-step's
    switches; ``precompute_features`` hoists its [C, B, F] features out of
    the loop (built once here, when no ``stats_fn`` is bound, for full
    covariance in 'expanded'/'packed' mode, as the JAX package's loop
    does). ``covariance_type`` is the torch-ops M-step's family (None:
    'diag' or 'full' from ``diag_only``). The loglik and the change are
    computed in the data's dtype, as on the device in the reference, and
    read to the host once per iteration.
    """
    feats = None
    if stats_fn is None:
        feats = hoisted_features(
            data_chunks, precompute_features=precompute_features,
            diag_only=diag_only, quad_mode=quad_mode)

    def estep(s) -> SuffStats:
        if stats_fn is not None:
            stats = stats_fn(s, data_chunks, wts_chunks)
        else:
            stats = accumulate_stats(s, data_chunks, wts_chunks,
                                     diag_only=diag_only, quad_mode=quad_mode,
                                     matmul_precision=matmul_precision,
                                     cluster_group=cluster_group,
                                     feats_chunks=feats)
        return reduce_stats(stats) if reduce_stats is not None else stats

    def mstep(s, stats):
        if mstep_fn is not None:
            return mstep_fn(s, stats)
        return apply_mstep(s, stats, diag_only=diag_only,
                           cluster_group=cluster_group,
                           covariance_type=covariance_type)

    eps = float(torch.tensor(epsilon, dtype=data_chunks.dtype))
    stats = estep(state)  # initial E-step (gaussian.cu:487-516)
    ll = stats.loglik
    change = 2.0 * eps + 1.0  # :525
    iters = 0
    while iters < min_iters or (not abs(change) <= eps and iters < max_iters):
        state = mstep(state, stats)  # :541-701
        stats = estep(state)  # :713-741
        change = float(stats.loglik - ll)  # :748
        ll = stats.loglik
        iters += 1
    return state, float(ll), iters


def em_while_loop_batched(states, data_chunks, wts_chunks, epsilon: float,
                          min_iters_r, max_iters_r, *,
                          batched_stats_fn: Callable, mstep_fn: Callable):
    """EM for a batch of restarts as one host loop over the whole batch.

    The port of the JAX package's ``em_while_loop_batched``
    (models/gmm.py:1006-1144): each iteration runs the M-step on every
    lane (one K4 launch on the kernel path), then the E-step with the
    lanes still live as ``lane_mask`` (one K3 launch), and freezes every
    other lane's carry (state, statistics, loglik, change, iterations)
    with a per-lane ``where``. A lane is live while
    ``iters < lo | (~(|change| <= eps) & iters < hi)``, the per-lane
    spelling of :func:`em_while_loop`'s test, so each lane runs the
    iterations its own loop would. The [R] changes are read to the host
    once per iteration. A lane whose ``max_iters`` is 0 never runs: the
    initial E-step masks it too, and its loglik is NaN. Returns (states,
    loglik [R], iters [R]), the last two as numpy arrays.
    """
    lo = np.asarray(min_iters_r, np.int64)
    hi = np.asarray(max_iters_r, np.int64)
    eps = float(torch.tensor(epsilon, dtype=data_chunks.dtype))
    runs = torch.as_tensor(hi > 0, device=data_chunks.device)
    stats = batched_stats_fn(states, data_chunks, wts_chunks,
                             lane_mask=runs)  # gaussian.cu:487-516
    ll = torch.where(runs, stats.loglik, torch.nan)
    change = np.full(lo.shape, 2.0 * eps + 1.0)  # gaussian.cu:525
    iters = np.zeros(lo.shape, np.int64)
    while True:
        live = (iters < lo) | (~(np.abs(change) <= eps) & (iters < hi))
        if not live.any():
            break
        live_t = torch.as_tensor(live, device=ll.device)
        new_states = mstep_fn(states, stats)  # :541-701
        new_stats = batched_stats_fn(new_states, data_chunks, wts_chunks,
                                     lane_mask=live_t)  # :713-741
        step = (new_stats.loglik - ll).cpu().numpy()  # :748
        states = where_lanes(live_t, new_states, states)
        stats = where_lanes(live_t, new_stats, stats)
        ll = torch.where(live_t, new_stats.loglik, ll)
        change = np.where(live, step.astype(np.float64), change)
        iters = iters + live
    return states, ll.cpu().numpy().astype(np.float64), iters
