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
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import GMMConfig
from ..ops.estep import posteriors
from ..ops.mstep import SuffStats, accumulate_stats, apply_mstep


def resolve_device(config: GMMConfig) -> torch.device:
    """The torch device of an entry point. There is no silent fallback: a
    CUDA request on a machine without a GPU raises."""
    if config.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' (--device=cpu) to run on the CPU")
    return torch.device(config.device)


def chunk_events(data: np.ndarray, chunk_size: int,
                 num_chunks: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pad and reshape events to [num_chunks, chunk_size, D] plus a [num_chunks,
    chunk_size] weight row (1 for events, 0 for padding)."""
    n, d = data.shape
    if num_chunks is not None:
        total = num_chunks * chunk_size
        if total < n:
            raise ValueError(
                f"num_chunks={num_chunks} x chunk_size={chunk_size} < {n} events")
    else:
        total = n + ((-n) % chunk_size)
    padded = np.zeros((total, d), dtype=data.dtype)
    padded[:n] = data
    wts = np.zeros((total,), dtype=data.dtype)
    wts[:n] = 1.0
    num_chunks = total // chunk_size
    return (padded.reshape(num_chunks, chunk_size, d),
            wts.reshape(num_chunks, chunk_size))


class GMMModel:
    """EM for a Gaussian mixture with fixed padded K; active clusters masked.

    ``estep_backend``/``estep_backend_reason`` name the statistics path that
    runs ('cuda' = kernels K1/K2, 'torch' = torch ops) and why.
    """

    def __init__(self, config: GMMConfig = GMMConfig(),
                 stats_fn: Optional[Callable] = None,
                 mstep_fn: Optional[Callable] = None):
        self.config = config
        self.device = resolve_device(config)
        if config.matmul_precision != "highest":
            raise ValueError(
                f"matmul_precision={config.matmul_precision!r} is not ported "
                "yet: only 'highest' (plain fp32/fp64 products) is")
        if self.device.type == "cuda":
            # 'highest' means no TF32 anywhere: the torch-ops products
            # (matmul) and any cuDNN call run in full fp32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if stats_fn is None and mstep_fn is None:
            from ..ops.kernels import (
                make_mstep_fn, make_stats_fn, resolve_estep_backend,
            )

            self.estep_backend, self.estep_backend_reason = \
                resolve_estep_backend(config)
            stats_fn = make_stats_fn(config)
            mstep_fn = make_mstep_fn(config)
        else:
            self.estep_backend = "custom"
            self.estep_backend_reason = "caller-supplied stats_fn/mstep_fn"
        self.stats_fn = stats_fn
        self.mstep_fn = mstep_fn

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
            diag_only=cfg.diag_only, stats_fn=stats_fn,
            mstep_fn=self.mstep_fn)

    @property
    def inference_block(self) -> int:
        """Events per output-path step."""
        return self.config.chunk_size

    def infer_posteriors(self, state, xb):
        """(w [B, K], logZ [B]) for one block of events (torch-ops path)."""
        return posteriors(state, torch.as_tensor(xb, device=self.device),
                          diag_only=self.config.diag_only)

    def memberships(self, state, data_chunks) -> np.ndarray:
        """Posteriors [N_padded, K] recomputed from the final parameters
        (the loop ends on an E-step, so these are its memberships). Padded
        tail rows are garbage; callers slice to the true event count."""
        return np.concatenate(
            [self.infer_posteriors(state, data_chunks[i])[0].cpu().numpy()
             for i in range(data_chunks.shape[0])], axis=0)


def em_while_loop(state, data_chunks, wts_chunks, epsilon: float,
                  min_iters: int, max_iters: int, *, diag_only: bool = False,
                  stats_fn: Optional[Callable] = None,
                  mstep_fn: Optional[Callable] = None):
    """The per-K EM algorithm as a host loop. Returns (state, loglik, iters).

    ``stats_fn(state, data_chunks, wts_chunks) -> SuffStats`` replaces the
    torch-ops statistics pass (K1 rides this hook); ``mstep_fn(state,
    stats) -> state`` replaces ``apply_mstep`` (K2 + constants). The loglik
    and the change are computed in the data's dtype, as on the device in the
    reference, and read to the host once per iteration.
    """
    def estep(s) -> SuffStats:
        if stats_fn is not None:
            return stats_fn(s, data_chunks, wts_chunks)
        return accumulate_stats(s, data_chunks, wts_chunks, diag_only=diag_only)

    def mstep(s, stats):
        if mstep_fn is not None:
            return mstep_fn(s, stats)
        return apply_mstep(s, stats, diag_only=diag_only)

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
