"""Hand-written Hopper kernels -- the ``estep_backend='cuda'`` hot path.

K1 (fused E+M statistics) and K2 (the M-step epilogue) plug into the EM
loop's ``stats_fn``/``mstep_fn`` hooks, so with backend 'cuda' one EM
iteration is one K1 launch, one K2 launch and the K-sized Cholesky
constants.

Routing (``resolve_estep_backend``):

=================================  ======================================
device, dtype, ``estep_backend``   resolves to
=================================  ======================================
any, any, 'torch'                  'torch' (the torch-ops yardstick)
any, float64, 'auto' or 'cuda'     'torch' -- kernel is float32-only
cuda, float32, 'auto' or 'cuda'    'cuda' (K1 + K2)
cpu, float32, 'auto'               'torch'
cpu, float32, 'cuda'               raises: the kernels need a CUDA device
=================================  ======================================
"""

from __future__ import annotations

import functools

from ..constants import compute_constants
from .fused_stats import fused_mstep_cuda, fused_stats_cuda


def resolve_estep_backend(config):
    """(backend, reason) the statistics path will actually run:
    backend is 'cuda' or 'torch'."""
    mode = config.estep_backend
    if mode == "torch":
        return "torch", "estep_backend=torch (explicit)"
    if config.dtype != "float32":
        return "torch", f"kernel is float32-only (dtype={config.dtype})"
    if config.device == "cuda":
        return "cuda", f"estep_backend={mode} on a CUDA device at float32"
    if mode == "cuda":
        raise ValueError("estep_backend='cuda' runs the hand-written CUDA "
                         "kernels and needs device='cuda'")
    return "torch", "estep_backend=auto on the CPU"


def make_stats_fn(config):
    """stats_fn hook bound to the config, or None for the torch-ops path."""
    backend, _ = resolve_estep_backend(config)
    if backend != "cuda":
        return None
    return functools.partial(
        fused_stats_cuda, diag_only=config.diag_only,
        block_b=config.pallas_block_b, precision=config.matmul_precision)


def make_mstep_fn(config):
    """mstep_fn hook (K2 + constants), or None for the torch-ops path."""
    backend, _ = resolve_estep_backend(config)
    if backend != "cuda":
        return None
    diag_only = config.diag_only

    def mstep(state, stats):
        return compute_constants(
            fused_mstep_cuda(state, stats, diag_only=diag_only),
            diag_only=diag_only)

    return mstep


__all__ = ["fused_stats_cuda", "fused_mstep_cuda", "make_stats_fn",
           "make_mstep_fn", "resolve_estep_backend"]
