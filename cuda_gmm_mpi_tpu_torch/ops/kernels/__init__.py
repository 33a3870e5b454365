"""Hand-written Hopper kernels -- the ``estep_backend='cuda'`` hot path.

K1 (fused E+M statistics) and K2 (the whole M-step: the guarded update
and the Cholesky constants) plug into the EM loop's ``stats_fn``/
``mstep_fn`` hooks, so with backend 'cuda' one EM iteration is one K1
launch and one K2 launch. K3 and K4 are their restart-batched forms on the
hooks of ``em_while_loop_batched``: one EM iteration of a whole restart
batch is one K3 launch and one K4 launch, and of a 'vmap' fleet group
(tenancy/) one launch of K3's per-lane-events form, each lane over its own
events, and one K4 launch. On a mesh whose
cluster axis is sharded (parallel/), K5 and K6 take K1's place: the
statistics of one EM iteration are one K5 launch, two all_reduce calls of
[N] per-event scalars over the cluster axis and one K6 launch, and the
M-step is the torch-ops ``apply_mstep`` (its pi needs the global soft
count, an all_reduce), as in the JAX package.

Routing (``resolve_estep_backend``):

=================================  ======================================
device, dtype, ``estep_backend``   resolves to
=================================  ======================================
any, any, 'torch'                  'torch' (the torch-ops yardstick)
any, float64, 'auto' or 'cuda'     'torch' -- kernel is float32-only
quad_mode='centered' (full), auto  'torch' -- the kernels compute the
                                   expanded form ('cuda' raises)
sharded clusters, full covariance  'torch' -- the two-pass kernels would
                                   run the dominant contraction twice
cuda, float32, 'auto' or 'cuda'    'cuda' (K1 + K2; K5 + K6 with sharded
                                   clusters, diagonal covariance)
cpu, float32, 'auto'               'torch'
cpu, float32, 'cuda'               raises: the kernels need a CUDA device
=================================  ======================================

Every matmul precision routes alike: K1/K3 and K5/K6 run 'highest',
'high' and 'default' (``PREC`` in csrc/fused_stats.cu; K5/K6 at 'high' and
'default' on K1's kernel for every shard width); 'packed' stays on the
kernels, which form only the upper triangle of x x^T already.

Covariance families: 'spherical' runs the diag statistics (K1/K3, or K5/K6
on a cluster-sharded mesh) and 'tied' the full ones (K1/K3); their M-step
is the torch-ops ``apply_mstep(covariance_type=...)``, as in the JAX
package, whose M-step kernel takes full and diag only: ``make_mstep_fn``
returns None for them.
"""

from __future__ import annotations

import functools

from .fused_stats import (
    fused_mstep_cuda, fused_mstep_cuda_batched, fused_stats_cuda,
    fused_stats_cuda_batched, fused_stats_cuda_fleet, fused_stats_cuda_sharded,
)


def resolve_estep_backend(config, cluster_sharded: bool = False):
    """(backend, reason) the statistics path will actually run:
    backend is 'cuda' or 'torch'. ``cluster_sharded``: the mesh's cluster
    axis is larger than 1."""
    mode = config.estep_backend
    if mode == "torch":
        return "torch", "estep_backend=torch (explicit)"
    if config.dtype != "float32":
        return "torch", f"kernel is float32-only (dtype={config.dtype})"
    if config.quad_mode == "centered" and not config.diag_only:
        if mode == "cuda":
            raise ValueError("quad_mode='centered' runs on torch ops only: "
                             "the CUDA kernels compute the expanded form")
        return "torch", ("quad_mode=centered stays on torch ops (the "
                         "kernels compute the expanded form)")
    if cluster_sharded and not config.diag_only:
        # Full covariance is bound by its [N, T+D] x [T+D, K] product: the
        # two-pass kernels (K5, then K6) would run it twice, the torch-ops
        # collective-LSE path once.
        return "torch", ("cluster-sharded full covariance stays on the "
                         "torch-ops collective-LSE path (the two-pass "
                         "kernels K5 + K6 would run the dominant "
                         "contraction twice)")
    if config.device == "cuda":
        return "cuda", f"estep_backend={mode} on a CUDA device at float32"
    if mode == "cuda":
        raise ValueError("estep_backend='cuda' runs the hand-written CUDA "
                         "kernels and needs device='cuda'")
    return "torch", "estep_backend=auto on the CPU"


def make_stats_fn(config, cluster_sharded: bool = False, cluster_group=None):
    """stats_fn hook bound to the config, or None for the torch-ops path:
    K1, or K5 + K6 over ``cluster_group`` when ``cluster_sharded``."""
    backend, _ = resolve_estep_backend(config, cluster_sharded)
    if backend != "cuda":
        return None
    if cluster_sharded:
        return functools.partial(
            fused_stats_cuda_sharded, cluster_group=cluster_group,
            diag_only=config.diag_only, block_b=config.pallas_block_b,
            precision=config.matmul_precision)
    return functools.partial(
        fused_stats_cuda, diag_only=config.diag_only,
        block_b=config.pallas_block_b, precision=config.matmul_precision)


def make_batched_stats_fn(config, cluster_sharded: bool = False):
    """Restart-batched stats_fn hook (K3), or None for the lane loop: the
    torch-ops one, or on a cluster-sharded mesh the mesh's own statistics
    lane by lane (the two-pass K5/K6 has no batched form, as in the JAX
    package)."""
    backend, _ = resolve_estep_backend(config, cluster_sharded)
    if backend != "cuda" or cluster_sharded:
        return None
    return functools.partial(
        fused_stats_cuda_batched, diag_only=config.diag_only,
        block_b=config.pallas_block_b, precision=config.matmul_precision)


def make_fleet_stats_fn(config, cluster_sharded: bool = False):
    """The fleet's batched stats_fn hook ('vmap' groups: K3's per-lane-events
    form, each lane over its own events), or None where
    :func:`make_batched_stats_fn` gives None: the caller runs the lanes'
    statistics one by one."""
    backend, _ = resolve_estep_backend(config, cluster_sharded)
    if backend != "cuda" or cluster_sharded:
        return None
    return functools.partial(
        fused_stats_cuda_fleet, diag_only=config.diag_only,
        block_b=config.pallas_block_b, precision=config.matmul_precision)


def make_mstep_fn(config, batched: bool = False,
                  cluster_sharded: bool = False):
    """mstep_fn hook (K2, or K4 with ``batched``: one launch per M-step),
    or None for the torch-ops path. None on cluster-sharded meshes too:
    pi's denominator there is an all_reduce inside the torch-ops update.
    None for 'spherical' and 'tied', as in the JAX package: K2 is the
    reference's full/diag update, and their ties across dimensions or
    clusters stay in the torch-ops update."""
    backend, _ = resolve_estep_backend(config, cluster_sharded)
    if (backend != "cuda" or cluster_sharded
            or config.covariance_type not in ("full", "diag")):
        return None
    return functools.partial(
        fused_mstep_cuda_batched if batched else fused_mstep_cuda,
        diag_only=config.diag_only)


__all__ = ["fused_stats_cuda", "fused_stats_cuda_batched",
           "fused_stats_cuda_fleet", "fused_stats_cuda_sharded",
           "fused_mstep_cuda", "fused_mstep_cuda_batched",
           "make_batched_stats_fn", "make_fleet_stats_fn", "make_stats_fn",
           "make_mstep_fn", "resolve_estep_backend"]
