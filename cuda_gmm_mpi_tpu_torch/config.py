"""Runtime configuration of the PyTorch/CUDA port.

The field names and defaults are those of ``cuda_gmm_mpi_tpu.config.GMMConfig``
for every field this package reads, so one configuration means the same thing
in both packages. Fields of features that are not ported yet are absent
rather than ignored. Provenance of the reference's compile-time defines:

- ``max_clusters``             <- MAX_CLUSTERS            (gaussian.h:10)
- ``covariance_dynamic_range`` <- COVARIANCE_DYNAMIC_RANGE (gaussian.h:12)
- ``diag_only``                <- DIAG_ONLY               (gaussian.h:23)
- ``min_iters``/``max_iters``  <- MIN_ITERS/MAX_ITERS     (gaussian.h:26-27)
- ``enable_print``             <- ENABLE_PRINT            (gaussian.h:35)
- ``device``                   <- DEVICE                  (gaussian.h:19), a
  torch device name ('cuda' or 'cpu').
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GMMConfig:
    """Configuration for GMM-EM fitting and the model-order search."""

    max_clusters: int = 512
    covariance_dynamic_range: float = 1e3
    diag_only: bool = False
    # 'full' (reference default) | 'diag' (the reference's DIAG_ONLY; the
    # same setting as diag_only=True) | 'spherical' (sigma^2 I per cluster;
    # the diagonal statistics path) | 'tied' (one shared D x D covariance;
    # the full statistics path). The merge scan scores merges with the
    # unconstrained pooled covariance and EM re-imposes the family each K.
    covariance_type: str = "full"
    min_iters: int = 100
    max_iters: int = 100
    # Model-order selection score: 'rissanen' = the reference's MDL score
    # (gaussian.cu:826); 'bic'/'aic'/'aicc' count the family's free
    # parameters and use the event count N.
    criterion: str = "rissanen"
    # epsilon = nparams_per_cluster * ln(N*D) * scale (gaussian.cu:458).
    epsilon_scale: float = 0.01
    dtype: str = "float32"
    # Matmul precision of every product (the TPU's three modes, spelled out
    # on any device by ops/estep.py::kdot and, on the card, by K1/K3):
    # 'highest' = fp32-class products (TF32 off; K1's statistics in three
    # TF32 passes on the tensor cores, its logp on the fp32 FMA units);
    # 'high' = bf16_3x (each fp32 operand split into two bf16 parts, three
    # bf16 passes); 'default' = one bf16 pass. The cluster-sharded kernels
    # K5/K6 take all three as well.
    matmul_precision: str = "highest"
    # Quadratic-form evaluation: 'expanded' = x Rinv x^T - 2 b x + c as
    # products (data centered at fit time keeps it well-conditioned);
    # 'packed' = the same on the D(D+1)/2 upper-triangle features;
    # 'centered' = explicit (x - mu) staging (most stable; torch ops only,
    # the kernels compute the expanded form).
    quad_mode: str = "expanded"
    # Events per step of the torch-ops statistics loop; also the padded
    # chunk grid the event data is laid out in.
    chunk_size: int = 65536
    # Center the data at fit time (shift-equivariant; outputs shifted back).
    center_data: bool = True
    # E-step/statistics backend: 'cuda' runs the hand-written kernels K1/K2,
    # 'torch' the torch-ops path, 'auto' picks by device and dtype
    # (ops/kernels/__init__.py::resolve_estep_backend).
    estep_backend: str = "auto"
    # Hoist the [N, F] quadratic features of ``quad_mode`` out of the EM
    # loop on the torch-ops path: built once per EM run and held in device
    # memory (N*F*itemsize bytes), read every iteration. Full-covariance,
    # 'expanded'/'packed' only; the kernels build their features on chip.
    precompute_features: bool = False
    # Upper bound on the events K1 holds in shared memory per tile (the
    # kernel lowers it to fit its shared-memory budget at large K).
    pallas_block_b: int = 512
    # Torch device every entry point runs on. There is no silent fallback:
    # 'cuda' without a GPU raises.
    device: str = "cuda"
    enable_print: bool = False
    # RNG seed of the randomized paths (k-means++ seeding); the reference
    # itself is deterministic.
    seed: int = 0
    # Initial means: 'even' = the reference's evenly spaced event rows
    # (gaussian.cu:108-123); 'kmeans++' = D^2-weighted sampling,
    # deterministic given ``seed``.
    seed_method: str = "even"
    # Independent restarts (sklearn's n_init): init 0 uses ``seed_method``,
    # restarts i >= 1 use k-means++ at ``seed + i``; the best Rissanen score
    # is kept. 1 = the reference's single deterministic init.
    n_init: int = 1
    # Restarts per batched EM loop (models/restarts.py): one K3 + one K4
    # launch per EM iteration of the whole batch. None sizes the batch from
    # a memory budget (GMM_RESTART_MEM_BYTES overrides the budget); 1 = the
    # sequential path, which selects the same winner at the same seeds.
    restart_batch_size: Optional[int] = None
    # (data, cluster) mesh over the ranks of a torch.distributed world
    # (parallel/mesh.py): events sharded over the data axis, clusters over
    # the cluster axis. None = every rank on the data axis.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Write the model's cluster blocks and the .results (the reference's
    # compile-time ENABLE_OUTPUT; --no-output turns it off).
    enable_output: bool = True

    # --- numerical fault containment (health.py) ---
    # The health counters are always computed. ``recovery`` selects what a
    # FATAL flag (non-finite loglik/params) does: 'retry' rolls back to the
    # K's input state and climbs the escalation ladder (sanitize + raise
    # the variance floor -> quad_mode='centered' -> 'highest' precision),
    # failing loudly (NumericalFaultError) only when the ladder is
    # exhausted; 'off' raises at once. A poisoned model is never returned.
    recovery: str = "retry"
    # Escalation rungs attempted per fault before giving up (3 exist).
    max_recovery_attempts: int = 3
    # Variance-floor multiplier per attempt: attempt i retries with
    # avgvar * boost**i.
    recovery_boost: float = 10.0
    # Reseed empty clusters from worst-fit events at a target-K fit instead
    # of letting elimination shrink the model below the requested K.
    recovery_reseed_empty: bool = False
    # A loglik drop beyond this many epsilons between EM iterations raises
    # the (non-fatal) loglik_regression flag.
    health_regression_scale: float = 10.0

    # --- checkpoint/resume and the run supervisor (utils/checkpoint.py,
    # supervisor.py) ---
    # Directory of the sweep's checkpoints (<dir>/sweep/<step>.npz, the
    # JAX package's layout); None = no checkpoints.
    checkpoint_dir: Optional[str] = None
    # Retained checkpoint steps (newest + fallbacks). >= 1.
    checkpoint_keep: int = 2
    # Bounded retries (jittered exponential backoff) of a checkpoint
    # write; 0 = the first failure is final.
    checkpoint_retries: int = 3
    # Wall-clock budget in seconds: reaching it acts like SIGTERM --
    # cooperative stop, emergency checkpoint, exit 75. None = no deadline.
    max_runtime_s: Optional[float] = None
    # EM iterations between the supervisor's stop-flag checks inside a K
    # (with a supervisor and checkpoint_dir).
    preempt_poll_iters: int = 25
    # 'auto' resumes from the newest checkpoint (an emergency mid-EM
    # sub-step included); 'never' starts fresh (and still writes).
    resume: str = "auto"
    # JSONL path of the run's telemetry stream (telemetry/); None = off.
    metrics_file: Optional[str] = None

    def __post_init__(self):
        if self.min_iters > self.max_iters:
            raise ValueError(
                f"min_iters ({self.min_iters}) must be <= max_iters "
                f"({self.max_iters})")
        if self.max_clusters < 1:
            raise ValueError("max_clusters must be >= 1")
        if self.covariance_type not in ("full", "diag", "spherical", "tied"):
            raise ValueError(
                f"unknown covariance_type: {self.covariance_type!r}")
        if self.criterion not in ("rissanen", "bic", "aic", "aicc"):
            raise ValueError(f"unknown criterion: {self.criterion!r}")
        # diag_only and covariance_type are one setting: keep them coherent
        # whichever way the caller spells it.
        if self.diag_only and self.covariance_type == "full":
            object.__setattr__(self, "covariance_type", "diag")
        elif self.covariance_type in ("diag", "spherical"):
            object.__setattr__(self, "diag_only", True)
        elif self.diag_only and self.covariance_type == "tied":
            raise ValueError(
                "covariance_type='tied' needs full-covariance statistics; "
                "it cannot combine with diag_only=True")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}")
        if self.quad_mode not in ("expanded", "packed", "centered"):
            raise ValueError(f"unknown quad_mode: {self.quad_mode!r}")
        if self.estep_backend not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"unknown estep_backend: {self.estep_backend!r} "
                "(expected 'auto', 'cuda' or 'torch')")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"unknown device: {self.device!r} (expected 'cuda' or 'cpu')")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if self.pallas_block_b < 64 or self.pallas_block_b % 64:
            raise ValueError("pallas_block_b must be a positive multiple of 64")
        if self.seed_method not in ("even", "kmeans++"):
            raise ValueError(f"unknown seed_method: {self.seed_method!r}")
        if self.n_init < 1:
            raise ValueError("n_init must be >= 1")
        if self.restart_batch_size is not None and self.restart_batch_size < 1:
            raise ValueError("restart_batch_size must be >= 1 (or None for "
                             "the memory-sized default)")
        if self.precompute_features:
            if self.diag_only:
                raise ValueError(
                    "precompute_features is a full-covariance optimization "
                    "(diag builds no [N, F] features)")
            if self.quad_mode == "centered":
                raise ValueError(
                    "precompute_features requires quad_mode='expanded' or "
                    "'packed' (the 'centered' staging has no loop-invariant "
                    "feature matrix to hoist)")
            if self.estep_backend == "cuda":
                raise ValueError(
                    "precompute_features is the torch-ops feature hoist; "
                    "the CUDA kernels build their features on chip -- drop "
                    "one flag")
        if self.checkpoint_keep < 1:
            raise ValueError("checkpoint_keep must be >= 1")
        if self.max_runtime_s is not None and self.max_runtime_s <= 0:
            raise ValueError("max_runtime_s must be > 0 (or None)")
        if self.preempt_poll_iters < 1:
            raise ValueError("preempt_poll_iters must be >= 1")
        if self.resume not in ("auto", "never"):
            raise ValueError(
                f"unknown resume: {self.resume!r} "
                "(expected 'auto' or 'never')")
        if self.recovery not in ("retry", "off"):
            raise ValueError(
                f"unknown recovery: {self.recovery!r} "
                "(expected 'retry' or 'off')")
        if self.max_recovery_attempts < 0:
            raise ValueError("max_recovery_attempts must be >= 0")
        if self.checkpoint_retries < 0:
            raise ValueError("checkpoint_retries must be >= 0")
        if self.recovery_boost < 1.0:
            raise ValueError("recovery_boost must be >= 1")
        if self.health_regression_scale <= 0:
            raise ValueError("health_regression_scale must be > 0")
        if self.mesh_shape is not None and (
                len(self.mesh_shape) != 2 or min(self.mesh_shape) < 1):
            raise ValueError(f"mesh_shape must be (data, cluster) with both "
                             f">= 1, got {self.mesh_shape!r}")
