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


@dataclasses.dataclass(frozen=True)
class GMMConfig:
    """Configuration for GMM-EM fitting and the model-order search."""

    max_clusters: int = 512
    covariance_dynamic_range: float = 1e3
    diag_only: bool = False
    # 'full' (reference default) or 'diag' (the reference's DIAG_ONLY; the
    # same setting as diag_only=True).
    covariance_type: str = "full"
    min_iters: int = 100
    max_iters: int = 100
    # epsilon = nparams_per_cluster * ln(N*D) * scale (gaussian.cu:458).
    epsilon_scale: float = 0.01
    dtype: str = "float32"
    # 'highest' = plain fp32 (or fp64) multiply-adds, no TF32. The 3-pass
    # bf16 'high' and 1-pass 'default' modes are not ported yet.
    matmul_precision: str = "highest"
    # Events per step of the torch-ops statistics loop; also the padded
    # chunk grid the event data is laid out in.
    chunk_size: int = 65536
    # Center the data at fit time (shift-equivariant; outputs shifted back).
    center_data: bool = True
    # E-step/statistics backend: 'cuda' runs the hand-written kernels K1/K2,
    # 'torch' the torch-ops path, 'auto' picks by device and dtype
    # (ops/kernels/__init__.py::resolve_estep_backend).
    estep_backend: str = "auto"
    # Upper bound on the events K1 holds in shared memory per tile (the
    # kernel lowers it to fit its shared-memory budget at large K).
    pallas_block_b: int = 512
    # Torch device every entry point runs on. There is no silent fallback:
    # 'cuda' without a GPU raises.
    device: str = "cuda"
    enable_print: bool = False

    def __post_init__(self):
        if self.min_iters > self.max_iters:
            raise ValueError(
                f"min_iters ({self.min_iters}) must be <= max_iters "
                f"({self.max_iters})")
        if self.max_clusters < 1:
            raise ValueError("max_clusters must be >= 1")
        if self.covariance_type not in ("full", "diag"):
            raise ValueError(
                f"unknown covariance_type: {self.covariance_type!r} "
                "(expected 'full' or 'diag')")
        # diag_only and covariance_type are one setting: keep them coherent
        # whichever way the caller spells it.
        if self.diag_only:
            object.__setattr__(self, "covariance_type", "diag")
        elif self.covariance_type == "diag":
            object.__setattr__(self, "diag_only", True)
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype: {self.dtype!r}")
        if self.matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"unknown matmul_precision: {self.matmul_precision!r}")
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
