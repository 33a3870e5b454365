"""PyTorch/CUDA port of cuda_gmm_mpi_tpu: GMM-EM with Rissanen model-order
search on an NVIDIA H100, with hand-written Hopper kernels for the fused
E+M statistics (K1) and the M-step epilogue (K2); ``GaussianMixture`` is
its scikit-learn-shaped estimator.

Entry points run on the GPU (``GMMConfig.device='cuda'``) unless the caller
asks for the CPU.
"""

from ._version import __version__
from .config import GMMConfig
from .estimator import GaussianMixture
from .models import GMMModel, GMMResult, compute_memberships, fit_gmm, iter_memberships

__all__ = ["__version__", "GMMConfig", "GaussianMixture", "GMMModel",
           "GMMResult", "compute_memberships", "fit_gmm", "iter_memberships"]
