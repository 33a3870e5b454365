"""GMM model state as a dataclass of torch tensors.

The reference's ``clusters_t`` struct-of-arrays (``gaussian.h:62-76``): the
same fields (N, pi, constant, avgvar, means, R, Rinv) plus an ``active`` mask
that replaces the reference's realloc-and-shift cluster compaction
(``gaussian.cu:866-874, 902-907``): inactive clusters stay in place and are
algebraically inert, so shapes only change when the sweep compacts.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GMMState:
    """Parameters of a K-component Gaussian mixture, padded to a fixed K.

    Shapes (K = padded cluster count, D = dimensions):
      N        [K]       soft event counts      (clusters_t.N)
      pi       [K]       mixture weights        (clusters_t.pi)
      constant [K]       log normalizing const  = -D/2 ln(2 pi) - 1/2 ln|R|
      avgvar   [K]       diagonal regularizer   (clusters_t.avgvar)
      means    [K, D]                           (clusters_t.means)
      R        [K, D, D] covariance             (clusters_t.R)
      Rinv     [K, D, D] inverse covariance     (clusters_t.Rinv)
      active   [K]       bool; True = the cluster participates
    """

    N: torch.Tensor
    pi: torch.Tensor
    constant: torch.Tensor
    avgvar: torch.Tensor
    means: torch.Tensor
    R: torch.Tensor
    Rinv: torch.Tensor
    active: torch.Tensor

    @property
    def num_clusters_padded(self) -> int:
        return self.N.shape[0]

    @property
    def num_dimensions(self) -> int:
        return self.means.shape[-1]

    def num_active(self) -> int:
        return int(self.active.sum())

    def replace(self, **kwargs) -> "GMMState":
        return dataclasses.replace(self, **kwargs)

    def to(self, device) -> "GMMState":
        return GMMState(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    def take(self, idx: torch.Tensor) -> "GMMState":
        """The clusters at ``idx`` (a 1-D index tensor), in that order."""
        return GMMState(**{f.name: getattr(self, f.name).index_select(0, idx)
                           for f in dataclasses.fields(self)})


def zeros_state(num_clusters: int, num_dimensions: int,
                dtype=torch.float32, device="cpu") -> GMMState:
    """An all-inactive state of the given padded size."""
    K, D = num_clusters, num_dimensions
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    eye = torch.eye(D, dtype=dtype, device=device).expand(K, D, D).clone()
    return GMMState(N=z(K), pi=z(K), constant=z(K), avgvar=z(K),
                    means=z(K, D), R=eye, Rinv=eye.clone(),
                    active=torch.zeros(K, dtype=torch.bool, device=device))


def bucket_width(k_active: int, padded: int) -> int:
    """Smallest power of two >= ``k_active``, clamped to the current
    ``padded`` width (buckets only ever shrink)."""
    w = 1 << max(0, k_active - 1).bit_length()
    return min(w, padded)


def compact_to(state: GMMState, num_clusters: int) -> GMMState:
    """Shrink the padded width: active rows first (relative order kept, the
    reference's left-shift compaction, gaussian.cu:869-871), then inactive
    slots in their original order, truncated to ``num_clusters``."""
    K = state.num_clusters_padded
    if num_clusters > K:
        raise ValueError(f"compact_to grows the state ({K} -> {num_clusters})")
    pos = torch.arange(K, device=state.active.device)
    idx = torch.argsort(torch.where(state.active, pos, pos + K))[:num_clusters]
    return state.take(idx)


def compact(state: GMMState) -> Tuple[GMMState, int]:
    """Drop inactive clusters, preserving relative order
    (gaussian.cu:869-871, 903-907, applied at output time)."""
    idx = torch.nonzero(state.active).flatten()
    return state.take(idx), int(idx.numel())
