"""EM loop and model-order search."""

from .gmm import GMMModel, chunk_events, em_while_loop
from .order_search import GMMResult, compute_memberships, fit_gmm, iter_memberships

__all__ = ["GMMModel", "GMMResult", "chunk_events", "compute_memberships",
           "em_while_loop", "fit_gmm", "iter_memberships"]
