"""Serving subsystem: registry, scoring executables, micro-batching.

The inference half of the port, copied from the JAX package's serving
layer: the training side fits mixtures; this package persists them as
versioned artifacts in the JAX package's format (:mod:`.registry`), builds
bucketed scoring executables so a warm request never builds again -- on
the card CUDA-graph replays of the scoring kernel S1 (:mod:`.executor`) --
and serves coalesced micro-batched request traffic per model
(:mod:`.server`, the ``gmm serve`` CLI; :mod:`.http`, :mod:`.pool` and
:mod:`.client` for the network tier).
"""

from .breaker import CircuitBreakers
from .client import GMMClient, GMMClientError
from .executor import (ScoringExecutor, executor_for_config,
                       executor_for_model, pow2_bucket)
from .http import HTTPFrontEnd, InprocBackend
from .pool import WorkerPool
from .registry import ModelRegistry, RegistryError, ServedModel
from .server import GMMServer, serve_main

__all__ = [
    "CircuitBreakers", "GMMClient", "GMMClientError", "GMMServer",
    "HTTPFrontEnd", "InprocBackend", "ModelRegistry", "RegistryError",
    "ScoringExecutor", "ServedModel", "WorkerPool",
    "executor_for_config", "executor_for_model", "pow2_bucket",
    "serve_main",
]
