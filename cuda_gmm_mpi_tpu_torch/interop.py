"""GMMState <-> numpy, field by field, and a fitted estimator from numpy.

With these a test builds one seeded state as numpy arrays and hands the same
values to both packages, or carries a fitted JAX estimator's parameters
across to score both packages on identical parameters; nothing here knows
the other package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import GMMState

FIELDS = tuple(f.name for f in dataclasses.fields(GMMState))


def state_from_numpy(d, device="cpu") -> GMMState:
    """A GMMState from a mapping (or object with attributes) of arrays named
    like the state's fields; dtypes are kept."""
    get = d.__getitem__ if isinstance(d, dict) else (lambda k: getattr(d, k))
    return GMMState(**{k: torch.as_tensor(np.array(get(k)), device=device)
                       for k in FIELDS})


def state_to_numpy(state: GMMState) -> dict:
    """A dict of numpy arrays, one per state field."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}


def fitted_estimator(state, data_shift, config=None, **config_overrides):
    """A fitted ``GaussianMixture`` from another fit's parameters: ``state``
    a mapping (or object) of the state fields as arrays (compacted: K
    active clusters), ``data_shift`` [D] the fit's centering shift. K and D
    come from the state's means. The estimator predicts, scores and
    samples; its score and loglik are NaN, as after ``from_summary``."""
    from .config import GMMConfig
    from .estimator import GaussianMixture

    if config is not None and config_overrides:
        raise ValueError("pass either config or field overrides, not both")
    return GaussianMixture._from_state(
        state_from_numpy(state), data_shift,
        config or GMMConfig(**config_overrides))
