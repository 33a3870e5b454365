"""GMMState <-> numpy, field by field.

With these a test builds one seeded state as numpy arrays and hands the same
values to both packages; nothing here knows the other package.
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
