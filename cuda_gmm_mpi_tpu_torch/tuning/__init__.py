"""Profile-guided autotuning (the port of the JAX package's ``tuning/``).

Recorded per-shape profiles (``tuning.db``) + a bounded microprobe
(``tuning.probe``) + a static cost model (``tuning.cost``) resolve the
hand-set knobs -- ``chunk_size``, the E-step backend, sweep bucketing,
restart batching, serving block bounds, the fleet mode -- per
(platform, device_kind, shape). ``GMMConfig.autotune='off'`` (the default)
keeps every stream and result byte-identical to an untuned run; ``'db'``
and ``'probe'`` resolve through ``tuning.autotune``'s fallback ladder and
emit one ``tune`` telemetry event per decision. ``gmm tune`` is the
offline sweep (``tuning.cli``).
"""

from .autotune import (  # noqa: F401
    FIT_KNOBS,
    emit_decisions,
    explicit_knobs,
    resolve_fit_config,
    resolve_fit_config_ex,
    resolve_fleet_config_ex,
    resolve_serving_blocks,
)
from .cost import em_iteration_cost, predict_iteration_wall  # noqa: F401
from .db import (  # noqa: F401
    KNOBS,
    TuningDB,
    TuningKey,
    default_db_path,
    pow2_bucket,
)
from .probe import PROBEABLE, probe_knob  # noqa: F401
