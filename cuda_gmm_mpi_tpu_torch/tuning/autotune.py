"""Knob resolution: measured profile > microprobe > static cost model.

The port of the JAX package's ``tuning/autotune.py``. The database key reads
the torch device instead of JAX's backend: ``("gpu", the card's name)`` on a
CUDA device (``"gpu"`` is the key of ``cost.py``'s tables) and ``("cpu",
"cpu")`` on the CPU, JAX's own CPU key, so one database serves both
packages. The E-step backends are the port's (``auto``, ``cuda``,
``torch``): a JAX row that chose ``pallas`` or ``jnp`` is a bad row here and
counts as absent. On the card a fit leaves ``chunk_size`` as it is
(:func:`fit_knobs`). A fleet fit resolves ``fleet_mode`` alone
(:func:`resolve_fleet_config_ex`).

``GMMConfig.autotune`` gates everything: ``'off'`` (the default) makes
this module unreachable — every stream and result stays byte-identical
to pre-tuner behavior. ``'db'`` resolves each tunable knob from the
nearest recorded profile (``tuning.db``), ``'probe'`` measures missing
rows first (``tuning.probe``). Both fall back to the static cost model
(``tuning.cost``) when nothing measured applies, and BOTH leave any
knob the user set explicitly untouched — an explicit knob is one whose
value differs from the ``GMMConfig`` dataclass default (the CLI flags
feed fields 1:1, so a passed flag IS a non-default field; library
callers get the same contract).

Every resolved decision is emitted as a ``tune`` telemetry event
(schema rev v2.5): knob, chosen, candidate walls, source
(``db``/``probe``/``static``), the predicted wall/iter where one
exists, and the DB key that supplied it — so ``gmm report`` can render
the decision table and ``gmm diff``'s ``tune.regressions`` gate can
flag a tuned run that came in >20% slower than the profile that chose
its knobs (a stale DB pages instead of silently pessimizing).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import telemetry
from . import cost
from .db import TuningDB, TuningKey
from .probe import PROBEABLE, probe_knob

#: fit-path knobs the resolver may touch (serving has its own entry point
#: below).
FIT_KNOBS = ("chunk_size", "estep_backend", "sweep_k_buckets",
             "restart_batch_size")

_BACKENDS = ("auto", "cuda", "torch")
_BUCKET_POLICIES = ("pow2", "off")
_FLEET_MODES = ("scan", "vmap")


def fit_knobs(platform: str) -> Tuple[str, ...]:
    """The fit knobs resolved on ``platform``. On the card ``chunk_size`` is
    not a speed knob: the kernel route reads the whole chunk grid in one K1
    launch, so there it only pads the last chunk, and a streamed fit's
    blocks are ``chunk_size`` events, so it changes the stepwise EM and its
    result. The card keeps the caller's ``chunk_size``."""
    return tuple(k for k in FIT_KNOBS
                 if not (platform == "gpu" and k == "chunk_size"))


def _defaults():
    from ..config import GMMConfig

    return GMMConfig()


def explicit_knobs(config, knobs=FIT_KNOBS) -> frozenset:
    """Knobs the user pinned: value differs from the dataclass default.

    (A flag passed with exactly the default value is indistinguishable
    from an unset one — and resolving it to the default it already
    holds is a no-op, so the ambiguity is harmless.)
    """
    d = _defaults()
    return frozenset(k for k in knobs
                     if getattr(config, k) != getattr(d, k))


def _typed(knob: str, chosen: Any) -> Any:
    """Parse a DB row's string choice back to the config's type; raises
    ValueError on garbage (the caller treats that row as absent)."""
    if knob in ("chunk_size", "serve_min_block", "serve_max_block"):
        v = int(chosen)
        if v < 1:
            raise ValueError(f"{knob} must be positive, got {v}")
        return v
    if knob == "restart_batch_size":
        if chosen in (None, "None", "auto"):
            return None
        v = int(chosen)
        if v < 1:
            raise ValueError(f"restart_batch_size must be >= 1, got {v}")
        return v
    chosen = str(chosen)
    allowed = {"estep_backend": _BACKENDS,
               "sweep_k_buckets": _BUCKET_POLICIES,
               "fleet_mode": _FLEET_MODES}.get(knob)
    if allowed is not None and chosen not in allowed:
        raise ValueError(f"bad recorded {knob} choice {chosen!r}")
    return chosen


def _candidate_walls(slot: Dict[str, Any]) -> Dict[str, Optional[float]]:
    """{candidate: wall_per_iter_s} summary of a DB row for the event."""
    out = {}
    for name, prof in (slot.get("candidates") or {}).items():
        wall = prof.get("wall_per_iter_s") if isinstance(prof, dict) \
            else None
        out[str(name)] = (round(float(wall), 6)
                          if isinstance(wall, (int, float)) else None)
    return out


def device_key(device) -> Tuple[str, str]:
    """(platform, device_kind) of a torch device: ``("gpu", its name)`` on
    a CUDA device, ``("cpu", "cpu")`` on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


def _platform_key(config, n_events, n_dims, num_clusters) -> TuningKey:
    platform, device_kind = device_key(config.device)
    return TuningKey.for_shape(platform, device_kind, n_events, n_dims,
                               num_clusters, config.covariance_type,
                               config.dtype)


def _static_decision(knob: str, key: TuningKey, config,
                     n_events: int) -> Tuple[Any, Optional[float], dict]:
    """(chosen, predicted_s, candidate_predictions) from the cost model."""
    if knob == "chunk_size":
        walls = {
            str(c): round(cost.predict_iteration_wall(
                n_events, key.d, key.k_bucket, key.covariance,
                key.dtype, key.platform, c), 6)
            for c in cost.chunk_ladder(n_events, key.platform)}
        chosen = cost.static_chunk_size(n_events, key.d, key.k_bucket,
                                        key.covariance, key.dtype,
                                        key.platform)
        return chosen, walls.get(str(chosen)), walls
    if knob == "estep_backend":
        # Routing already knows this one statically: the kernels on the
        # card at float32, torch ops everywhere else.
        return ("cuda" if key.platform == "gpu"
                and key.dtype == "float32" else "torch"), None, {}
    if knob == "sweep_k_buckets":
        return "pow2", None, {}  # the config's default
    if knob == "restart_batch_size":
        return None, None, {}  # keep the host-memory auto cap
    if knob == "fleet_mode":
        return "scan", None, {}  # bit-parity default; vmap needs a row
    if knob == "serve_min_block":
        return 256, None, {}
    if knob == "serve_max_block":
        return 65536, None, {}
    raise ValueError(f"unknown tuning knob {knob!r}")


def _resolve_knob(knob: str, config, key: TuningKey, db: TuningDB,
                  mode: str, data=None, num_clusters: Optional[int] = None,
                  n_events: Optional[int] = None,
                  log=None) -> Optional[Dict[str, Any]]:
    """One knob through the ladder: exact db > probe > nearest db >
    static. Returns the decision dict, or None when no source could
    produce a valid choice (never happens for known knobs — static
    always answers)."""
    n_events = int(n_events if n_events is not None else key.n_bucket)
    slot = db.lookup(key, knob)
    source = "db"
    if slot is None and mode == "probe" and knob in PROBEABLE \
            and data is not None and num_clusters is not None:
        # A failed probe raises: a candidate that cannot run (a kernel
        # that does not build or launch) must not leave the others' row to
        # choose for it.
        slot = probe_knob(config, data, num_clusters, key, db, knob,
                          log=log)
        if slot is not None:
            db.save()
            source = "probe"
    if slot is None:
        slot = db.nearest(key, knob)
    if slot is not None:
        try:
            chosen = _typed(knob, slot["chosen"])
        except (ValueError, KeyError):
            slot = None  # corrupt row: fall through to static
    if slot is not None:
        if slot.get("source") == "probe" and source != "probe":
            source = "db"  # a prior probe's row read back is a db hit
        prof = db.chosen_profile(slot) or {}
        wall = prof.get("wall_per_iter_s")
        return {
            "knob": knob,
            "chosen": chosen,
            "source": source,
            "candidates": _candidate_walls(slot),
            "predicted_s": (round(float(wall), 6)
                            if isinstance(wall, (int, float)) else None),
            "key": slot.get("key", key.as_str()),
            "distance": slot.get("distance"),
        }
    chosen, predicted, walls = _static_decision(knob, key, config,
                                                n_events)
    return {
        "knob": knob,
        "chosen": chosen,
        "source": "static",
        "candidates": walls,
        "predicted_s": predicted,
        "key": key.as_str(),
        "distance": None,
    }


def emit_decisions(decisions: List[Dict[str, Any]],
                   surface: str = "fit") -> None:
    """One ``tune`` event per resolved knob on the ambient recorder."""
    rec = telemetry.current()
    if not rec.active:
        return
    for d in decisions:
        rec.emit(
            "tune",
            knob=d["knob"],
            chosen=("auto" if d["chosen"] is None else d["chosen"]),
            source=d["source"],
            surface=surface,
            default=("auto" if d.get("default") is None
                     else d.get("default")),
            candidates=d.get("candidates") or {},
            **({"predicted_s": d["predicted_s"]}
               if d.get("predicted_s") is not None else {}),
            **({"key": d["key"]} if d.get("key") else {}),
        )
        rec.metrics.count("tune_decisions")


def resolve_fit_config_ex(config, data, num_clusters: int, log=None
                          ) -> Tuple[Any, List[Dict[str, Any]]]:
    """(resolved config, decisions) for one fit. The returned config has
    ``autotune='off'``: resolution happened here, and the restart /
    elastic sub-fits that re-enter ``fit_gmm`` with it must ride the
    decisions instead of re-probing (and re-emitting) per init."""
    mode = config.autotune
    if mode == "off":
        return config, []
    try:
        n_events, n_dims = (int(s) for s in data.shape)
    except (AttributeError, TypeError, ValueError):
        return dataclasses.replace(config, autotune="off"), []
    key = _platform_key(config, n_events, n_dims, num_clusters)
    db = TuningDB.open(config.tuning_db)
    if db.load_error and log is not None:
        log.warning("%s", db.load_error)
    explicit = explicit_knobs(config)
    decisions: List[Dict[str, Any]] = []
    updates: Dict[str, Any] = {}
    for knob in fit_knobs(key.platform):
        if knob in explicit:
            continue
        if knob == "restart_batch_size" and config.n_init <= 1:
            continue
        d = _resolve_knob(knob, config, key, db, mode, data=data,
                          num_clusters=num_clusters, n_events=n_events,
                          log=log)
        if d is None:
            continue
        d["default"] = getattr(config, knob)
        decisions.append(d)
        if d["chosen"] is not None and d["chosen"] != getattr(config,
                                                              knob):
            updates[knob] = d["chosen"]
    resolved = dataclasses.replace(config, autotune="off", **updates)
    emit_decisions(decisions, surface="fit")
    if log is not None and updates:
        log.info("autotune (%s): %s", mode,
                 ", ".join(f"{k}={v}" for k, v in updates.items()))
    return resolved, decisions


def resolve_fit_config(config, data, num_clusters: int, log=None):
    """The fit-path entry: resolved config only."""
    return resolve_fit_config_ex(config, data, num_clusters, log=log)[0]


def resolve_fleet_config_ex(config, n_events: int, n_dims: int,
                            num_clusters: int, log=None
                            ) -> Tuple[Any, List[Dict[str, Any]]]:
    """Fleet-path resolution: ``fleet_mode`` at the fleet's largest packed
    shape, db > static (a fleet fit is the wrong place to burn tenant wall
    on a probe). The JAX package resolves ``chunk_size`` here too; the port
    resolves it for no fit (:func:`fit_knobs`): on the card K1 reads each
    tenant's whole chunk grid in one launch, so the chunk size only pads
    the last chunk, and it sets the packed groups' event buckets, which a
    recorded solo-fit row knows nothing of. The returned config has
    ``autotune='off'``."""
    mode = config.autotune
    if mode == "off":
        return config, []
    key = _platform_key(config, n_events, n_dims, num_clusters)
    db = TuningDB.open(config.tuning_db)
    if db.load_error and log is not None:
        log.warning("%s", db.load_error)
    decisions: List[Dict[str, Any]] = []
    updates: Dict[str, Any] = {}
    if "fleet_mode" not in explicit_knobs(config, knobs=("fleet_mode",)):
        d = _resolve_knob("fleet_mode", config, key, db, "db",
                          n_events=n_events, log=log)
        if d is not None:
            d["default"] = config.fleet_mode
            decisions.append(d)
            if d["chosen"] != config.fleet_mode:
                updates["fleet_mode"] = d["chosen"]
    resolved = dataclasses.replace(config, autotune="off", **updates)
    emit_decisions(decisions, surface="fleet")
    return resolved, decisions


def resolve_serving_blocks(dtype: str, diag_only: bool, n_dims: int,
                           num_clusters: int,
                           tuning_db: Optional[str] = None,
                           log=None, device="cuda"
                           ) -> Tuple[Dict[str, int], List[Dict[str, Any]]]:
    """Serving executor block bounds from the DB: ``{min_block,
    max_block}`` + the decisions. Serve rows are keyed at the nominal
    64k-event batch shape on ``device``; nearest-key matching bridges the
    rest."""
    platform, device_kind = device_key(device)
    key = TuningKey.for_shape(platform, device_kind, 65536, n_dims,
                              num_clusters,
                              "diag" if diag_only else "full", dtype)
    db = TuningDB.open(tuning_db)
    if db.load_error and log is not None:
        log.warning("%s", db.load_error)
    blocks: Dict[str, int] = {}
    decisions: List[Dict[str, Any]] = []
    for knob, field in (("serve_min_block", "min_block"),
                        ("serve_max_block", "max_block")):
        d = _resolve_knob(knob, None, key, db, "db", log=log)
        if d is None:
            continue
        decisions.append(d)
        blocks[field] = int(d["chosen"])
    if blocks.get("min_block", 0) > blocks.get("max_block", 1 << 30):
        # A torn pair of rows must not build an impossible executor.
        blocks["min_block"] = blocks["max_block"]
    emit_decisions(decisions, surface="serve")
    return blocks, decisions
