"""The port's logger: warnings (recovery attempts, checkpoint retries,
preemption) to stderr, INFO with ``enable_print``, DEBUG with
``enable_debug``, as the JAX package's ``utils/logging_.get_logger``
does; and ``metrics_line``, its one-line JSON records on stderr."""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "cuda_gmm_mpi_tpu_torch"


def get_logger(config=None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.propagate = False
    if config is not None:
        if getattr(config, "enable_debug", False):
            logger.setLevel(logging.DEBUG)
        elif getattr(config, "enable_print", False):
            logger.setLevel(logging.INFO)
        else:
            logger.setLevel(logging.WARNING)
    return logger


def metrics_line(event: str, stream=None, **fields) -> dict:
    """One JSON record ``{"event", "ts", **fields}`` on stderr (the JAX
    package's legacy ``--debug`` surface); returns the record."""
    import json
    import time

    rec = {"event": event, "ts": round(time.time(), 3)}
    rec.update(fields)
    out = stream or sys.stderr
    out.write(json.dumps(rec) + "\n")
    out.flush()
    return rec
