"""The port's logger: warnings (recovery attempts, checkpoint retries,
preemption) to stderr, INFO with ``enable_print``, as the JAX package's
``utils/logging_.get_logger`` does."""

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
        logger.setLevel(logging.INFO if getattr(config, "enable_print", False)
                        else logging.WARNING)
    return logger
