"""Shared configured logger (the port's copy of dlrover_tpu/common/log.py)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    # the same variable as the JAX package, so one setting serves both
    level = os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


logger = _build_logger()
