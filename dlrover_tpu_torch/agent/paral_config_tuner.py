"""The worker's side of the parallel-config file: the port's own copy of
``read_paral_config`` from dlrover_tpu/agent/paral_config_tuner.py.

The agent's tuner, which polls the master and writes the file, waits for
ROADMAP 5b; ``ElasticDataLoader`` reads the file it writes, under the same
path flag (``DLROVER_TPU_PARAL_CONFIG_PATH``) and JSON keys.
"""

from __future__ import annotations

import json
import os

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger


def read_paral_config(path: str = "") -> dict:
    """Worker-side: read the tuner file (empty dict when absent/unset)."""
    path = path or flags.PARAL_CONFIG_PATH.get()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("paral config read failed: %s", e)
        return {}
