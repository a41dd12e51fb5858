"""ParalConfigTuner: master-pushed runtime tunables -> a JSON file the
training processes watch. The port's own copy of
dlrover_tpu/agent/paral_config_tuner.py.

The agent's tuner fetches the node's ``ParallelConfig`` from the master
every ``interval`` seconds and writes it, on change, atomically (tmp +
rename) so a reader never sees a torn config; the agent hands the path to
its workers in ``DLROVER_TPU_PARAL_CONFIG_PATH``. The worker side is
``read_paral_config``: ``ElasticDataLoader`` and the trainer's
``poll_runtime_config`` read the file under the same JSON keys.

Known difference: the JAX tuner writes under ``/tmp/dlrover_tpu/<job>/``;
the port's file lives under the temporary directory (``$TMPDIR`` when set),
as the agent's logs do. The path reaches the workers through the
environment, so nothing else reads it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Optional

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger

#: workers find the config file through this env var (set by the agent)
PARAL_CONFIG_PATH_ENV = flags.PARAL_CONFIG_PATH.name


def default_config_path(job_name: str, node_id: int) -> str:
    return os.path.join(
        tempfile.gettempdir(), "dlrover_tpu", job_name, f"node-{node_id}",
        "paral_config.json",
    )


class ParalConfigTuner:
    def __init__(
        self,
        client,
        job_name: str,
        node_id: int,
        path: str = "",
        interval: float = 30.0,
    ):
        self._client = client
        self.path = path or default_config_path(job_name, node_id)
        self._interval = interval
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_written = ""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paral-config-tuner", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_evt.set()

    def poll_once(self) -> bool:
        """Fetch the master's current config; write the file on change."""
        try:
            config = self._client.get_paral_config()
        except Exception as e:
            logger.warning("paral config fetch failed: %s", e)
            return False
        if config is None:
            return False
        payload = json.dumps(dataclasses.asdict(config), sort_keys=True)
        if payload == self._last_written:
            return False
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self.path)
        self._last_written = payload
        logger.info("paral config updated: %s", payload)
        return True

    def _loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.poll_once()
            except Exception:
                logger.exception("paral config tuner cycle failed")


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
