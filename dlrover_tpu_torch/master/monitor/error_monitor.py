"""Error/event reporting from the master: the port's own copy of the local
sink of dlrover_tpu/master/monitor/error_monitor.py (the k8s-event sink
waits for the distributed master).
"""

from __future__ import annotations

import time
from typing import List

from dlrover_tpu_torch.common.log import logger


class ErrorEvent:
    def __init__(self, event_type: str, instance: str, message: str):
        self.timestamp = time.time()
        self.event_type = event_type  # info | warning | error
        self.instance = instance  # e.g. "worker-3"
        self.message = message


class ErrorMonitor:
    """Default sink: the master log + an in-memory window."""

    def __init__(self, max_events: int = 256):
        self.events: List[ErrorEvent] = []
        self._max = max_events

    def report(self, event_type: str, instance: str, message: str):
        event = ErrorEvent(event_type, instance, message)
        self.events.append(event)
        if len(self.events) > self._max:
            self.events.pop(0)
        log = logger.error if event_type == "error" else logger.warning
        log("[event %s] %s: %s", event_type, instance, message)

    def process_error(
        self, node_type: str, node_id: int, error_data: str, level: str
    ):
        """Node failure hook."""
        self.report(
            "error" if level == "error" else "warning",
            f"{node_type}-{node_id}",
            error_data[:500],
        )
