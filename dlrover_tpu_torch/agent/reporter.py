"""Agent-side folded status reporter: the port's own copy of
dlrover_tpu/agent/reporter.py.

One :class:`WorkerReport` a period folds the heartbeat with the host's
resource usage and the card's memory in use (``agent/monitor.py``), and
the server's explicit ``Overloaded`` reply widens the cadence (AIMD,
:class:`~dlrover_tpu_torch.rpc.policy.AdaptiveInterval`) instead of being
retried into. An unreachable master widens it too. Diagnosis actions ride
back on the ack.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from dlrover_tpu_torch.agent.monitor import (
    get_device_metrics,
    get_process_cpu_percent,
    get_used_memory_mb,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.rpc.policy import AdaptiveInterval, OverloadedError


class StatusReporter:
    """Periodic folded worker report with backpressure honor.

    ``on_actions`` receives the diagnosis actions the master piggybacks
    on the ack (same contract as the old heartbeat loop)."""

    def __init__(
        self,
        client,
        interval_s: float = 15.0,
        max_interval_s: Optional[float] = None,
        on_actions: Optional[Callable[[List], None]] = None,
    ):
        self._client = client
        # default widening bound of 4x base: the unreachable-master
        # path has no server-advertised liveness ceiling (nobody is
        # answering), and an unbounded AIMD walk would carry a healthy
        # agent past the heartbeat timeout during a long master outage
        self._interval = AdaptiveInterval(
            interval_s,
            max_interval_s if max_interval_s is not None
            else interval_s * 4,
        )
        self._on_actions = on_actions
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def report_once(self) -> bool:
        """One folded report; returns False when shed/unreachable (and
        the cadence has been widened accordingly)."""
        try:
            device = get_device_metrics()
            resp = self._client.report_worker_status(
                cpu_percent=get_process_cpu_percent(),
                memory_mb=get_used_memory_mb(),
                tpu_duty_cycle=device["duty_cycle"],
                tpu_hbm_used_mb=device["hbm_used_mb"],
            )
        except OverloadedError as e:
            widened = self._interval.widen(e.retry_after_s, e.max_interval_s)
            logger.warning(
                "master shed status report (depth=%s); widening interval "
                "to %.1fs", e.queue_depth, widened,
            )
            return False
        except Exception as e:  # master restartable
            self._interval.widen()
            logger.warning("status report failed: %s", e)
            return False
        self._interval.ok()
        if self._on_actions is not None and getattr(resp, "actions", None):
            try:
                self._on_actions(list(resp.actions))
            except Exception:
                logger.exception("status-report action handler failed")
        return True

    def start(self):
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="status-reporter", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_evt.set()

    def _loop(self):
        # jittered wait: overload-widened reporters must de-phase, not
        # pound the gate in cohorts
        while not self._stop_evt.wait(self._interval.next_delay_s()):
            self.report_once()
