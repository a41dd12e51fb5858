"""Agent-side diagnosis: observe worker health, decide restart vs relaunch.
The port's own copy of dlrover_tpu/agent/diagnosis_agent.py.

Every ``interval_secs`` the agent ships its workers' log tails
(``TrainingLogRecord``), the device timer's condensed scrape
(``TpuMetricsRecord``) and, when the timer flags a hang, its own hang dump
(``HangDumpRecord``: the workers' stacks and pending device programs) to
the master; on the master's ``CollectHangDump`` it ships a dump at once
(``collect_and_ship_dump``). The failure decision lives in the agent
because it is the one place that knows the restart budget and sees the
worker log before the master does.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.operators import classify_log


class WorkerAction:
    RESTART_WORKER = "restart"  # respawn processes on this host
    RELAUNCH_WORKER = "relaunch"  # exit; platform replaces this host


@dataclass
class WorkerFailure:
    node_id: int
    restart_count: int
    max_restarts: int
    exit_code: int = 1
    log_tail: str = ""


class DiagnosisAgent:
    """Runs inside the elastic agent process on every host."""

    def __init__(self, client=None, node_id: int = -1, interval_secs: float = 60.0):
        self._client = client
        self._node_id = node_id
        self._interval = interval_secs
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log_source = None  # callable -> str (worker log tail)
        self._metrics_source = None  # callable -> dict (tpu_timer scrape)
        self._hang_dumper = None  # profiler.hang_dump.HangDumper

    def set_log_source(self, fn):
        self._log_source = fn

    def set_metrics_source(self, fn):
        self._metrics_source = fn

    def set_hang_dumper(self, dumper):
        """On a detected hang the agent collects all-rank Python stacks +
        pending device programs and ships them as a HangDumpRecord
        (reference manager.cc:454-464 gdb/py-spy dump)."""
        self._hang_dumper = dumper

    # -- failure-time decision ---------------------------------------------

    def diagnose_training_failure(self, failure: WorkerFailure) -> str:
        """Hardware or preemption signatures relaunch the node; any other
        failure (retryable, fatal or unclassified) restarts in place while
        the budget lasts, then relaunches. Logs the log tail's class."""
        kind = classify_log(failure.log_tail)
        budget_left = failure.restart_count < failure.max_restarts
        if kind == "hardware":
            action = WorkerAction.RELAUNCH_WORKER
        elif budget_left:
            action = WorkerAction.RESTART_WORKER
        else:
            action = WorkerAction.RELAUNCH_WORKER
        logger.warning(
            "node %s: worker failure (exit %s) classified %s -> %s "
            "(restarts %s/%s)", failure.node_id, failure.exit_code, kind,
            action, failure.restart_count, failure.max_restarts,
        )
        return action

    # -- periodic observation ----------------------------------------------

    def start(self):
        if self._client is None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._observe_loop, name="diagnosis-agent", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def _observe_loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.report_once()
            except Exception as e:
                logger.warning("diagnosis report failed: %s", e)

    def report_once(self):
        import json

        if self._log_source is not None:
            tail = self._log_source()
            if tail:
                self._client.report_diagnosis_data("TrainingLogRecord", tail)
        if self._metrics_source is not None:
            metrics = self._metrics_source()
            if metrics:
                self._client.report_diagnosis_data(
                    "TpuMetricsRecord", json.dumps(metrics)
                )
                if (
                    metrics.get("hang")
                    and self._hang_dumper is not None
                    and self._hang_dumper.should_dump()
                ):
                    logger.warning("node %s: the device timer flagged a "
                                   "hang, at %.3f; shipping a hang dump",
                                   self._node_id, time.time())
                    bundle = self._hang_dumper.dump(reason="tpu_timer_hang")
                    self._client.report_diagnosis_data(
                        "HangDumpRecord", json.dumps(bundle)
                    )

    def collect_and_ship_dump(
        self, reason: str = "master_request", min_interval: float = 20.0
    ) -> bool:
        """Master-orchestrated synchronized dump (CollectHangDump action):
        capture this host's worker stacks + pending programs NOW and ship
        them, regardless of the local hang heuristic. A short cooldown
        absorbs a re-broadcast while the previous dump is in flight."""
        import json

        if self._hang_dumper is None:
            logger.warning("collect-dump requested but no hang dumper wired")
            return False
        now = time.time()
        if now - getattr(self, "_last_forced_dump", 0.0) < min_interval:
            return False
        self._last_forced_dump = now
        bundle = self._hang_dumper.dump(reason=reason)
        self._client.report_diagnosis_data(
            "HangDumpRecord", json.dumps(bundle)
        )
        logger.info("shipped master-requested hang dump (%s) at %.3f",
                    reason, time.time())
        return True
