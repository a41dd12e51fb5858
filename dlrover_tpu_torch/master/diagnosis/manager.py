"""Master-side diagnosis: collect observations, run the chain, emit
actions. The port's own copy of dlrover_tpu/master/diagnosis/manager.py.

Every ``interval_secs`` (by default the master config's
``seconds_diagnosis_interval``, re-read each cycle) the manager poses the hang and the failure
problems to the inference chain (diagnosis/operators.py) over what the
agents shipped (``collect_diagnosis_data``, routed by the servicer) and
turns each resolved action into node actions: a ``CollectHangDump`` to
every worker when a hang is confirmed, then one ``RestartWorker`` each
whose reason names the frame the fleet is parked in (``stuck_at``) and the
slowest node; a restart or a relaunch for a failed node. Actions land in
the job context's action queue and ride back to the agents on their
heartbeat replies; each enqueued action is logged.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.diagnosis import actions
from dlrover_tpu_torch.diagnosis.data import DiagnosisDataManager, parse_report
from dlrover_tpu_torch.diagnosis.inference import (
    Inference,
    InferenceAttribute,
    InferenceChain,
    InferenceName,
)
from dlrover_tpu_torch.diagnosis.operators import (
    HANG_PROBLEM,
    FAILURE_PROBLEM,
    CheckFailureNodeOperator,
    CheckTrainingHangOperator,
    ResolveFailureNodeOperator,
    ResolveTrainingHangOperator,
)


class DiagnosisManager:
    def __init__(
        self,
        speed_monitor=None,
        interval_secs: Optional[float] = None,
        data_expire_secs: float = 600.0,
        job_context=None,
        config=None,
    ):
        if job_context is None:
            from dlrover_tpu_torch.master.node.job_context import JobContext

            job_context = JobContext()
        if config is None:
            config = MasterConfigContext()
        self._job_context = job_context
        self._data_manager = DiagnosisDataManager(data_expire_secs)
        self._speed_monitor = speed_monitor
        self._config = config
        self._interval_override = interval_secs
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._operators = [
            CheckTrainingHangOperator(
                self._data_manager, speed_monitor, config=config
            ),
            CheckFailureNodeOperator(self._data_manager),
            ResolveTrainingHangOperator(self._data_manager),
            ResolveFailureNodeOperator(self._data_manager),
        ]

    @property
    def _interval(self) -> float:
        if self._interval_override is not None:
            return self._interval_override
        return self._config.seconds_diagnosis_interval

    @property
    def data_manager(self) -> DiagnosisDataManager:
        return self._data_manager

    # -- ingestion (called by the servicer) --------------------------------

    def collect_diagnosis_data(self, report: msg.DiagnosisReportData):
        rec = parse_report(
            report.data_cls,
            report.data_content,
            node_id=report.node_id,
            node_type=report.node_type,
            node_rank=report.node_rank,
        )
        self._data_manager.store_data(rec)

    # -- pre-check hook -----------------------------------------------------

    def pre_check(self) -> str:
        """Hook run before training starts (reference: pre-check). The
        TPU build gates on the network-check rendezvous instead; always
        passes here unless a subclass overrides."""
        return "pass"

    # -- periodic observe+resolve ------------------------------------------

    def start_observing(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._observe_loop, name="diagnosis-manager", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=self._interval + 5)

    def _observe_loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.diagnose_once()
            except Exception:
                logger.exception("diagnosis cycle failed")

    def diagnose_once(self) -> List[Inference]:
        """One observe+resolve cycle; returns terminal facts (for tests)."""
        chain = InferenceChain([HANG_PROBLEM, FAILURE_PROBLEM], self._operators)
        facts = chain.infer()
        for fact in facts:
            self._act_on(fact)
        return facts

    def _enqueue(self, action):
        self._job_context.enqueue_action(action)
        logger.info("diagnosis: enqueued %s for node %s: %s",
                    action.action_cls, action.instance, action.action_content)

    def _act_on(self, fact: Inference):
        if fact.name != InferenceName.ACTION or fact.attribution != InferenceAttribute.IS:
            return
        cfg = fact.config()
        if fact.description == "collect_dumps":
            # orchestrated all-rank debug dump: every agent captures its
            # workers' stacks and ships them before the restart decision
            for node in self._job_context.workers().values():
                self._enqueue(
                    actions.collect_dump(
                        node.id, reason=cfg.get("reason", "hang")
                    )
                )
            logger.warning(
                "diagnosis: hang confirmed -> requested synchronized dump "
                "from %d workers", len(self._job_context.workers()),
            )
        elif fact.description == "restart_all":
            # the hang resolver may have summarized shipped hang dumps —
            # carry the stuck frame into the action reason and the event
            # log so the restart names WHERE the fleet was parked
            reason = cfg.get("reason", "hang")
            stuck_at = cfg.get("stuck_at", "")
            if stuck_at:
                reason = f"{reason} @ {stuck_at}"
            slowest = cfg.get("slowest_node", "")
            if slowest:
                reason = f"{reason} [slowest node {slowest}]"
            for node in self._job_context.workers().values():
                self._enqueue(
                    actions.restart_worker(node.id, reason=reason)
                )
            logger.warning(
                "diagnosis: training hang -> restart all workers%s%s%s",
                f" (stuck at {stuck_at})" if stuck_at else "",
                (
                    f" (pending: {cfg['pending_programs']})"
                    if cfg.get("pending_programs")
                    else ""
                ),
                (
                    f" (mfu ranking slowest-first: {cfg['mfu_ranking']})"
                    if cfg.get("mfu_ranking")
                    else ""
                ),
            )
        elif fact.description == "restart":
            node_id = int(cfg.get("node_id", -1))
            self._enqueue(
                actions.restart_worker(node_id, reason=cfg.get("kind", ""))
            )
        elif fact.description == "relaunch":
            node_id = int(cfg.get("node_id", -1))
            self._enqueue(
                actions.relaunch_worker(node_id, reason=cfg.get("kind", ""))
            )
            logger.warning("diagnosis: node %s -> relaunch", node_id)
