"""Job managers: node lifecycle management inside the master. The port's
own copy of dlrover_tpu/master/node/job_manager.py: the base job manager,
the heartbeat evictor and ``LocalJobManager``, the standalone variant (the
k8s-distributed one waits for ``dist_master``).

An evicted node's data shards go back in the task manager's queue
(``attach_task_manager``). The speed monitor, when wired, learns each
running worker as it joins, leaves or is evicted, as the JAX managers
feed it.
"""

from __future__ import annotations

import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import DiagnosisAction
from dlrover_tpu_torch.common.node import Node, NodeEvent
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.node.status_flow import get_node_state_flow


class JobManager(ABC):
    """Shared API the servicer and master loop program against."""

    def __init__(self, speed_monitor=None, error_monitor=None,
                 job_context=None):
        self._speed_monitor = speed_monitor
        self._error_monitor = error_monitor
        # the per-job context (the master's JobContainer slot)
        self._job_context = (
            job_context if job_context is not None else JobContext()
        )
        self._stopped = False
        # shed-aware liveness: the RPC admission gate records which node
        # each shed request came from (the node-id header), so the
        # heartbeat sweep can tell "silent" from "silenced by my own
        # backpressure"
        self._gate = None
        # eviction must also re-enqueue the dead node's data shards
        self._task_manager = None

    def attach_gate(self, gate) -> None:
        self._gate = gate

    def attach_task_manager(self, task_manager) -> None:
        self._task_manager = task_manager

    def _shed_recently(self, node_id: int, window_s: float, now: float) -> bool:
        """True when the admission gate shed a request from this node
        within the window: the node IS alive and talking — the master
        just refused to listen. Evicting it would punish the victim of
        the master's own overload."""
        if self._gate is None:
            return False
        try:
            return self._gate.recently_shed(node_id, window_s, now=now)
        except AttributeError:  # pre-header gate object
            return False

    @abstractmethod
    def start(self):
        ...

    @abstractmethod
    def stop(self):
        ...

    # -- node reports -------------------------------------------------------

    def update_node_resource_usage(
        self, node_type: str, node_id: int, cpu: float, memory_mb: float, **kw
    ):
        node = self._job_context.get_node(node_type, node_id)
        if node is None:
            return
        node.used_resource.cpu = cpu
        node.used_resource.memory_mb = memory_mb
        duty = kw.get("tpu_duty_cycle")
        if duty is not None:
            node.used_resource.tpu_duty_cycle = float(duty)
        hbm = kw.get("tpu_hbm_used_mb")
        if hbm is not None and float(hbm) > 0:
            # device memory occupancy (a GPU's too, under the JAX
            # package's field name); 0 readings keep the last real
            # observation rather than erasing it
            node.used_resource.tpu_hbm_used_mb = float(hbm)

    def collect_node_heartbeat(
        self, node_type: str, node_id: int, ts: float
    ) -> Optional[DiagnosisAction]:
        node = self._job_context.get_node(node_type, node_id)
        if node is not None:
            node.update_heartbeat(ts)
        return self._job_context.next_action(node_id)

    def update_node_address(
        self, node_type: str, node_id: int, addr: str, port: int = 0,
        slice_name: str = "", coords=(),
    ):
        node = self._job_context.get_node(node_type, node_id)
        if node is None:
            return
        node.host_addr = addr
        node.host_port = port
        node.topology.slice_name = slice_name
        node.topology.coords = tuple(coords)
        if node.status == NodeStatus.INITIAL:
            node.update_status(NodeStatus.PENDING)

    def update_node_reported_status(self, node_type: str, node_id: int, status: str):
        node = self._job_context.get_node(node_type, node_id)
        if node is not None:
            node.reported_status = status

    def handle_training_failure(
        self,
        node_type: str,
        node_id: int,
        restart_count: int = -1,
        error_data: str = "",
        level: str = TrainingExceptionLevel.ERROR,
        exit_code: int = 1,
    ):
        node = self._job_context.get_node(node_type, node_id)
        if node is None:
            return
        logger.warning(
            "training failure on %s-%s (restart=%s, level=%s): %s",
            node_type,
            node_id,
            restart_count,
            level,
            error_data[:500],
        )
        if level == TrainingExceptionLevel.ERROR:
            node.exit_reason = _classify_error(error_data, exit_code)
        if self._error_monitor is not None:
            self._error_monitor.process_error(
                node_type, node_id, error_data, level
            )

    def handle_node_succeeded(self, node_type: str, node_id: int):
        node = self._job_context.get_node(node_type, node_id)
        if node is not None:
            node.update_status(NodeStatus.SUCCEEDED)

    # -- queries --------------------------------------------------------------

    def all_workers_exited(self) -> bool:
        return not self._job_context.alive_nodes(NodeType.WORKER)

    def all_workers_succeeded(self) -> bool:
        workers = self._job_context.workers().values()
        return bool(workers) and all(
            n.status == NodeStatus.SUCCEEDED for n in workers
        )

    def any_worker_failed_fatally(self) -> bool:
        return any(
            n.status == NodeStatus.FAILED and n.is_unrecoverable_failure()
            for n in self._job_context.workers().values()
        )


#: consecutive heartbeat sweeps a RUNNING worker stays past the heartbeat
#: timeout before it is evicted (the JAX package's default)
EVICT_HYSTERESIS = 2


class HeartbeatEvictor:
    """Eviction policy with hysteresis, shared by the local and
    distributed job managers.

    A RUNNING worker silent past ``timeout`` is a *suspect*; only after
    ``hysteresis`` CONSECUTIVE monitor sweeps over the threshold is it
    evicted — one lost report window, a GC-of-death pause or a clock
    jump must not drop a healthy node out of the rendezvous. One
    in-time heartbeat clears the strikes. ``reconcile`` is the return
    path: a heartbeat from an evicted id means the partition healed, so
    the node is revived instead of being treated as a stranger."""

    def __init__(self, timeout: float, hysteresis: int = EVICT_HYSTERESIS):
        self.timeout = float(timeout)
        self.hysteresis = max(1, int(hysteresis))
        self._strikes: Dict[int, int] = {}
        self._evicted: set = set()

    def observe(self, node_id: int, silent_s: float) -> bool:
        """Fold one sweep's observation; True = evict now (exactly once
        per silence episode)."""
        if silent_s <= self.timeout:
            self._strikes.pop(node_id, None)
            return False
        if node_id in self._evicted:
            return False
        strikes = self._strikes.get(node_id, 0) + 1
        self._strikes[node_id] = strikes
        if strikes < self.hysteresis:
            return False
        self._evicted.add(node_id)
        return True

    def reconcile(self, node_id: int) -> bool:
        """A sign of life from the node; True iff it had been evicted
        (the caller revives it)."""
        self._strikes.pop(node_id, None)
        if node_id in self._evicted:
            self._evicted.discard(node_id)
            return True
        return False


#: the CUDA counterparts of the TPU hardware faults above, lower case
CUDA_HARDWARE_ERRORS = (
    "uncorrectable ecc error", "xid", "fallen off the bus",
)


def _classify_error(error_data: str, exit_code: int) -> str:
    """Map a failure report to a NodeExitReason (drives relaunch policy)."""
    text = (error_data or "").lower()
    if "out of memory" in text or "oom" in text or "resource_exhausted" in text:
        return NodeExitReason.OOM
    if "preempt" in text or exit_code in (-15, 143):
        return NodeExitReason.PREEMPTED
    if any(
        k in text
        for k in ("hbm", "ici link", "chip failure", "data_loss", "internal: tpu")
        + CUDA_HARDWARE_ERRORS
    ):
        return NodeExitReason.HARDWARE_ERROR
    if exit_code in (1, 2) and text:
        return NodeExitReason.FATAL_ERROR
    return NodeExitReason.UNKNOWN_ERROR


class LocalJobManager(JobManager):
    """Standalone-mode manager: the nodes are local agent processes.

    No platform watcher; node death is detected by heartbeat timeout. Used
    by ``--standalone`` runs and the in-process test harness.
    """

    def __init__(
        self,
        speed_monitor=None,
        heartbeat_timeout: float = DefaultValues.SEC_HEARTBEAT_TIMEOUT,
        error_monitor=None,
        rdzv_managers=None,
        eviction_hysteresis: int = EVICT_HYSTERESIS,
        clock=None,
        job_context=None,
    ):
        super().__init__(speed_monitor, error_monitor,
                         job_context=job_context)
        self._heartbeat_timeout = heartbeat_timeout
        # rendezvous managers, when wired, get a dead node's waiting
        # slot released at eviction so a pending round stops stalling
        # on a partitioned worker
        self._rdzv_managers = rdzv_managers or {}
        self._evictor = HeartbeatEvictor(
            heartbeat_timeout, eviction_hysteresis
        )
        # injectable "now": registration stamps and eviction sweeps share
        # the clock that stamps the heartbeats themselves
        self._clock = clock or time.time
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    def start(self):
        self._stop_evt.clear()
        self._monitor_thread = threading.Thread(
            target=self._monitor_heartbeats, name="heartbeat-monitor", daemon=True
        )
        self._monitor_thread.start()

    def stop(self):
        self._stopped = True
        self._stop_evt.set()

    def add_node(self, node_type: str, node_id: int, **kw) -> Node:
        node = Node(node_type, node_id, **kw)
        node.update_status(NodeStatus.RUNNING)
        node.update_heartbeat(self._clock())
        self._job_context.update_node(node)
        if self._speed_monitor is not None:
            self._speed_monitor.add_running_worker(node_type, node_id)
        return node

    def get_or_register_node(self, node_type: str, node_id: int) -> Node:
        node = self._job_context.get_node(node_type, node_id)
        if node is None:
            node = self.add_node(node_type, node_id)
        return node

    def collect_node_heartbeat(
        self, node_type: str, node_id: int, ts: float
    ) -> Optional[DiagnosisAction]:
        """A heartbeat from an unknown node re-adopts it: agents only
        report their address once at boot, so a relaunched master learns
        its surviving workers from their next heartbeat. A heartbeat
        from an EVICTED node means the partition healed — revive it
        (status back to RUNNING, re-counted as a running worker) instead
        of leaving a live node marked dead."""
        node = self.get_or_register_node(node_type, node_id)
        if self._evictor.reconcile(node_id) and node.status == NodeStatus.FAILED:
            logger.info(
                "node %s-%s returned after heartbeat eviction; reconciling",
                node_type, node_id,
            )
            node.exit_reason = ""
            node.update_status(NodeStatus.RUNNING)
            if self._speed_monitor is not None:
                self._speed_monitor.add_running_worker(node_type, node_id)
        return super().collect_node_heartbeat(node_type, node_id, ts)

    def handle_node_succeeded(self, node_type: str, node_id: int):
        # re-adopt before marking: a worker that outlived a master
        # relaunch must still conclude the job when it finishes
        self.get_or_register_node(node_type, node_id)
        super().handle_node_succeeded(node_type, node_id)

    def handle_node_event(self, event: NodeEvent):
        node = self._job_context.get_node(event.node.type, event.node.id)
        if node is None:
            self._job_context.update_node(event.node)
            return
        flow = get_node_state_flow(node.status, event.event_type, event.node.status)
        if flow is None:
            return
        node.update_status(flow.to_status)
        if flow.to_status in (NodeStatus.FAILED, NodeStatus.DELETED):
            if self._speed_monitor is not None:
                self._speed_monitor.remove_running_worker(node.type, node.id)

    def _monitor_heartbeats(self):
        while not self._stop_evt.wait(DefaultValues.SEC_MONITOR_INTERVAL):
            self.sweep_heartbeats()

    def sweep_heartbeats(self, now: Optional[float] = None) -> List[int]:
        """One eviction sweep (the monitor thread's body). Returns the
        node ids evicted this sweep."""
        now = now if now is not None else self._clock()
        evicted: List[int] = []
        for node in list(self._job_context.workers().values()):
            if node.status != NodeStatus.RUNNING or node.heartbeat_time <= 0:
                continue
            silent = now - node.heartbeat_time
            if silent > self._heartbeat_timeout and self._shed_recently(
                node.id, self._heartbeat_timeout, now
            ):
                # the gate shed this node's report inside the timeout
                # window: it is alive, the master silenced it — clear
                # its strikes instead of walking it toward eviction
                self._evictor.observe(node.id, 0.0)
                continue
            if self._evictor.observe(node.id, silent):
                self._evict_node(node, silent)
                evicted.append(node.id)
        return evicted

    def _evict_node(self, node: Node, silent_s: float):
        """Declare a heartbeat-silent worker dead: FAILED status (drops
        it from the running-worker set), rendezvous slot released so a
        pending round stops waiting on it, straggler and digest state
        forgotten so its stale p50 stops skewing the fleet median, data
        shards requeued."""
        logger.warning(
            "node %s-%s heartbeat-silent %.0fs (> %.0fs timeout for %d "
            "sweeps); evicting",
            node.type, node.id, silent_s, self._heartbeat_timeout,
            self._evictor.hysteresis,
        )
        node.exit_reason = NodeExitReason.UNKNOWN_ERROR
        self.handle_node_event(
            NodeEvent(
                NodeEventType.MODIFIED,
                Node(node.type, node.id, status=NodeStatus.FAILED),
            )
        )
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(node.id)
        if self._speed_monitor is not None:
            self._speed_monitor.evict_worker(node.type, node.id)
        if self._task_manager is not None:
            # the evicted node's leased shards go back in the queue now
            # (at-least-once); the fence bump keeps its zombie reports
            # from double-counting
            self._task_manager.remove_node_tasks(node.id)
