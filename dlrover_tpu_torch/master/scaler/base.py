"""Scalers: execute a ScalePlan against the platform. The port's own copy
of dlrover_tpu/master/scaler/base.py (the ``Scaler`` interface, the
in-process ``LocalScaler`` of local mode and tests, ``shed_victims``); the
k8s pod scaler waits for the k8s master (ROADMAP 5b.3).
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.resource.plan import ScalePlan


def shed_victims(nodes: List[Node], n: int) -> List[Node]:
    """Scale-down victim policy shared by every scaler/manager: shed the
    highest ranks first so low ranks keep stable seats (dense ranks keep
    the process group's ranks contiguous after re-formation)."""
    return sorted(nodes, key=lambda node: -node.rank_index)[:n]


class Scaler(ABC):
    """Takes ScalePlans and makes the platform converge to them."""

    def __init__(self, job_name: str = ""):
        self._job_name = job_name
        self._lock = threading.Lock()

    @abstractmethod
    def scale(self, plan: ScalePlan):
        ...

    def cordon(self, host_node: str) -> bool:
        """Mark the cluster host unschedulable so replacements avoid it
        (hardware-fault reaction; platform-specific, default no-op)."""
        return False

    def start(self):
        pass

    def stop(self):
        pass


class LocalScaler(Scaler):
    """Standalone/test scaler: applies plans to the job context only.

    Node launches register INITIAL nodes (an external harness or test then
    brings agents up); removals mark nodes released. Records every plan so
    tests can assert on scaling decisions.
    """

    def __init__(
        self,
        job_name: str = "",
        node_type: str = NodeType.WORKER,
        job_context=None,
    ):
        super().__init__(job_name)
        self._node_type = node_type
        self.executed_plans: List[ScalePlan] = []
        self._job_context = (
            job_context if job_context is not None else JobContext()
        )

    def scale(self, plan: ScalePlan):
        if plan.empty():
            return
        with self._lock:
            self.executed_plans.append(plan)
            for node in plan.launch_nodes:
                self._job_context.update_node(node)
            for node in plan.remove_nodes:
                tracked = self._job_context.get_node(node.type, node.id)
                if tracked is not None:
                    tracked.is_released = True
                    tracked.relaunchable = False
            group = plan.node_group_resources.get(self._node_type)
            if group is not None and group.count > 0:
                self._converge_count(group.count)

    def _converge_count(self, target: int):
        alive = self._job_context.alive_nodes(self._node_type)
        if len(alive) > target:
            for node in shed_victims(alive, len(alive) - target):
                node.relaunchable = False
                node.is_released = True
                logger.info("local scaler: releasing node %s", node.id)
        elif len(alive) < target:
            for _ in range(target - len(alive)):
                node_id = self._job_context.next_node_id(self._node_type)
                self._job_context.update_node(
                    Node(self._node_type, node_id, status=NodeStatus.INITIAL)
                )
                logger.info("local scaler: requested node %s", node_id)
