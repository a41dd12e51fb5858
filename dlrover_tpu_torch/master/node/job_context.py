"""In-memory DB of job nodes + diagnosis action queue: the port's own copy
of dlrover_tpu/master/node/job_context.py.

Thread-safe: the servicer's handler threads and the heartbeat monitor all
touch it. Beside the JAX package's registry it keeps each node's last
reported checkpoint step (``CheckpointStepReport``), which the port's
master states when it exits: the JAX master hands only the report's
blocking seconds to its speed monitor, which keeps no step.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.messages import DiagnosisAction
from dlrover_tpu_torch.common.node import Node


class DiagnosisActionQueue:
    """Per-instance queues of pending diagnosis actions with expiry."""

    def __init__(self):
        self._actions: Dict[int, List[DiagnosisAction]] = {}
        self._lock = threading.Lock()

    def add_action(self, action: DiagnosisAction):
        with self._lock:
            q = self._actions.setdefault(action.instance, [])
            # dedupe identical pending actions
            for a in q:
                if (
                    a.action_cls == action.action_cls
                    and a.action_content == action.action_content
                ):
                    return
            q.append(action)

    def next_action(self, instance: int) -> Optional[DiagnosisAction]:
        now = time.time()
        with self._lock:
            q = self._actions.get(instance, [])
            while q:
                action = q.pop(0)
                if action.expired_ts <= 0 or action.expired_ts > now:
                    return action
            return None


class JobContext:
    """All mutable job state the master holds, keyed by (type, id). One
    instance per job, owned by the master's ``JobContainer``."""

    def __init__(self):
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self._lock = threading.RLock()
        self._action_queue = DiagnosisActionQueue()
        #: node id -> the last checkpoint step it reported
        self._ckpt_steps: Dict[int, int] = {}

    # -- nodes ------------------------------------------------------------

    def update_node(self, node: Node):
        with self._lock:
            self._nodes.setdefault(node.type, {})[node.id] = node

    def get_node(self, node_type: str, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_type, {}).get(node_id)

    def nodes_of_type(self, node_type: str) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes.get(node_type, {}))

    def workers(self) -> Dict[int, Node]:
        return self.nodes_of_type(NodeType.WORKER)

    def running_nodes(self, node_type: str = NodeType.WORKER) -> List[Node]:
        return [
            n
            for n in self.nodes_of_type(node_type).values()
            if n.status == NodeStatus.RUNNING and not n.is_released
        ]

    def alive_nodes(self, node_type: str = NodeType.WORKER) -> List[Node]:
        return [
            n
            for n in self.nodes_of_type(node_type).values()
            if n.status in (NodeStatus.INITIAL, NodeStatus.PENDING,
                            NodeStatus.RUNNING)
            and not n.is_released
        ]

    def next_node_id(self, node_type: str) -> int:
        """The id a newly requested node of ``node_type`` gets (the
        local scaler's launches)."""
        with self._lock:
            nodes = self._nodes.get(node_type, {})
            return max(nodes.keys(), default=-1) + 1

    # -- checkpoint steps ----------------------------------------------------

    def record_ckpt_step(self, node_id: int, step: int):
        with self._lock:
            self._ckpt_steps[int(node_id)] = int(step)

    def ckpt_steps(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._ckpt_steps)

    # -- diagnosis actions -------------------------------------------------

    def enqueue_action(self, action: DiagnosisAction):
        self._action_queue.add_action(action)

    def next_action(self, instance: int) -> Optional[DiagnosisAction]:
        return self._action_queue.next_action(instance)
