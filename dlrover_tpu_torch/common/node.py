"""In-memory node model held by the master: the port's own copy of
dlrover_tpu/common/node.py.

The field names are the JAX package's, the TPU topology fields (slice name,
torus coordinates) and the ``tpu_*`` resource fields included, so the
master's registry reads the same reports from either package's agents (a
GPU's memory occupancy goes into ``tpu_hbm_used_mb``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus


@dataclass
class NodeResource:
    """Resources of one node (TPU host)."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    tpu_chips: int = 0
    tpu_type: str = ""  # e.g. "v5p"
    tpu_duty_cycle: float = 0.0  # observed busy fraction (usage only)
    tpu_hbm_used_mb: float = 0.0  # observed HBM occupancy (usage only)
    gpu_num: int = 0


@dataclass
class NodeGroupResource:
    """Resource of a node group: replica count x per-node resource (the
    unit the optimizer's plans and the scalers move)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: Optional[int] = None,
               resource: Optional[NodeResource] = None):
        if count is not None and count >= 0:
            self.count = count
        if resource is not None:
            self.node_resource = resource


@dataclass
class TpuTopology:
    """Where the host sits in the TPU slice.

    ``coords`` are the torus coordinates of the host's first chip; rank
    sorting by these keeps collective rings on contiguous ICI links (the
    reference sorts by access switch, ``net_topology.py:53-79``).
    """

    slice_name: str = ""
    worker_index: int = -1  # host index inside the slice
    coords: tuple = ()


class Node:
    """One managed node (TPU host) and its lifecycle state."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.topology = TpuTopology()

        self.host_addr: str = ""
        self.host_port: int = 0
        self.host_node: str = ""  # k8s node name the pod landed on

        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0

        self.exit_reason: str = ""
        self.relaunch_count = 0
        self.max_relaunch_count = max_relaunch_count
        self.relaunchable = True
        self.is_released = False
        self.critical = False  # job fails if this node fails beyond budget
        self.paral_config: Dict = {}
        self.start_hang_time: float = 0.0
        self.reported_status: str = ""

    # -- state helpers ----------------------------------------------------

    def update_status(self, status: str):
        if status and status != NodeStatus.UNKNOWN:
            self.status = status
            if status == NodeStatus.RUNNING and self.start_time is None:
                self.start_time = time.time()
            if status in NodeStatus.terminal():
                self.finish_time = time.time()

    def update_heartbeat(self, ts: Optional[float] = None):
        self.heartbeat_time = ts if ts is not None else time.time()

    def is_unrecoverable_failure(self) -> bool:
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return True
        return self.relaunch_count >= self.max_relaunch_count

    def __repr__(self):  # pragma: no cover - debug aid
        return (
            f"Node(type={self.type}, id={self.id}, rank={self.rank_index}, "
            f"status={self.status})"
        )


@dataclass
class NodeEvent:
    """A platform event about a node (watch stream or heartbeat-derived)."""

    event_type: str
    node: Node
