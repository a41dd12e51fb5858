"""Legal node status transitions: the port's own copy of
dlrover_tpu/master/node/status_flow.py.

The flow table prevents stale platform events from regressing a node's
status (e.g. a late PENDING event after the node already RUNNING).
"""

from __future__ import annotations

from dataclasses import dataclass

from dlrover_tpu_torch.common.constants import NodeStatus


@dataclass(frozen=True)
class NodeStateFlow:
    from_status: str
    to_status: str
    should_relaunch: bool = False


ALLOWED_TRANSITIONS = [
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.PENDING),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.RUNNING),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.FAILED, should_relaunch=True),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.DELETED, should_relaunch=True),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.RUNNING),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.SUCCEEDED),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.FAILED, should_relaunch=True),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.DELETED, should_relaunch=True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.SUCCEEDED),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.FAILED, should_relaunch=True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.DELETED, should_relaunch=True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.BREAKDOWN, should_relaunch=True),
    NodeStateFlow(NodeStatus.SUCCEEDED, NodeStatus.DELETED),
    NodeStateFlow(NodeStatus.FAILED, NodeStatus.DELETED),
    NodeStateFlow(NodeStatus.BREAKDOWN, NodeStatus.DELETED),
]

_FLOW_TABLE = {(f.from_status, f.to_status): f for f in ALLOWED_TRANSITIONS}


def get_node_state_flow(from_status: str, event_type: str, to_status: str):
    """Return the flow for this transition, or None if it is illegal/no-op."""
    from dlrover_tpu_torch.common.constants import NodeEventType

    if event_type == NodeEventType.DELETED:
        to_status = NodeStatus.DELETED
    if from_status == to_status:
        return None
    return _FLOW_TABLE.get((from_status, to_status))
