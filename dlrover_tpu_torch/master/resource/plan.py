"""Resource and scale plans the optimizer produces and scalers execute: the
port's own copy of dlrover_tpu/master/resource/plan.py.

The scaling unit is a node (a host with a fixed number of cards, one
worker process a card), so plans move node counts and node-level CPU and
memory, never per-card resources.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.node import Node, NodeGroupResource, NodeResource


@dataclass
class ResourcePlan:
    """What the job *should* have: per-type group resources + tunables."""

    node_group_resources: Dict[str, NodeGroupResource] = field(default_factory=dict)
    node_resources: Dict[str, NodeResource] = field(default_factory=dict)  # per-node overrides, keyed by node name
    paral_config: Dict = field(default_factory=dict)  # runtime tunables (batch, accum)
    comment: str = ""
    #: contended hosts the brain's hot-host guard flagged — the
    #: autoscaler cordons these so replacements land elsewhere
    hot_hosts: List[str] = field(default_factory=list)

    def empty(self) -> bool:
        return (
            not self.node_group_resources
            and not self.node_resources
            and not self.hot_hosts
        )

    def merge(self, other: "ResourcePlan") -> "ResourcePlan":
        merged = ResourcePlan(
            node_group_resources=dict(self.node_group_resources),
            node_resources=dict(self.node_resources),
            paral_config=dict(self.paral_config),
            comment=self.comment or other.comment,
        )
        merged.hot_hosts = sorted(set(self.hot_hosts) | set(other.hot_hosts))
        merged.node_group_resources.update(other.node_group_resources)
        merged.node_resources.update(other.node_resources)
        merged.paral_config.update(other.paral_config)
        return merged


@dataclass
class ScalePlan:
    """The concrete delta a scaler executes."""

    node_group_resources: Dict[str, NodeGroupResource] = field(default_factory=dict)
    launch_nodes: List[Node] = field(default_factory=list)
    remove_nodes: List[Node] = field(default_factory=list)
    migrate_nodes: Dict[str, NodeResource] = field(default_factory=dict)
    paral_config: Dict = field(default_factory=dict)

    def empty(self) -> bool:
        return (
            not self.node_group_resources
            and not self.launch_nodes
            and not self.remove_nodes
            and not self.migrate_nodes
        )
