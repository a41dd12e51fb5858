"""Topology-aware rank sorting: the port's own copy of
dlrover_tpu/master/rendezvous/net_topology.py.

Hosts sort by (slice, torus coordinates, worker index), so neighbouring
ranks are link-adjacent; nodes without topology info keep their join
order. On GPU hosts the slice name and coordinates are empty unless the
platform sets them, and the order is the nodes' ranks.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_NUM_RE = re.compile(r"(\d+)")


def _natural_key(name: str) -> Tuple:
    """'slice-10' sorts after 'slice-2' (plain lexicographic would not),
    so rank blocks follow the operator's slice numbering."""
    return tuple(
        int(tok) if tok.isdigit() else tok
        for tok in _NUM_RE.split(name)
    )


@dataclass
class NodeTopologyMeta:
    node_id: int = -1
    node_rank: int = -1
    process_num: int = 1  # local world size (chips per host process)
    node_ip: str = ""
    node_port: int = 0
    slice_name: str = ""
    coords: Tuple = field(default_factory=tuple)
    join_time: float = 0.0


class TpuTopologySorter:
    """Assign ranks so ICI neighbours get adjacent ranks."""

    def sort(self, nodes: Dict[int, NodeTopologyMeta]) -> Dict[int, NodeTopologyMeta]:
        """Return {new_rank: meta} ordered by slice then torus coords.

        Nodes without topology info keep join-order (stable by previous rank
        then node_id) so the sort is deterministic either way.
        """
        metas: List[NodeTopologyMeta] = list(nodes.values())
        metas.sort(
            key=lambda m: (
                _natural_key(m.slice_name),
                tuple(m.coords) if m.coords else (),
                m.node_rank if m.node_rank >= 0 else m.node_id,
                m.node_id,
            )
        )
        out: Dict[int, NodeTopologyMeta] = {}
        for new_rank, m in enumerate(metas):
            out[new_rank] = m
        return out
