"""Agent-side rendezvous handler backed by the master: the port's own copy
of dlrover_tpu/agent/rendezvous.py.

Join, poll the comm world, derive this node's rank. The completed world
gives the workers' process-group bootstrap (coordinator address, number of
processes, this node's first process id): ``train/bootstrap.py`` forms the
world at ``tcp://<coordinator_addr>``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.rpc import policy as rpc_policy

#: seconds a node waits for a rendezvous round to seat it (the JAX
#: handler's default)
JOIN_TIMEOUT_S = 600.0


class RendezvousTimeoutError(Exception):
    pass


@dataclass
class CommWorld:
    """The agent's view of a completed rendezvous."""

    rdzv_round: int = 0
    group: int = 0
    node_rank: int = -1
    world_size: int = 0  # number of nodes (hosts)
    num_processes: int = 0  # total worker processes = sum of local worlds
    process_id_base: int = 0  # first process id owned by this node
    coordinator_addr: str = ""
    members: Dict[int, Tuple[int, int, str, int]] = field(default_factory=dict)
    # members: node_rank -> (node_id, local_world_size, ip, port)
    slice_names: Dict[int, str] = field(default_factory=dict)
    # slice_names: node_rank -> the slice the node belongs to ("" if N/A)

    @property
    def n_slices(self) -> int:
        """Distinct slices in the seated world (>= 1; the JAX package sizes
        its multislice mesh from it, and the agent passes it to workers)."""
        names = {s for s in self.slice_names.values() if s}
        return max(len(names), 1)


class MasterRendezvousHandler:
    def __init__(
        self,
        client: MasterClient,
        rdzv_name: str = RendezvousName.TRAINING,
        local_world_size: int = 1,
        node_ip: str = "",
        node_port: int = 0,
    ):
        self._client = client
        self.rdzv_name = rdzv_name
        self.local_world_size = local_world_size
        self.node_ip = node_ip
        self.node_port = node_port

    def next_rendezvous(self, node_rank_hint: int = -1) -> CommWorld:
        """Join and block until a *new* round seats this node.

        The round guard (only accept rdzv_round > the round at join time)
        prevents a rejoining node — or its still-seated peers — from acting
        on the stale previous world whose coordinator is already dead.
        """
        rank_hint = node_rank_hint if node_rank_hint >= 0 else self._client.node_id
        start_round = self._client.join_rendezvous(
            node_rank=rank_hint,
            local_world_size=self.local_world_size,
            rdzv_name=self.rdzv_name,
            node_ip=self.node_ip,
            node_port=self.node_port,
        )
        deadline = time.time() + JOIN_TIMEOUT_S
        delays = rpc_policy.poll_intervals()
        while time.time() < deadline:
            resp = self._client.get_comm_world(self.rdzv_name)
            if (
                resp.completed
                and resp.world
                and resp.rdzv_round > start_round
                and any(
                    info[0] == self._client.node_id
                    for info in resp.world.values()
                )
            ):
                return self._build_comm_world(resp)
            # the shared jittered, growing schedule: a fleet of waiters
            # polling the incomplete world de-phases instead of hitting
            # the master in lockstep
            time.sleep(next(delays))
        raise RendezvousTimeoutError(
            f"rendezvous {self.rdzv_name} (joined round {start_round}) "
            f"not completed within {JOIN_TIMEOUT_S}s"
        )

    def _build_comm_world(self, resp) -> CommWorld:
        members: Dict[int, Tuple[int, int, str, int]] = {}
        for rank_str, info in resp.world.items():
            node_id, local_ws, ip, port = info[:4]
            members[int(rank_str)] = (node_id, local_ws, ip, port)
        slice_names = {
            int(rank): name or ""
            for rank, name in (getattr(resp, "slice_names", None)
                               or {}).items()
        }
        my_rank = -1
        for rank in sorted(members):
            if members[rank][0] == self._client.node_id:
                my_rank = rank
                break
        num_processes = sum(m[1] for m in members.values())
        process_id_base = sum(
            members[r][1] for r in sorted(members) if r < my_rank
        )
        world = CommWorld(
            rdzv_round=resp.rdzv_round,
            group=resp.group,
            node_rank=my_rank,
            world_size=len(members),
            num_processes=num_processes,
            process_id_base=process_id_base,
            coordinator_addr=resp.coordinator_addr,
            members=members,
            slice_names=slice_names,
        )
        logger.info(
            "node %s: rendezvous %s round %s -> rank %s/%s, coordinator %s",
            self._client.node_id,
            self.rdzv_name,
            world.rdzv_round,
            world.node_rank,
            world.world_size,
            world.coordinator_addr,
        )
        return world

    def num_nodes_waiting(self) -> int:
        return self._client.num_nodes_waiting(self.rdzv_name)
