"""Master-side rendezvous managers: the port's own copy of
dlrover_tpu/master/rendezvous/manager.py.

- ``ElasticTrainingRendezvousManager`` collects joining nodes, completes a
  round when max nodes joined or (>= min nodes and the waiting timeout
  elapsed), rounds the world size down to a multiple of ``node_unit``,
  sorts ranks by topology and publishes the comm world, with the
  coordinator address (rank 0's host and port) the workers form their
  process group at.
- ``NetworkCheckRendezvousManager`` pairs nodes into groups for the
  pairwise device and link check, over two rounds that localize fault
  nodes and stragglers.

The hang watchdog's re-form signal (``request_re_rendezvous``: a virtual
waiter until the next round completes), ``latest_world_ids`` and the
goodput planner's growth gate are the JAX package's. The gate
(``set_growth_gate``, brain/planner.py): waiting capacity that would only
grow a healthy seated world (``_pure_growth``: a round exists, every
seated member is alive, no waiting node is a seated member re-joining) is
advertised as 0 waiters and cannot complete a round until the planner's
executed plan opens the gate. Recovery never waits: a dead seated member,
a member re-joining and the watchdog's virtual waiter all bypass it. The
alive-node set the published snapshot carries (``world_snapshot``) is
what tells growth from recovery.

One difference from the JAX manager (``_growth_holds_round``): while the
open gate lets an executed plan grow a healthy seated world, a round
completes only once every seated member has re-joined. The JAX manager
lets the joiners complete a round on their own once the last-call window
has passed since their join, which at the local master's 60 s window
seats a joiner that waited behind the gate alone while the seated node
is still persisting its breakpoint.
"""

from __future__ import annotations

import dataclasses
import time
from abc import ABC, abstractmethod
from threading import Lock
from typing import Dict, FrozenSet, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    NetworkFailureReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.rendezvous.net_topology import (
    NodeTopologyMeta,
    TpuTopologySorter,
)


class RendezvousParameters:
    def __init__(
        self,
        min_nodes: int,
        max_nodes: int,
        waiting_timeout: Optional[float] = None,  # None -> live config
        node_unit: int = 1,
        join_timeout: float = DefaultValues.SEC_MASTER_JOIN_TIMEOUT,
    ):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = waiting_timeout
        self.node_unit = max(1, node_unit)
        self.join_timeout = join_timeout


@dataclasses.dataclass(frozen=True)
class _WorldSnapshot:
    """Immutable published view of one rendezvous manager's state: the
    world-poll fast path (a fleet's join and world polls would otherwise
    take the manager lock and copy the world dict on every poll).

    Copy-on-change: every MUTATION rebuilds the snapshot under the
    lock (``_publish_locked``) and publishes it with one atomic
    reference store; polls read the current reference with NO lock and
    NO copy. Consumers must treat ``rdzv_nodes`` as read-only — the
    dict is shared by every concurrent poll (the servicer serializes
    it; nothing mutates seated metas between completions, which build
    a fresh dict)."""

    round: int = 0
    rdzv_nodes: Dict[int, "NodeTopologyMeta"] = dataclasses.field(
        default_factory=dict
    )
    rdzv_ids: FrozenSet[int] = frozenset()
    waiting_ids: FrozenSet[int] = frozenset()
    num_waiting: int = 0
    force_reform: bool = False
    coordinator: str = ""
    latest_world: Tuple[int, ...] = ()
    alive_ids: FrozenSet[int] = frozenset()


class RendezvousManager(ABC):
    def __init__(self, name: str, clock=None, config=None):
        self.name = name
        self._lock = Lock()
        # the per-job runtime-mutable config: rdzv_waiting_timeout is
        # re-read per completion check, so an operator's update retunes a
        # running job's last-call window
        self._config = config if config is not None else MasterConfigContext()
        # injectable "now": the waiting-timeout completion path and the
        # join stamps share one clock
        self._clock = clock or time.time
        self._params = RendezvousParameters(1, 1)
        self._alive_nodes: set = set()
        self._waiting_nodes: Dict[int, NodeTopologyMeta] = {}
        self._rdzv_nodes: Dict[int, NodeTopologyMeta] = {}
        self._lastcall_time: float = 0.0
        self._latest_rdzv_nodes: List[int] = []
        self._rdzv_round = 0
        self._start_rdzv_ts: float = 0.0
        self._node_unit = 1
        self._topology_sorter = TpuTopologySorter()
        # the hang watchdog's re-form signal: while set, workers polling
        # num_nodes_waiting see a virtual waiter and drop back into the
        # rendezvous; the next completed round clears it
        self._force_reform = False
        # the poll fast path: an immutable snapshot rebuilt on every
        # MUTATION (copy-on-change) and read lock-free by the storms of
        # get_comm_world / num_nodes_waiting polls. The reference store
        # is atomic in CPython; readers grab one coherent version.
        self._snapshot = _WorldSnapshot()
        # the planner's growth gate (brain/planner.py): scale-out is a
        # choice, so waiting capacity that would only grow a healthy
        # seated world is advertised (and may complete a round) only when
        # the gate approves. Recovery is never gated. None = no planner.
        self._growth_gate = None

    def _publish_locked(self):
        """Rebuild the published snapshot. Caller holds the lock."""
        self._snapshot = _WorldSnapshot(
            round=self._rdzv_round,
            rdzv_nodes=dict(self._rdzv_nodes),
            rdzv_ids=frozenset(
                m.node_id for m in self._rdzv_nodes.values()
            ),
            waiting_ids=frozenset(
                m.node_id for m in self._waiting_nodes.values()
            ),
            num_waiting=len(self._waiting_nodes),
            force_reform=self._force_reform,
            coordinator=self.coordinator_addr(),
            latest_world=tuple(self._latest_rdzv_nodes),
            alive_ids=frozenset(self._alive_nodes),
        )

    def world_snapshot(self) -> _WorldSnapshot:
        """The current published view (lock-free; the planner's
        observation, tests and metrics)."""
        return self._snapshot

    def update_rdzv_params(
        self, min_nodes: int, max_nodes: int, node_unit: int,
        waiting_timeout: Optional[float] = None,
    ):
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, waiting_timeout, node_unit
            )
            self._node_unit = max(1, node_unit)

    def get_rdzv_round(self) -> int:
        return self._rdzv_round

    def add_alive_node(self, node_id: int):
        with self._lock:
            if node_id not in self._alive_nodes:
                self._alive_nodes.add(node_id)
                # the snapshot carries alive_ids (the gate's recovery vs
                # growth distinction): republish on a liveness change
                self._publish_locked()

    def remove_alive_node(self, node_id: int):
        """Node died: drop it so a pending rendezvous does not stall on it."""
        with self._lock:
            changed = node_id in self._alive_nodes
            self._alive_nodes.discard(node_id)
            removed = None
            for rank, meta in list(self._waiting_nodes.items()):
                if meta.node_id == node_id:
                    removed = rank
                    break
            if removed is not None:
                del self._waiting_nodes[removed]
                logger.info(
                    "%s rdzv: removed dead node %s from waiting list",
                    self.name,
                    node_id,
                )
            if changed or removed is not None:
                self._publish_locked()

    def join_rendezvous(self, node_id: int, node_rank: int, meta: NodeTopologyMeta) -> int:
        with self._lock:
            meta.join_time = self._clock()
            if not self._waiting_nodes:
                self._start_rdzv_ts = meta.join_time
            # re-join replaces the stale entry
            self._waiting_nodes[node_rank] = meta
            self._lastcall_time = meta.join_time
            self._alive_nodes.add(node_id)
            self._publish_locked()
        return self._rdzv_round

    def set_growth_gate(self, gate) -> None:
        """Install the planner's growth gate: ``gate(seated_world_size)
        -> bool``. Called on the poll fast path and under the manager
        lock from round completion, so the gate only reads its own state
        (the planner takes only its own lock inside)."""
        self._growth_gate = gate

    @staticmethod
    def _pure_growth(s: "_WorldSnapshot") -> bool:
        """True iff admitting the waiting nodes would only grow a healthy
        seated world: a round exists, every seated member is still alive,
        and no waiting node is a seated member re-joining (a re-form
        already in progress). Anything else is recovery and never waits
        for the planner."""
        if not s.latest_world or s.force_reform:
            return False
        world = set(s.latest_world)
        if not world <= s.alive_ids:
            return False  # a seated member died: re-form is recovery
        return world.isdisjoint(s.waiting_ids)

    def _growth_holds_round(self) -> bool:
        """Caller holds the lock. True iff the gate keeps the waiting
        nodes from completing a round: pure growth the gate has not
        approved (the JAX rule), or, where the port differs (module
        docstring), growth of a healthy seated world the open gate
        approved before every seated member re-joined."""
        gate = self._growth_gate
        s = self._snapshot
        if gate is None or not s.latest_world or s.force_reform:
            return False
        world = set(s.latest_world)
        if not world <= s.alive_ids or world <= s.waiting_ids:
            return False  # recovery, or the whole seated world re-joined
        allowed = gate(len(world))
        if self._pure_growth(s) and not allowed:
            return True
        return allowed

    def num_nodes_waiting(self) -> int:
        """Agents poll this; >0 during training means a membership
        change. While a re-form is requested (collective-hang recovery)
        and nobody has re-joined yet, a VIRTUAL waiter is reported so
        the seated-but-stalled cohort drops back into the rendezvous,
        the same signal path a real joiner uses.

        With a growth gate installed, waiting capacity that would only
        grow a healthy seated world reads as 0 until the planner's
        executed plan opens the gate: the seated fleet keeps training
        instead of paying re-form downtime the planner has not approved.
        Served from the immutable snapshot: one reference read, no
        lock."""
        s = self._snapshot
        if s.num_waiting == 0 and s.force_reform:
            return 1
        gate = self._growth_gate
        if (
            gate is not None
            and s.num_waiting > 0
            and self._pure_growth(s)
            and not gate(len(s.latest_world))
        ):
            return 0
        return s.num_waiting

    def request_re_rendezvous(self, exclude=()) -> None:
        """Collective-hang recovery (master/monitor/hang_watchdog.py):
        drop the silent members of the seated round from the alive set and
        the waiting list and raise the re-form signal. Reachable members
        see a waiter on their next membership poll and re-join; the next
        completed round clears the signal. An excluded node that heals
        simply joins again."""
        with self._lock:
            for node_id in exclude:
                self._alive_nodes.discard(node_id)
                stale = [
                    rank for rank, m in self._waiting_nodes.items()
                    if m.node_id == node_id
                ]
                for rank in stale:
                    del self._waiting_nodes[rank]
            self._force_reform = True
            self._publish_locked()
        logger.warning(
            "%s rdzv: re-rendezvous requested (excluding %s)",
            self.name, sorted(exclude) if exclude else "nobody",
        )

    def latest_world_ids(self) -> List[int]:
        """Node ids of the latest completed round's world (lock-free:
        served from the published snapshot)."""
        return list(self._snapshot.latest_world)

    def _effective_world_size(self, n: int) -> int:
        """Round down to a multiple of node_unit (reference :118-156)."""
        return (n // self._node_unit) * self._node_unit

    def _check_rdzv_completed(self) -> bool:
        """Caller holds the lock. Completes the round when ready."""
        waiting = len(self._waiting_nodes)
        if waiting == 0:
            return False
        if self._growth_holds_round():
            # a pure-growth cohort big enough to complete a round on its
            # own must not form one behind the planner's back, nor, once
            # the plan is executed, without the seated world it grows
            return False
        p = self._params
        completed = False
        if waiting >= p.max_nodes:
            completed = True
        elif waiting >= p.min_nodes:
            # waiting_timeout None -> re-read the runtime-tunable master
            # config each check
            timeout = p.waiting_timeout
            if timeout is None:
                timeout = self._config.rdzv_waiting_timeout
            since_last = self._clock() - self._lastcall_time
            if since_last >= timeout and self._effective_world_size(waiting) > 0:
                completed = True
        if completed:
            self._complete_rendezvous()
        return completed

    def _complete_rendezvous(self):
        size = min(self._effective_world_size(len(self._waiting_nodes)), self._params.max_nodes)
        # earliest joiners win a seat; others wait for the next round
        chosen = dict(
            sorted(self._waiting_nodes.items(), key=lambda kv: kv[1].join_time)[:size]
        )
        self._rdzv_nodes = self._topology_sorter.sort(chosen)
        for rank, meta in self._rdzv_nodes.items():
            meta.node_rank = rank
        kept_ids = {m.node_id for m in self._rdzv_nodes.values()}
        self._waiting_nodes = {
            r: m for r, m in self._waiting_nodes.items() if m.node_id not in kept_ids
        }
        self._latest_rdzv_nodes = sorted(kept_ids)
        self._rdzv_round += 1
        self._force_reform = False  # the re-formed world answers the hang
        self._publish_locked()
        elapsed = self._clock() - self._start_rdzv_ts if self._start_rdzv_ts else 0.0
        logger.info(
            "%s rendezvous round %s completed: %s nodes in %.1fs; world=%s",
            self.name,
            self._rdzv_round,
            len(self._rdzv_nodes),
            elapsed,
            {r: m.node_id for r, m in self._rdzv_nodes.items()},
        )

    def coordinator_addr(self) -> str:
        """host:port of rank 0: the endpoint the workers' process group
        forms at (``tcp://<coordinator_addr>``)."""
        if not self._rdzv_nodes:
            return ""
        meta = self._rdzv_nodes[0]
        if not meta.node_ip:
            return ""
        return f"{meta.node_ip}:{meta.node_port}"

    @abstractmethod
    def get_comm_world(self, node_id: int):
        ...


class ElasticTrainingRendezvousManager(RendezvousManager):
    def __init__(self, clock=None, config=None):
        super().__init__(RendezvousName.TRAINING, clock=clock, config=config)

    def get_comm_world(
        self, node_id: int
    ) -> Tuple[int, int, Dict[int, NodeTopologyMeta], str]:
        """Returns (round, group, world, coordinator). world empty = not ready.

        Served from the immutable snapshot: a seated node's poll — the
        steady-state storm at fleet scale — reads one reference and
        returns the SHARED world dict (read-only by contract), taking
        no lock and copying nothing. Only a node that is actually
        WAITING takes the lock, to drive round completion — the
        mutation path, where the lock belongs."""
        snap = self._snapshot
        if node_id is not None and node_id in snap.waiting_ids:
            with self._lock:
                self._check_rdzv_completed()
            snap = self._snapshot  # re-read: completion republishes
        if node_id is not None and node_id in snap.rdzv_ids:
            return snap.round, 0, snap.rdzv_nodes, snap.coordinator
        return snap.round, 0, {}, ""


class NetworkCheckRendezvousManager(RendezvousManager):
    """Pairs nodes for the chip+ICI benchmark; 2 rounds localize faults.

    Round r groups (reference ``_group_nodes`` :605): round 0 pairs adjacent
    ranks; round 1 shifts by one so every node gets a new partner. A node
    failing both rounds is a fault node; a node slowest (by ratio) in both
    rounds is a straggler.
    """

    def __init__(self, clock=None, config=None):
        super().__init__(
            RendezvousName.NETWORK_CHECK, clock=clock, config=config
        )
        self._node_status: Dict[int, Dict[int, bool]] = {}  # round -> id -> ok
        self._node_times: Dict[int, Dict[int, float]] = {}  # round -> id -> sec
        self._check_round = 0
        self._fault_nodes: List[int] = []
        self._stragglers: List[int] = []
        self.straggler_ratio = 1.5

    def get_comm_world(
        self, node_id: int
    ) -> Tuple[int, int, Dict[int, NodeTopologyMeta], str]:
        with self._lock:
            if any(m.node_id == node_id for m in self._waiting_nodes.values()):
                if self._check_rdzv_completed():
                    self._check_round += 1
            for group, world in enumerate(self._group_worlds()):
                if any(m.node_id == node_id for m in world.values()):
                    coord = ""
                    if world:
                        first = world[sorted(world)[0]]
                        if first.node_ip:
                            coord = f"{first.node_ip}:{first.node_port}"
                    return self._rdzv_round, group, world, coord
            return self._rdzv_round, 0, {}, ""

    def _group_worlds(self) -> List[Dict[int, NodeTopologyMeta]]:
        """Split the completed world into 2-node groups for pairwise checks."""
        if not self._rdzv_nodes:
            return []
        ranks = sorted(self._rdzv_nodes)
        n = len(ranks)
        if n <= 2:
            return [dict(self._rdzv_nodes)]
        shift = (self._check_round + 1) % 2  # alternate pairing across rounds
        order = ranks[shift:] + ranks[:shift]
        groups: List[Dict[int, NodeTopologyMeta]] = []
        for i in range(0, len(order) - 1, 2):
            pair = order[i : i + 2]
            groups.append({r: self._rdzv_nodes[r] for r in pair})
        if len(order) % 2 == 1:
            # odd node joins the last group (3-node group)
            last = order[-1]
            if groups:
                groups[-1][last] = self._rdzv_nodes[last]
            else:
                groups.append({last: self._rdzv_nodes[last]})
        return groups

    def report_network_check_result(self, node_id: int, normal: bool, elapsed: float):
        with self._lock:
            rnd = self._check_round
            self._node_status.setdefault(rnd, {})[node_id] = normal
            self._node_times.setdefault(rnd, {})[node_id] = elapsed

    def network_check_success(self) -> Tuple[bool, str]:
        """All nodes of the current round reported and none failed?"""
        with self._lock:
            rnd = self._check_round
            status = self._node_status.get(rnd, {})
            if not self._rdzv_nodes:
                return False, NetworkFailureReason.NO_INIT
            expected = {m.node_id for m in self._rdzv_nodes.values()}
            if set(status.keys()) != expected:
                return False, NetworkFailureReason.WAITING_NODE
            if all(status.values()):
                return True, ""
            return False, NetworkFailureReason.NODE_FAILURE

    def check_fault_node(self) -> Tuple[List[int], str]:
        """Fault = failed in >=2 consecutive rounds (or round 0 only so far)."""
        with self._lock:
            rounds = sorted(self._node_status.keys())
            if not rounds:
                return [], NetworkFailureReason.NO_INIT
            last = rounds[-1]
            failed_last = {
                n for n, ok in self._node_status.get(last, {}).items() if not ok
            }
            if len(rounds) == 1:
                self._fault_nodes = sorted(failed_last)
                return self._fault_nodes, ""
            prev = rounds[-2]
            failed_prev = {
                n for n, ok in self._node_status.get(prev, {}).items() if not ok
            }
            self._fault_nodes = sorted(failed_last & failed_prev)
            return self._fault_nodes, ""

    def get_straggler(self) -> Tuple[List[int], str]:
        """Straggler = slowest and > ratio x median in every observed round."""
        with self._lock:
            rounds = sorted(self._node_times.keys())
            if not rounds:
                return [], NetworkFailureReason.NO_INIT
            per_round_stragglers: List[set] = []
            for rnd in rounds:
                times = self._node_times[rnd]
                if len(times) < 2:
                    per_round_stragglers.append(set())
                    continue
                vals = sorted(times.values())
                median = vals[len(vals) // 2]
                if median <= 0:
                    per_round_stragglers.append(set())
                    continue
                slow = {
                    n
                    for n, t in times.items()
                    if t / median >= self.straggler_ratio
                }
                per_round_stragglers.append(slow)
            stragglers = set.intersection(*per_round_stragglers) if per_round_stragglers else set()
            self._stragglers = sorted(stragglers)
            return self._stragglers, ""
