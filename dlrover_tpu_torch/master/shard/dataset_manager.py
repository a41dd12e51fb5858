"""Per-dataset todo/doing task queues + batched shard leases +
shard checkpointing.

The port's own copy of dlrover_tpu/master/shard/dataset_manager.py, with
the same queues, leases, fences, deadline heap and ``DatasetShardCheckpoint``
JSON (both packages' checkpoints restore in the other):

- **Batched leases.** ``lease_shards`` hands a worker up to N shards
  under ONE per-worker lease with an explicit deadline; completions of
  the previous batch ride the same call, so steady-state the data plane
  costs one RPC per batch where ``get_task`` cost two RPCs per shard.
- **At-least-once recovery.** Lease expiry, worker eviction and
  reported failure all re-enqueue the undone shards; nothing is ever
  lost, some shards may be delivered twice.
- **Epoch-fenced dedup.** Every issuance carries the lease's fence
  (``lease_epoch``); a completion whose fence no longer matches the
  current issue record is a zombie's late report of a re-issued shard
  and acks nothing — ``completed_records`` counts every record exactly
  once even though delivery is at-least-once.
- **Deadline heap.** Expiry is driven by a lazy-invalidated heap of
  (deadline, lease|task) entries, so the master's watchdog pays
  O(due · log n) per sweep instead of walking every in-flight shard of
  a 1M-shard dataset every second.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common import flags, versioned_format
from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import Task
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter, Shard

#: the shard checkpoint's durable format. v2 = explicit version stamp +
#: doing_meta entries ALWAYS written as 6 elements (fence included);
#: version-less documents are the pre-versioning writers, whose
#: doing_meta may be 5-element (pre-lease) — normalized by the legacy
#: adapter below, the one place the 5-vs-6 shape knowledge lives now.
SHARD_CKPT_FORMAT = versioned_format.register("dataset_shard_ckpt", 2)

# deadline-heap entry kinds
_LEASE = 0
_TASK = 1


@dataclass
class DoingTask:
    task: Task
    node_id: int
    start_time: float
    #: fence the task was issued under; -1 = legacy per-task dispatch
    #: (timeout-governed), >= 0 = part of that node lease (deadline-
    #: governed). A report must present the matching fence to complete.
    lease_epoch: int = -1


@dataclass
class ShardLease:
    """One worker's batch lease: the set of task ids it holds, the
    deadline every folded ``WorkerReport`` renews, and the fence
    (``epoch``) that makes its completions deduplicable.

    ``progress_at`` is the last time the lease made DATA progress (a
    grant or a completion). Renewal is liveness-driven (heartbeats),
    but a heartbeat must not hold shards forever: renewals never
    extend the deadline past ``progress_at + task_timeout``, so a
    worker whose agent keeps reporting while its input pipeline is
    wedged still loses its shards after the same timeout the legacy
    per-task protocol enforced."""

    node_id: int
    epoch: int
    deadline: float
    task_ids: Set[int] = field(default_factory=set)
    progress_at: float = 0.0


@dataclass
class LeaseGrant:
    """What ``lease_shards`` returns to the servicer."""

    tasks: List[Task] = field(default_factory=list)
    lease_epoch: int = -1
    deadline: float = 0.0
    acked: List[int] = field(default_factory=list)
    idle: bool = False
    exhausted: bool = False
    changed: bool = False  # any durable mutation happened (persist hint)


@dataclass
class DatasetShardCheckpoint:
    """Resumable sharding state: epoch + undone shard ranges.

    Batch datasets store ``[start, end]`` ranges; streaming datasets store
    ``[partition, start, end]`` plus the per-partition consumed offsets so
    a restored master resumes the stream exactly where it stopped
    (reference ``streaming_dataset_manager.py:32`` + its
    ``checkpoint``/``restore_checkpoint``)."""

    dataset_name: str = ""
    todo: List = field(default_factory=list)  # [[start, end], ...]
    doing: List = field(default_factory=list)
    epoch: int = 0
    completed_records: int = 0
    partition_offsets: Dict = field(default_factory=dict)  # streaming only
    #: in-flight task identity for master-relaunch continuity:
    #: [[task_id, node_id, partition, start, end, lease_epoch], ...] —
    #: lets a restored master keep live workers' tasks as *doing* under
    #: their original fences (their late success reports then complete
    #: normally, exactly-once) instead of re-queueing them blind.
    #: Legacy 5-element entries decode with lease_epoch -1.
    doing_meta: List = field(default_factory=list)
    task_id_seq: int = 0
    #: what ``epoch`` counts — "pass" (default; full data passes) or a
    #: splitter-specific unit like the table splitter's "subepoch" — plus
    #: the writer's sub-units-per-pass factor. Restores convert when the
    #: unit or factor disagrees (older build, table resized, shard-count
    #: cap changed), rounding down to completed passes so data is re-read
    #: rather than skipped.
    epoch_unit: str = "pass"
    epoch_factor: int = 1
    #: in-flight batch leases: [[node_id, lease_epoch, deadline,
    #: [task_ids...]], ...] + the fence counter — a master relaunch
    #: restores the leases (with a fresh renewal grace) instead of
    #: orphaning them, and the counter keeps post-relaunch fences
    #: strictly newer than any zombie's
    leases: List = field(default_factory=list)
    lease_seq: int = 0

    def to_json(self) -> str:
        return json.dumps(
            SHARD_CKPT_FORMAT.wrap(
                {
                    "dataset_name": self.dataset_name,
                    "todo": self.todo,
                    "doing": self.doing,
                    "epoch": self.epoch,
                    "completed_records": self.completed_records,
                    "partition_offsets": self.partition_offsets,
                    # v2 invariant: every entry carries all 6 elements
                    "doing_meta": _normalize_doing_meta(self.doing_meta),
                    "task_id_seq": self.task_id_seq,
                    "epoch_unit": self.epoch_unit,
                    "epoch_factor": self.epoch_factor,
                    "leases": self.leases,
                    "lease_seq": self.lease_seq,
                }
            )
        )

    @classmethod
    def from_json(cls, content: str) -> "DatasetShardCheckpoint":
        d = SHARD_CKPT_FORMAT.parse(
            json.loads(content), legacy=_legacy_shard_ckpt
        )
        return cls(
            dataset_name=d.get("dataset_name", ""),
            todo=d.get("todo", []),
            doing=d.get("doing", []),
            epoch=d.get("epoch", 0),
            completed_records=d.get("completed_records", 0),
            partition_offsets=d.get("partition_offsets", {}),
            doing_meta=_normalize_doing_meta(d.get("doing_meta", [])),
            task_id_seq=d.get("task_id_seq", 0),
            epoch_unit=d.get("epoch_unit", "pass"),
            epoch_factor=d.get("epoch_factor", 1),
            leases=d.get("leases", []),
            lease_seq=d.get("lease_seq", 0),
        )


def _normalize_doing_meta(entries: List) -> List:
    """Every ``doing_meta`` entry as the full 6-element v2 shape
    ``[task_id, node_id, partition, start, end, lease_epoch]``; a
    missing fence (pre-lease writer) decodes as -1 = legacy per-task
    dispatch, exactly what the hand-rolled 5-vs-6 decode used to do."""
    return [
        list(e[:5]) + [int(e[5]) if len(e) > 5 else -1] for e in entries
    ]


def _legacy_shard_ckpt(payload: Dict) -> Dict:
    """Version-less shard checkpoint (pre-versioned_format writer):
    same field names, but doing_meta may carry 5-element entries."""
    out = dict(payload)
    out["doing_meta"] = _normalize_doing_meta(payload.get("doing_meta", []))
    return out


def _meta_fence(entry) -> int:
    """doing_meta lease fence; legacy 5-element entries carry none.
    (from_json normalizes to 6 elements, but raw entries reach here
    from in-memory paths too — keep the defensive read.)"""
    return int(entry[5]) if len(entry) > 5 else -1


class BatchDatasetManager:
    """Dispatches shards of a bounded dataset as tasks to workers."""

    def __init__(
        self,
        task_type: str,
        splitter: DatasetSplitter,
        clock=None,
        task_timeout: float = DefaultValues.TASK_TIMEOUT_SECS,
        lease_ttl: Optional[float] = None,
    ):
        self.task_type = task_type
        self._splitter = splitter
        # injectable "now": lease deadlines and task timeouts must share
        # the clock that drives the sweeps (the fleet harness runs both
        # on a virtual clock)
        self._clock = clock or time.time
        self.task_timeout = float(task_timeout)
        self.lease_ttl = float(
            lease_ttl if lease_ttl is not None
            else flags.SHARD_LEASE_TTL_S.get()
        )
        self._todo: Deque[Task] = deque()
        self._doing: Dict[int, DoingTask] = {}
        self._leases: Dict[int, ShardLease] = {}
        self._lease_seq = 0
        #: lazy-invalidated deadline heap: (when, kind, key). Lease
        #: entries key on node_id (one live entry per lease — a renewal
        #: only moves the deadline; the stale pop re-pushes at the
        #: renewed time). Task entries key on task_id for legacy
        #: ``get_task`` issues (leased tasks are deadline-governed by
        #: their lease, not per-task timeouts).
        self._deadlines: List[Tuple[float, int, int]] = []
        self._task_id_seq = 0
        self._completed_records = 0
        # the JAX package wraps it in its lint's lock tracker (ROADMAP
        # item 14)
        self._lock = threading.Lock()

    @property
    def dataset_name(self) -> str:
        return self._splitter.dataset_name

    def _create_tasks_from_shards(self, shards: List[Shard], epoch: int):
        for shard in shards:
            task = Task(
                task_id=self._task_id_seq,
                task_type=self.task_type,
                dataset_name=self._splitter.dataset_name,
                shard_start=shard.start,
                shard_end=shard.end,
                shard_indices=shard.record_indices,
                epoch=epoch,
            )
            self._task_id_seq += 1
            self._todo.append(task)

    def _refill_locked(self):
        if not self._todo and self._splitter.create_shards():
            self._create_tasks_from_shards(
                self._splitter.get_shards(), self._splitter.epoch
            )

    def get_task(self, node_id: int) -> Task:
        with self._lock:
            self._refill_locked()
            if not self._todo:
                return Task()  # empty: dataset exhausted
            task = self._todo.popleft()
            now = self._clock()
            self._doing[task.task_id] = DoingTask(task, node_id, now)
            heapq.heappush(
                self._deadlines,
                (now + self.task_timeout, _TASK, task.task_id),
            )
            return task

    # -- batched leases ----------------------------------------------------

    def lease_shards(
        self,
        node_id: int,
        count: int,
        done_ids: Optional[List[int]] = None,
        failed_ids: Optional[List[int]] = None,
        lease_epoch: int = -1,
        now: Optional[float] = None,
    ) -> LeaseGrant:
        """Ack the finished shards of the previous batch (under the
        presented fence), then lease up to ``count`` fresh shards under
        this node's lease. One RPC, both directions of the data plane."""
        now = self._clock() if now is None else now
        grant = LeaseGrant()
        with self._lock:
            for tid in done_ids or ():
                if self._finish_locked(int(tid), True, lease_epoch, now):
                    grant.acked.append(int(tid))
                    grant.changed = True
            for tid in failed_ids or ():
                if self._finish_locked(int(tid), False, lease_epoch, now):
                    grant.changed = True
            lease = self._leases.get(node_id)
            if count > 0:
                self._refill_locked()
                if self._todo:
                    if lease is None:
                        self._lease_seq += 1
                        lease = ShardLease(
                            node_id, self._lease_seq, now + self.lease_ttl,
                            progress_at=now,
                        )
                        self._leases[node_id] = lease
                        heapq.heappush(
                            self._deadlines,
                            (lease.deadline, _LEASE, node_id),
                        )
                    else:
                        lease.deadline = max(
                            lease.deadline, now + self.lease_ttl
                        )
                        lease.progress_at = max(lease.progress_at, now)
                    for _ in range(count):
                        if not self._todo:
                            self._refill_locked()
                            if not self._todo:
                                break
                        task = self._todo.popleft()
                        self._doing[task.task_id] = DoingTask(
                            task, node_id, now, lease.epoch
                        )
                        lease.task_ids.add(task.task_id)
                        grant.tasks.append(task)
                    grant.changed = grant.changed or bool(grant.tasks)
            if lease is not None:
                grant.lease_epoch = lease.epoch
                grant.deadline = lease.deadline
                if not lease.task_ids and not grant.tasks:
                    # fully drained lease: drop it so an idle worker's
                    # stale deadline doesn't linger in the heap forever
                    self._leases.pop(node_id, None)
            grant.idle = not self._todo and bool(self._doing)
            grant.exhausted = (
                not self._todo
                and not self._doing
                and self._splitter.epoch_finished()
            )
        return grant

    def _finish_locked(
        self, task_id: int, success: bool, fence: int,
        now: Optional[float] = None,
    ) -> bool:
        """Complete one issuance iff the presented fence matches the
        issue record. A mismatch is a zombie's late report of a shard
        that has since been re-issued (lease expiry / eviction bumped
        the fence): it is ignored, so ``completed_records`` can never
        double-count and the live holder's in-flight copy stays
        intact."""
        doing = self._doing.get(task_id)
        if doing is None or doing.lease_epoch != fence:
            return False
        del self._doing[task_id]
        if doing.lease_epoch >= 0:
            lease = self._leases.get(doing.node_id)
            if lease is not None and lease.epoch == doing.lease_epoch:
                lease.task_ids.discard(task_id)
                lease.progress_at = max(
                    lease.progress_at,
                    self._clock() if now is None else now,
                )
        if success:
            self._completed_records += (
                doing.task.shard_end - doing.task.shard_start
            )
        else:
            self._todo.appendleft(doing.task)
        return True

    def renew_lease(self, node_id: int, now: Optional[float] = None) -> bool:
        """Push the node's lease deadline out one TTL (the folded
        WorkerReport path — liveness renews data-plane ownership with
        zero extra RPCs), but never past ``progress_at + task_timeout``:
        heartbeats prove the agent is alive, not that the data pipeline
        is moving, and a wedged-but-heartbeating worker must still lose
        its shards on the legacy progress timeout. The heap entry is
        NOT re-pushed: its stale pop observes the moved deadline and
        re-queues itself."""
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(node_id)
            if lease is None:
                return False
            cap = lease.progress_at + self.task_timeout
            lease.deadline = max(
                lease.deadline, min(now + self.lease_ttl, cap)
            )
            return True

    def expire_due(self, now: Optional[float] = None) -> List[Tuple[str, int, int]]:
        """Pop due deadline-heap entries only (lazy invalidation):
        expired leases re-enqueue their undone shards at-least-once
        (fence stays bumped via the dropped lease), timed-out legacy
        tasks requeue as before. Returns [(kind, key, n_requeued)]."""
        now = self._clock() if now is None else now
        out: List[Tuple[str, int, int]] = []
        with self._lock:
            while self._deadlines and self._deadlines[0][0] <= now:
                _, kind, key = heapq.heappop(self._deadlines)
                if kind == _LEASE:
                    lease = self._leases.get(key)
                    if lease is None:
                        continue
                    if lease.deadline > now:
                        heapq.heappush(
                            self._deadlines, (lease.deadline, _LEASE, key)
                        )
                        continue
                    n = self._release_lease_locked(lease)
                    out.append(("lease", key, n))
                else:
                    doing = self._doing.get(key)
                    if doing is None or doing.lease_epoch >= 0:
                        continue
                    due = doing.start_time + self.task_timeout
                    if due > now:
                        heapq.heappush(self._deadlines, (due, _TASK, key))
                        continue
                    del self._doing[key]
                    self._todo.appendleft(doing.task)
                    out.append(("task", key, 1))
        return out

    def _release_lease_locked(self, lease: ShardLease) -> int:
        """Requeue every undone shard of a lease and drop it. The next
        lease for this node mints a FRESH fence, so the old holder's
        late completions are rejected."""
        requeued = 0
        for tid in sorted(lease.task_ids, reverse=True):
            doing = self._doing.pop(tid, None)
            if doing is not None:
                self._todo.appendleft(doing.task)
                requeued += 1
        self._leases.pop(lease.node_id, None)
        if requeued:
            logger.info(
                "dataset %s: lease of node %s (fence %s) released; "
                "requeued %s shards",
                self.dataset_name, lease.node_id, lease.epoch, requeued,
            )
        return requeued

    def next_deadline(self) -> Optional[float]:
        """Earliest (possibly stale — early wakes are harmless) heap
        deadline; None = nothing in flight."""
        with self._lock:
            return self._deadlines[0][0] if self._deadlines else None

    def todo_count(self) -> int:
        return len(self._todo)

    def report_task_status(
        self, task_id: int, success: bool, lease_epoch: int = -1
    ) -> Tuple[bool, Optional[Task]]:
        """Returns (known, task). Failure requeues the shard at the
        front. Lease-issued tasks must present their fence; legacy
        ``get_task`` issues carry fence -1 on both sides."""
        with self._lock:
            doing = self._doing.get(task_id)
            task = doing.task if doing is not None else None
            known = self._finish_locked(task_id, success, lease_epoch)
            return known, task if known else None

    def reset_worker_tasks(self, node_id: int) -> int:
        """Worker died/evicted: requeue all shards it was working on —
        leased or not — and drop its lease so the fence bumps."""
        with self._lock:
            lease = self._leases.get(node_id)
            requeued = 0
            if lease is not None:
                requeued += self._release_lease_locked(lease)
            stale = [
                tid for tid, d in self._doing.items()
                if d.node_id == node_id
            ]
            for tid in stale:
                self._todo.appendleft(self._doing.pop(tid).task)
            requeued += len(stale)
            if requeued:
                logger.info(
                    "dataset %s: requeued %s tasks of dead node %s",
                    self.dataset_name,
                    requeued,
                    node_id,
                )
            return requeued

    def completed(self) -> bool:
        with self._lock:
            return (
                not self._todo
                and not self._doing
                and self._splitter.epoch_finished()
            )

    @property
    def completed_records(self) -> int:
        return self._completed_records

    def get_epoch(self) -> int:
        return self._splitter.epoch

    # -- checkpoint -------------------------------------------------------

    def _doing_meta_locked(self) -> List:
        return [
            [d.task.task_id, d.node_id, d.task.partition,
             d.task.shard_start, d.task.shard_end, d.lease_epoch]
            for d in self._doing.values()
        ]

    def _lease_state_locked(self) -> List:
        return [
            [ls.node_id, ls.epoch, ls.deadline, sorted(ls.task_ids),
             ls.progress_at]
            for ls in self._leases.values()
        ]

    def _restore_doing_locked(self, ckpt: "DatasetShardCheckpoint"):
        """keep_doing restore: rebuild the in-flight tasks under their
        ORIGINAL ids and lease fences (legacy issues re-enter the
        timeout heap), then the leases over them."""
        now = self._clock()
        for entry in ckpt.doing_meta:
            task_id, node_id, partition, start, end = entry[:5]
            task = Task(
                task_id=int(task_id),
                task_type=self.task_type,
                dataset_name=self.dataset_name,
                shard_start=start,
                shard_end=end,
                partition=str(partition or ""),
                epoch=ckpt.epoch,
            )
            fence = _meta_fence(entry)
            self._doing[task.task_id] = DoingTask(
                task, int(node_id), now, fence
            )
            if fence < 0:
                heapq.heappush(
                    self._deadlines,
                    (now + self.task_timeout, _TASK, task.task_id),
                )
        self._restore_leases_locked(ckpt)

    def _restore_leases_locked(self, ckpt: "DatasetShardCheckpoint"):
        """Rebuild the in-flight leases from the checkpoint. Deadlines
        get one fresh TTL of grace from *now*: the relaunch gap may
        have outlived the persisted deadlines, and live holders renew
        on their next folded report — expiring them on the first sweep
        would re-enqueue shards their workers still hold (correct but
        wasteful at-least-once churn). Truly dead holders still expire
        one TTL later."""
        now = self._clock()
        self._leases.clear()
        self._lease_seq = max(self._lease_seq, int(ckpt.lease_seq))
        for entry in ckpt.leases or []:
            node_id, epoch, deadline, task_ids = (
                int(entry[0]), int(entry[1]), float(entry[2]),
                [int(t) for t in entry[3]],
            )
            progress_at = float(entry[4]) if len(entry) > 4 else now
            held = {t for t in task_ids if t in self._doing}
            if not held:
                continue
            lease = ShardLease(
                node_id, epoch, max(deadline, now + self.lease_ttl), held,
                progress_at=progress_at,
            )
            self._leases[node_id] = lease
            self._lease_seq = max(self._lease_seq, epoch)
            heapq.heappush(
                self._deadlines, (lease.deadline, _LEASE, node_id)
            )

    def checkpoint(self) -> DatasetShardCheckpoint:
        with self._lock:
            return DatasetShardCheckpoint(
                dataset_name=self.dataset_name,
                todo=[[t.shard_start, t.shard_end] for t in self._todo],
                doing=[
                    [d.task.shard_start, d.task.shard_end]
                    for d in self._doing.values()
                ],
                epoch=self._splitter.epoch,
                completed_records=self._completed_records,
                doing_meta=self._doing_meta_locked(),
                task_id_seq=self._task_id_seq,
                epoch_unit=getattr(self._splitter, "EPOCH_UNIT", "pass"),
                epoch_factor=int(
                    getattr(self._splitter, "EPOCH_FACTOR", 1)
                ),
                leases=self._lease_state_locked(),
                lease_seq=self._lease_seq,
            )

    def restore_checkpoint(
        self, ckpt: DatasetShardCheckpoint, keep_doing: bool = False
    ):
        """Default: doing shards are treated as undone and go back to todo
        (worker restart). ``keep_doing`` (master relaunch with workers
        still alive): in-flight tasks are rebuilt as *doing* under their
        original ids AND original lease fences, so live workers' late
        (possibly batched) reports complete them exactly-once; restored
        leases get a renewal grace and the deadline heap requeues any
        whose worker truly died."""
        with self._lock:
            self._splitter.restore_epoch(
                ckpt.epoch, ckpt.epoch_unit, ckpt.epoch_factor
            )
            self._todo.clear()
            self._doing.clear()
            self._leases.clear()
            self._deadlines = []
            self._completed_records = ckpt.completed_records
            self._task_id_seq = max(self._task_id_seq, ckpt.task_id_seq)
            doing = list(ckpt.doing)
            if keep_doing and ckpt.doing_meta:
                doing = []
                self._restore_doing_locked(ckpt)
            for start, end in doing + list(ckpt.todo):
                task = Task(
                    task_id=self._task_id_seq,
                    task_type=self.task_type,
                    dataset_name=self.dataset_name,
                    shard_start=start,
                    shard_end=end,
                    epoch=ckpt.epoch,
                )
                self._task_id_seq += 1
                self._todo.append(task)


class StreamingDatasetManager(BatchDatasetManager):
    """Task dispatch over an unbounded stream of (partition, offset-range)
    shards.

    Parity: reference ``master/shard/streaming_dataset_manager.py:32``.
    Differences from batch: tasks carry their source partition; the
    splitter mints new offset ranges on demand forever (``completed()`` is
    never True); the checkpoint persists the per-partition consumed
    offsets *minus* undone work, so a master restart re-dispatches exactly
    the unfinished ranges and then continues the stream."""

    def _create_tasks_from_shards(self, shards: List[Shard], epoch: int):
        for shard in shards:
            task = Task(
                task_id=self._task_id_seq,
                task_type=self.task_type,
                dataset_name=self._splitter.dataset_name,
                shard_start=shard.start,
                shard_end=shard.end,
                partition=shard.name,
                epoch=epoch,
            )
            self._task_id_seq += 1
            self._todo.append(task)

    def completed(self) -> bool:
        return False  # streams are unbounded

    # -- checkpoint -------------------------------------------------------

    def checkpoint(self) -> DatasetShardCheckpoint:
        with self._lock:
            return DatasetShardCheckpoint(
                dataset_name=self.dataset_name,
                todo=[
                    [t.partition, t.shard_start, t.shard_end]
                    for t in self._todo
                ],
                doing=[
                    [d.task.partition, d.task.shard_start, d.task.shard_end]
                    for d in self._doing.values()
                ],
                epoch=self._splitter.epoch,
                completed_records=self._completed_records,
                partition_offsets=self._splitter.offsets,
                doing_meta=self._doing_meta_locked(),
                task_id_seq=self._task_id_seq,
                leases=self._lease_state_locked(),
                lease_seq=self._lease_seq,
            )

    def restore_checkpoint(
        self, ckpt: DatasetShardCheckpoint, keep_doing: bool = False
    ):
        with self._lock:
            self._todo.clear()
            self._doing.clear()
            self._leases.clear()
            self._deadlines = []
            self._completed_records = ckpt.completed_records
            self._task_id_seq = max(self._task_id_seq, ckpt.task_id_seq)
            self._splitter.reset_offsets(ckpt.partition_offsets)
            doing = list(ckpt.doing)
            if keep_doing and ckpt.doing_meta:
                doing = []
                self._restore_doing_locked(ckpt)
            for partition, start, end in doing + list(ckpt.todo):
                task = Task(
                    task_id=self._task_id_seq,
                    task_type=self.task_type,
                    dataset_name=self.dataset_name,
                    shard_start=start,
                    shard_end=end,
                    partition=str(partition),
                    epoch=ckpt.epoch,
                )
                self._task_id_seq += 1
                self._todo.append(task)
