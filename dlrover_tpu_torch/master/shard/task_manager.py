"""Dataset registry + task dispatch: the port's own copy of
dlrover_tpu/master/shard/task_manager.py.

Holds one :class:`BatchDatasetManager` per registered dataset, hands shards
("tasks") to workers — one at a time via the legacy ``get_task`` path or
batched under per-worker leases via :meth:`lease_shards`
— re-dispatches tasks of dead/timed-out workers from a deadline heap, and
exposes dataset checkpoint/restore for job-level resume.

With a state manager (master/state_store.py) every dispatch, ack, failure,
expiry and eviction writes its dataset through to the durable backend, on
a coalescing writer thread, and ``restore_from_state`` rebuilds a
relaunched master's queues with the live workers' in-flight shards still
leased under their original ids and fences, as the JAX manager does;
without one the queue lives in memory only. It holds the master's speed
monitor, as the JAX manager does, and reads nothing from it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import DatasetShardParams, Task
from dlrover_tpu_torch.master.shard.dataset_manager import (
    BatchDatasetManager,
    DatasetShardCheckpoint,
    LeaseGrant,
    StreamingDatasetManager,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import new_dataset_splitter


class TaskManager:
    def __init__(
        self,
        speed_monitor=None,
        state_manager=None,
        clock=None,
        lease_ttl: Optional[float] = None,
    ):
        self._datasets: Dict[str, BatchDatasetManager] = {}
        self._params: Dict[str, DatasetShardParams] = {}
        # the JAX package wraps it in its lint's lock tracker (ROADMAP
        # item 14)
        self._lock = threading.Lock()
        self._speed_monitor = speed_monitor
        #: durable write-through target (master relaunch continuity);
        #: None = in-memory only (local master)
        self._state_manager = state_manager
        self._task_timeout = DefaultValues.TASK_TIMEOUT_SECS
        #: injectable "now" shared with the dataset managers' lease
        #: deadlines (tests drive sweeps on a virtual clock)
        self._clock = clock or time.time
        self._lease_ttl = lease_ttl
        self._stop = threading.Event()
        #: scan-only stop: a caller pauses the wall-clock sweep thread
        #: and drives :meth:`sweep_deadlines` on its own clock
        self._scan_stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # persistence runs on a coalescing writer thread: every dispatch/
        # report marks its dataset dirty and the writer drains immediately
        # — RPC handlers never pay the serialize+fsync/API-server cost,
        # and a burst of task RPCs collapses into one write per dataset.
        # The loss window (master killed between mutation and drain) is
        # sub-ms and degrades to at-least-once re-dispatch, never loss.
        self._dirty: set = set()
        self._flush_lock = threading.Lock()
        self._dirty_evt = threading.Event()
        self._writer: Optional[threading.Thread] = None

    def new_dataset(self, params: DatasetShardParams):
        with self._lock:
            if params.dataset_name in self._datasets:
                return
            self._register(params)
        self._persist(params.dataset_name)

    def _register(self, params: DatasetShardParams):
        splitter = new_dataset_splitter(
            params.storage_type,
            params.dataset_name,
            params.dataset_size,
            params.shard_size,
            params.num_epochs,
            params.shuffle,
            partition_offsets=params.partition_offsets or None,
        )
        task_type = "eval" if "eval" in params.dataset_name else "train"
        manager_cls = (
            StreamingDatasetManager
            if params.storage_type == "streaming"
            else BatchDatasetManager
        )
        self._datasets[params.dataset_name] = manager_cls(
            task_type,
            splitter,
            clock=self._clock,
            task_timeout=self._task_timeout,
            lease_ttl=self._lease_ttl,
        )
        self._params[params.dataset_name] = params
        logger.info(
            "registered dataset %s: size=%s shard=%s epochs=%s",
            params.dataset_name,
            params.dataset_size,
            params.shard_size,
            params.num_epochs,
        )

    def _persist(self, dataset_name: str):
        """Mark the dataset dirty; the writer thread drains immediately.
        Runs AFTER the in-memory mutation: a master killed in between
        re-dispatches at most the un-persisted change (at-least-once)."""
        if self._state_manager is None:
            return
        self._dirty.add(dataset_name)
        self._dirty_evt.set()
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="task-state-writer",
                daemon=True,
            )
            self._writer.start()

    def _writer_loop(self):
        while not self._stop.is_set():
            if not self._dirty_evt.wait(timeout=1.0):
                continue
            self._dirty_evt.clear()
            self.flush_state()

    def flush_state(self):
        """Synchronously persist every dirty dataset (writer drain; also
        the deterministic barrier for tests and shutdown).

        Drains are serialised: each takes a dataset's checkpoint and
        writes it under one lock, so a drain that took an older
        checkpoint can never land after a newer one. (The JAX manager
        lets the writer thread and an explicit flush race; there a stale
        document can win the last write.)"""
        if self._state_manager is None:
            return
        import dataclasses

        with self._flush_lock:
            while True:
                try:
                    name = self._dirty.pop()
                except KeyError:
                    break
                ds = self._datasets.get(name)
                params = self._params.get(name)
                if ds is None or params is None:
                    continue
                self._state_manager.save_dataset(
                    name,
                    dataclasses.asdict(params),
                    ds.checkpoint().to_json(),
                )

    def restore_from_state(self) -> int:
        """Master relaunch: rebuild every persisted dataset with its shard
        queues, keeping live workers' in-flight tasks as doing (original
        ids AND lease fences, so batched late reports complete
        exactly-once). Returns the number of datasets restored."""
        if self._state_manager is None:
            return 0
        restored = 0
        for name, doc in self._state_manager.load_datasets().items():
            try:
                params = DatasetShardParams(**doc["params"])
                ckpt = DatasetShardCheckpoint.from_json(
                    json.dumps(doc["ckpt"])
                )
                with self._lock:
                    if name not in self._datasets:
                        self._register(params)
                    self._datasets[name].restore_checkpoint(
                        ckpt, keep_doing=True
                    )
                restored += 1
                logger.info(
                    "restored dataset %s from master state: epoch=%s "
                    "todo=%s doing=%s leases=%s completed_records=%s",
                    name, ckpt.epoch, len(ckpt.todo), len(ckpt.doing_meta)
                    or len(ckpt.doing), len(ckpt.leases),
                    ckpt.completed_records,
                )
            except Exception:
                logger.exception("dataset %s state restore failed", name)
        return restored

    def get_dataset_task(self, node_id: int, dataset_name: str) -> Task:
        ds = self._datasets.get(dataset_name)
        if ds is None:
            return Task()
        task = ds.get_task(node_id)
        if not task.empty:
            self._persist(dataset_name)
        return task

    def lease_shards(
        self,
        node_id: int,
        dataset_name: str,
        count: int,
        done_ids: Optional[List[int]] = None,
        failed_ids: Optional[List[int]] = None,
        lease_epoch: int = -1,
    ) -> LeaseGrant:
        """The batched data plane: ack the previous batch's completions
        (fenced) and lease up to ``count`` fresh shards in one call."""
        ds = self._datasets.get(dataset_name)
        if ds is None:
            return LeaseGrant()
        grant = ds.lease_shards(
            node_id, count, done_ids, failed_ids, lease_epoch
        )
        if grant.changed:
            self._persist(dataset_name)
        return grant

    def renew_node_leases(self, node_id: int, now: Optional[float] = None):
        """Folded-WorkerReport hook: one heartbeat renews every dataset
        lease the node holds — data-plane liveness costs zero extra
        RPCs. Renewals are not persisted (a relaunch re-grants one TTL
        anyway)."""
        for ds in list(self._datasets.values()):
            ds.renew_lease(node_id, now=now)

    def todo_counts(self) -> Dict[str, int]:
        """dataset -> queued-shard count; rides the WorkerReport ack as
        the idle workers' data-available wakeup hint."""
        return {
            name: n
            for name, ds in list(self._datasets.items())
            if (n := ds.todo_count()) > 0
        }

    def report_dataset_task(
        self,
        dataset_name: str,
        task_id: int,
        success: bool,
        lease_epoch: int = -1,
    ):
        ds = self._datasets.get(dataset_name)
        if ds is None:
            return False
        known, _ = ds.report_task_status(
            task_id, success, lease_epoch=lease_epoch
        )
        if known:
            self._persist(dataset_name)
        return known

    def get_epoch(self, dataset_name: str) -> int:
        ds = self._datasets.get(dataset_name)
        return ds.get_epoch() if ds else 0

    def completed_records(self, dataset_name: str) -> int:
        ds = self._datasets.get(dataset_name)
        return ds.completed_records if ds else 0

    def finished(self) -> bool:
        """All training datasets exhausted (empty registry = not finished)."""
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.completed() for ds in self._datasets.values())

    def remove_node_tasks(self, node_id: int):
        for name, ds in list(self._datasets.items()):
            if ds.reset_worker_tasks(node_id):
                self._persist(name)

    # -- checkpoint -------------------------------------------------------

    def checkpoint_dataset(self, dataset_name: str) -> Optional[DatasetShardCheckpoint]:
        ds = self._datasets.get(dataset_name)
        return ds.checkpoint() if ds else None

    def restore_dataset_checkpoint(self, content: str):
        ckpt = DatasetShardCheckpoint.from_json(content)
        ds = self._datasets.get(ckpt.dataset_name)
        if ds is None:
            logger.warning("restore for unknown dataset %s", ckpt.dataset_name)
            return False
        ds.restore_checkpoint(ckpt)
        return True

    # -- background deadline sweep ----------------------------------------

    def start(self):
        if self._thread is None:
            self._scan_stop.clear()
            self._thread = threading.Thread(
                target=self._scan_loop, name="task-deadline-scan", daemon=True
            )
            self._thread.start()

    def pause_scan(self):
        """Stop the wall-clock sweep thread without stopping the
        manager: the caller drives :meth:`sweep_deadlines` on its own
        virtual clock."""
        self._scan_stop.set()

    def stop(self):
        """Stop the sweep and the writer, then flush: once this returns,
        no thread of the manager writes a document again (a caller may
        clear the state after it)."""
        self._stop.set()
        self._scan_stop.set()
        self._dirty_evt.set()
        for thread in (self._thread, self._writer):
            if thread is not None and thread is not threading.current_thread():
                thread.join(timeout=60)
        self.flush_state()

    def next_deadline(self) -> Optional[float]:
        deadlines = [
            d for ds in list(self._datasets.values())
            if (d := ds.next_deadline()) is not None
        ]
        return min(deadlines) if deadlines else None

    def sweep_deadlines(self, now: Optional[float] = None) -> int:
        """One deadline sweep over every dataset's heap: expire due
        leases (requeue their undone shards at-least-once) and due
        legacy task timeouts. O(due · log n) — a 1M-shard dataset with
        nothing due costs one heap peek, not a full walk. Returns the
        number of shards requeued."""
        requeued = 0
        for name, ds in list(self._datasets.items()):
            events = ds.expire_due(now=now)
            if events:
                for kind, key, n in events:
                    requeued += n
                    logger.warning(
                        "dataset %s: %s %s expired; requeued %s shard(s)",
                        name, kind,
                        f"of node {key}" if kind == "lease" else key, n,
                    )
                self._persist(name)
        return requeued

    def _scan_loop(self):
        """Deadline-heap-driven sweep: sleeps until the earliest lease
        or task deadline (bounded to [0.2, 30] s so new datasets and
        clock adjustments are picked up) instead of the old fixed
        30-second full-dataset walk."""
        while not self._scan_stop.is_set():
            nxt = self.next_deadline()
            if nxt is None:
                wait = 30.0
            else:
                wait = min(30.0, max(0.2, nxt - self._clock()))
            if self._scan_stop.wait(wait):
                break
            self.sweep_deadlines()
