"""Persisting staged checkpoints to storage (port of the
``CheckpointPersister`` half of dlrover_tpu/checkpoint/saver.py).

Storage layout, the JAX package's (both disk tiers mirror it)::

    <ckpt_dir>/                        # tier 2: shared "object" storage
      latest_step.txt                  # tracker: last committed step
      step-<N>/
        node-<node_rank>.done          # commit votes (written after fanout)
        proc-<pid>/
          meta.json                    # CheckpointMeta manifest (piece
                                       # index + per-leaf CRC32)
          leaf-<i>.bin                 # raw little-endian bytes per piece
    <local_root>/node-<id>/            # tier 1: node-local disk
      step-<N>/proc-<pid>/...          # same proc-dir layout

Tiered persist: the shm copy lands on the node-local disk tier first (a
pool of leaf writers, per-leaf CRC32, the manifest written last so a torn
proc dir is never read as valid), then fans out to the object tier, and
the node's commit vote follows the fanout, so a committed step survives
losing the node.

``CheckpointPersister`` is the storage side; ``AsyncCheckpointSaver`` adds
what the agent hosts: the IPC server (common/ipc.py) and its event loop,
the persist back-pressure, the save-at-breakpoint persist and the replica
push (replica.py). A bare run, with no saver listening, persists inline
through a ``CheckpointPersister`` of its own (engine.py). The queue, lock
and dict names and the event's wire dict are the JAX package's, so a
trainer of either package works under a saver of either package.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.checkpoint.shm_handler import (
    CheckpointMeta,
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.ipc import (
    IpcServer,
    SharedQueue,
    default_socket_path,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.storage import (
    CheckpointDeletionStrategy,
    CheckpointStorage,
    KeepLatestStepStrategy,
    PosixDiskStorage,
)

CKPT_EVENT_QUEUE = "ckpt-events"
SHM_LOCK = "shm-ckpt-lock"
PERSIST_STATE_DICT = "ckpt-persist-state"
TRACKER_FILE = CheckpointConstant.TRACKER_FILE


@dataclasses.dataclass
class CheckpointEvent:
    event_type: str  # "save" | "backup" | "exit"
    step: int = -1
    persist: bool = False  # False: a memory-only save
    ckpt_dir: str = ""

    def to_wire(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: Dict) -> "CheckpointEvent":
        return cls(event_type=d.get("event_type", ""),
                   step=d.get("step", -1), persist=d.get("persist", False),
                   ckpt_dir=d.get("ckpt_dir", ""))


def persist_mark(process_id: int) -> str:
    """The back-pressure key in ``PERSIST_STATE_DICT``: the newest step the
    saver has copied out of that process's segment."""
    return f"copied-{process_id}"


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step-{step}")


def local_tier_dir(ckpt_dir: str, node_id: int) -> str:
    """This node's local-disk checkpoint tier (tier 1):
    ``DLROVER_TPU_CKPT_LOCAL_DIR`` (a node-local SSD) or, unset,
    ``<ckpt_dir>/_local``, under ``node-<id>``, so simulated nodes on one
    host lose their tiers independently."""
    root = flags.CKPT_LOCAL_DIR.get()
    if not root:
        root = os.path.join(os.path.abspath(ckpt_dir), "_local")
    return os.path.join(root, f"node-{node_id}")


class CheckpointPersister:
    """shm -> storage persistence and the commit/tracker protocol."""

    def __init__(
        self,
        job_name: str,
        node_id: int,
        node_rank: int = 0,
        num_nodes: int = 1,
        local_process_ids: Optional[List[int]] = None,
        storage: Optional[CheckpointStorage] = None,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
        commit_timeout: float = 600.0,
    ):
        self.job_name = job_name
        self.node_id = node_id
        self.node_rank = node_rank
        self.num_nodes = num_nodes
        self.local_process_ids = local_process_ids or [0]
        self._storage = storage or PosixDiskStorage()
        # the local tier is node-local disk by definition: always posix,
        # whatever the object tier's storage
        self._local_storage = PosixDiskStorage()
        self._deletion = deletion_strategy or KeepLatestStepStrategy(3)
        self._commit_timeout = commit_timeout
        self._stop_evt = threading.Event()
        self._persisted_steps: set = set()
        #: steps copied to the local tier whose object fanout (and vote)
        #: has not run yet; fan_out_step drains it
        self._pending_fanout: set = set()
        self.last_persist_dir = ""

    def stop(self):
        self._stop_evt.set()

    def local_handlers(self) -> List[SharedMemoryHandler]:
        out = []
        for pid in self.local_process_ids:
            h = SharedMemoryHandler(shm_name(self.job_name, self.node_id, pid))
            if h.attach():
                out.append(h)
        return out

    def copy_step_to_storage(self, ckpt_dir: str, step: int = -1) -> List[int]:
        """Copy staged shm checkpoints to storage (no commit wait). A node
        votes for a step only when every local process has it staged.
        Returns the steps this node persisted completely."""
        t0 = time.time()
        self.last_persist_dir = ckpt_dir
        handlers = self.local_handlers()
        try:
            by_step: Dict[int, List] = {}
            for h in handlers:
                meta = h.read_meta()
                if meta is None or meta.step in self._persisted_steps:
                    continue
                if step >= 0 and meta.step != step:
                    # persist only the requested step: persisting whatever
                    # is staged would make nodes vote for different steps
                    logger.warning("shm %s holds step %s, requested %s; "
                                   "skipping", h.name, meta.step, step)
                    continue
                by_step.setdefault(meta.step, []).append((meta, h))
            complete_steps = []
            for s, pairs in sorted(by_step.items()):
                for meta, h in pairs:
                    self._write_process_ckpt(ckpt_dir, meta, h)
                if len(pairs) == len(self.local_process_ids):
                    # durable on the local tier; the vote waits for the
                    # object fanout (fan_out_step)
                    self._pending_fanout.add(s)
                    self._persisted_steps.add(s)
                    complete_steps.append(s)
                else:
                    logger.warning(
                        "step %s staged by %s/%s local processes; no vote yet",
                        s, len(pairs), len(self.local_process_ids))
            if complete_steps:
                logger.info("persisted steps %s shm->%s in %.2fs",
                            complete_steps, ckpt_dir, time.time() - t0)
            return complete_steps
        finally:
            for h in handlers:
                h.close()

    def persist_step(
        self, ckpt_dir: str, step: int = -1,
        commit_timeout: Optional[float] = None,
    ) -> bool:
        """Copy, fan out and commit (the commit waits for other nodes)."""
        steps = self.copy_step_to_storage(ckpt_dir, step)
        # drain every pending fanout (retrying earlier failures), then
        # commit every step that was copied or newly cleared its fanout
        cleared = self.drain_fanouts(ckpt_dir)
        for s in sorted(set(steps) | set(cleared)):
            self._maybe_commit(ckpt_dir, s, timeout=commit_timeout)
        return bool(steps)

    def _persist_pool_size(self, n_files: int) -> int:
        return max(1, min(int(flags.CKPT_PERSIST_WORKERS.get()), n_files))

    def _write_process_ckpt(
        self,
        ckpt_dir: str,
        meta: CheckpointMeta,
        handler: SharedMemoryHandler,
    ):
        """One process's staged pieces -> a local-tier proc dir: leaf files
        from the persist pool, straight from the segment's bytes, then the
        manifest (with per-leaf CRC32) last, so a crash mid-write leaves a
        manifest-less dir that restore skips."""
        dest = self._local_storage
        proc_dir = os.path.join(
            step_dir(local_tier_dir(ckpt_dir, self.node_id), meta.step),
            f"proc-{meta.process_id}",
        )
        dest.makedirs(proc_dir)

        def write_leaf(item):
            i, leaf_meta = item
            # raw bytes (dtype and shape live in meta.json)
            data = memoryview(handler.leaf_bytes(leaf_meta).numpy())
            dest.write(data, os.path.join(proc_dir, f"leaf-{i}.bin"))
            return zlib.crc32(data)

        items = list(enumerate(meta.leaves))
        workers = self._persist_pool_size(len(items))
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="ckpt-persist") as pool:
            crcs = list(pool.map(write_leaf, items))
        manifest = dataclasses.replace(
            meta,
            leaves=[
                dataclasses.replace(lm, crc32=crc)
                for lm, crc in zip(meta.leaves, crcs)
            ],
        )
        dest.write(
            manifest.to_json().encode(), os.path.join(proc_dir, "meta.json")
        )

    def drain_fanouts(self, ckpt_dir: str) -> List[int]:
        """Fan out every pending step, oldest first; a step whose fanout
        failed stays pending and is tried again next cycle. Returns the
        steps that cleared (callers owe them a commit wait)."""
        pending = sorted(self._pending_fanout)
        for s in pending:
            self.fan_out_step(ckpt_dir, s)
        return [s for s in pending if s not in self._pending_fanout]

    def fan_out_step(self, ckpt_dir: str, step: int):
        """Copy a step's local proc dirs to the object tier (a pool,
        manifests last), then cast this node's commit vote. On failure the
        step stays pending; a step whose local dir was pruned is dropped."""
        if step not in self._pending_fanout:
            return
        local_sdir = step_dir(local_tier_dir(ckpt_dir, self.node_id), step)
        if not self._local_storage.exists(local_sdir):
            self._pending_fanout.discard(step)
            logger.warning("pending fanout of step %s dropped: local dir "
                           "%s is gone", step, local_sdir)
            return
        obj_sdir = step_dir(ckpt_dir, step)
        copies: List[tuple] = []
        manifests: List[tuple] = []
        for proc in self._local_storage.listdir(local_sdir):
            if not proc.startswith("proc-"):
                continue
            pdir = os.path.join(local_sdir, proc)
            for name in self._local_storage.listdir(pdir):
                pair = (
                    os.path.join(pdir, name),
                    os.path.join(obj_sdir, proc, name),
                )
                (manifests if name == "meta.json" else copies).append(pair)
        try:
            workers = self._persist_pool_size(len(copies))
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="ckpt-fanout") as pool:
                list(pool.map(lambda p: self._storage.put_file(*p), copies))
            for pair in manifests:  # manifests last: the object commit marker
                self._storage.put_file(*pair)
            self._storage.write(
                b"1", os.path.join(obj_sdir, f"node-{self.node_rank}.done"))
        except Exception:
            # the step stays restorable from the local tier and pending;
            # without this node's vote the tracker does not advance to it
            logger.exception("object-tier fanout of step %s failed; no "
                             "commit vote cast (will retry)", step)
            return
        self._pending_fanout.discard(step)
        # every node prunes its own local tier (the object tier is pruned
        # by node-rank 0 at commit time)
        try:
            self._apply_local_deletion(ckpt_dir)
        except Exception:
            logger.exception("local-tier pruning failed")

    def _maybe_commit(
        self, ckpt_dir: str, step: int, timeout: Optional[float] = None
    ):
        """Node-rank 0 waits for every node's vote, then commits."""
        if self.node_rank != 0:
            return
        if step in self._pending_fanout:
            logger.warning("step %s: fanout still pending, skipping the "
                           "commit wait", step)
            return
        sdir = step_dir(ckpt_dir, step)
        deadline = time.time() + (
            timeout if timeout is not None else self._commit_timeout
        )
        while time.time() < deadline and not self._stop_evt.is_set():
            done = [
                f for f in self._storage.listdir(sdir)
                if f.startswith("node-") and f.endswith(".done")
            ]
            if len(done) >= self.num_nodes:
                self._storage.write(
                    str(step).encode(), os.path.join(ckpt_dir, TRACKER_FILE)
                )
                logger.info("checkpoint step %s committed", step)
                self._apply_deletion(ckpt_dir)
                return
            time.sleep(0.5)
        logger.warning("step %s: only partial commit votes after timeout",
                       step)

    def _prune_tier(self, store, root: str, committed: int, protect=()):
        steps = []
        for name in store.listdir(root):
            if name.startswith("step-"):
                try:
                    steps.append(int(name.split("-", 1)[1]))
                except ValueError:
                    continue
        removable = [
            s for s in self._deletion.to_delete(steps)
            if s != committed and s not in protect
        ]
        for s in removable:
            store.delete(step_dir(root, s))
            logger.info("deleted old checkpoint step %s under %s", s, root)

    def _apply_deletion(self, ckpt_dir: str):
        """Object-tier pruning: node-rank 0 only, at commit time."""
        self._prune_tier(self._storage, ckpt_dir,
                         self.committed_step(ckpt_dir))

    def _apply_local_deletion(self, ckpt_dir: str):
        """Local-tier pruning on every node after each fanout; steps still
        awaiting their fanout are kept (their only durable copy)."""
        self._prune_tier(
            self._local_storage, local_tier_dir(ckpt_dir, self.node_id),
            self.committed_step(ckpt_dir),
            protect=frozenset(self._pending_fanout),
        )

    def staged_steps(self) -> Dict[int, int]:
        """{process id: the step staged in its segment} of this node's
        processes that have one."""
        staged: Dict[int, int] = {}
        for h in self.local_handlers():
            try:
                meta = h.read_meta()
                if meta is not None:
                    staged[meta.process_id] = meta.step
            finally:
                h.close()
        return staged

    def save_shm_to_storage(
        self, ckpt_dir: str = "", commit_timeout: Optional[float] = None
    ) -> bool:
        """Persist whatever is staged in shm now: the save-at-breakpoint
        guarantee, run when a worker died or the node is going down.
        Callers on such paths pass a short ``commit_timeout``: a dying node
        must not spend its grace period polling other nodes' votes."""
        ckpt_dir = ckpt_dir or self.last_persist_dir
        steps = set(self.staged_steps().values())
        if not steps:
            return False
        if not ckpt_dir:
            logger.warning("staged shm checkpoint exists but no ckpt_dir "
                           "is known; cannot persist")
            return False
        if steps <= self._persisted_steps:
            # copied to the local tier already; a step whose object fanout
            # failed is still pending, and this is its last chance to reach
            # storage that outlives the node
            if self._pending_fanout:
                self.drain_fanouts(ckpt_dir)
            return not self._pending_fanout
        return self.persist_step(ckpt_dir, commit_timeout=commit_timeout)

    def committed_step(self, ckpt_dir: str) -> int:
        try:
            return int(self._storage.read(
                os.path.join(ckpt_dir, TRACKER_FILE)))
        except (FileNotFoundError, ValueError):
            return -1


class AsyncCheckpointSaver:
    """One a node, hosted by the agent: the IPC server and the persist
    event loop. Checkpoints staged in shm survive the training processes,
    and this process persists them, on a trainer's event or at a
    breakpoint (a worker died)."""

    #: seconds a breakpoint persist waits for the shm lock; a trainer still
    #: staging after it may be mid-overwrite, so nothing is persisted
    BREAKPOINT_LOCK_TIMEOUT = 30.0
    #: the commit wait of a breakpoint persist: a dying node writes its
    #: pieces and vote and gives its peers this long
    BREAKPOINT_COMMIT_TIMEOUT = 30.0

    def __init__(
        self,
        job_name: str,
        node_id: int,
        node_rank: int = 0,
        num_nodes: int = 1,
        local_process_ids: Optional[List[int]] = None,
        storage: Optional[CheckpointStorage] = None,
        deletion_strategy: Optional[CheckpointDeletionStrategy] = None,
        socket_path: str = "",
        replica: bool = False,
    ):
        self.replica_enabled = replica
        self.replica_manager = None
        self.persister = CheckpointPersister(
            job_name=job_name, node_id=node_id, node_rank=node_rank,
            num_nodes=num_nodes, local_process_ids=local_process_ids,
            storage=storage, deletion_strategy=deletion_strategy,
        )
        self.socket_path = socket_path or default_socket_path(job_name,
                                                              node_id)
        self._ipc = IpcServer(self.socket_path)
        self._event_queue: Optional[SharedQueue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        #: one entry a persist event, oldest first: "step", "steps" (those
        #: copied), "copy_s" (shm to the local tier, under the shm lock),
        #: "fanout_s" (the object-tier fanout and the commit, outside it)
        self.persist_log: collections.deque = collections.deque(maxlen=64)

    def start(self):
        self._ipc.start()
        if self.replica_enabled:
            from dlrover_tpu_torch.checkpoint.replica import ReplicaManager

            self.replica_manager = ReplicaManager()
        self._event_queue = SharedQueue(CKPT_EVENT_QUEUE, self.socket_path)
        self._thread = threading.Thread(target=self._event_loop,
                                        name="ckpt-saver", daemon=True)
        self._thread.start()
        logger.info("checkpoint saver started (node %s, ipc %s)",
                    self.persister.node_id, self.socket_path)

    def stop(self):
        """Stop the loop (an in-flight persist gets 10 s to end), the
        replica server and the IPC server."""
        self._stop_evt.set()
        self.persister.stop()
        if self._thread is not None:
            self._thread.join(10.0)
        if self._event_queue is not None:
            self._event_queue.close()
        if self.replica_manager is not None:
            self.replica_manager.server.stop()
        self._ipc.stop()

    # -- replica (cross-host backup) ---------------------------------------

    @property
    def replica_port(self) -> int:
        return self.replica_manager.port if self.replica_manager else 0

    def update_replica_peers(self, peers, self_rank: int, world: int):
        if self.replica_manager is not None:
            self.replica_manager.update_peers(peers, self_rank, world)

    def set_replica_token(self, token: str):
        if self.replica_manager is not None:
            self.replica_manager.set_token(token)

    def maybe_fetch_replica(self) -> int:
        """After a relaunch with nothing staged locally, pull this seat's
        backup from the peer, so the workers restore from memory, not
        storage. Returns the step, or -1."""
        if self.replica_manager is None or self.persister.staged_steps():
            return -1
        targets = [
            shm_name(self.persister.job_name, self.persister.node_id, pid)
            for pid in self.persister.local_process_ids
        ]
        return self.replica_manager.fetch_backup_into_shm(targets)

    def _push_replica(self, step_hint: int = -1):
        """Copy the segments out of shm under the lock, stream them without
        it; a step already pushed is not streamed again."""
        if self.replica_manager is None:
            return
        if 0 <= step_hint <= self.replica_manager.last_pushed_step:
            return
        lock = self._ipc.state.get_lock(SHM_LOCK)
        if not lock.acquire(timeout=30):
            logger.warning("replica push skipped: shm lock busy")
            return
        handlers = self.persister.local_handlers()
        try:
            snapshot = self.replica_manager.collect_segments(handlers)
        finally:
            lock.release()
            for h in handlers:
                h.close()
        if snapshot is None:
            return
        if snapshot[0] <= self.replica_manager.last_pushed_step:
            return
        self.replica_manager.send_backup(*snapshot)

    # -- back-pressure ------------------------------------------------------

    def _release_persist_waiters(self, step: int):
        """Release the persist back-pressure of each process whose staged
        step has reached ``step`` (copied, or moved past). A process still
        holding an older step keeps waiting for its own event: releasing it
        would let it overwrite pieces not yet copied."""
        try:
            staged = self.persister.staged_steps()
            state = self._ipc.state.get_dict(PERSIST_STATE_DICT)
            for pid in self.persister.local_process_ids:
                if staged.get(pid, -1) >= step:
                    key = persist_mark(pid)
                    state[key] = max(int(state.get(key, -1)), step)
        except Exception:
            logger.exception("persist-state release failed")

    def update_topology(self, node_rank: int, num_nodes: int,
                        process_ids: List[int]):
        """Called by the agent after each rendezvous round. A round is a
        restart boundary: a stale ``copied-<pid>`` mark of a higher step
        would disarm the new incarnation's back-pressure after a
        rollback."""
        self.persister.node_rank = node_rank
        self.persister.num_nodes = num_nodes
        self.persister.local_process_ids = list(process_ids)
        self._ipc.state.get_dict(PERSIST_STATE_DICT).clear()

    # -- save at breakpoint -------------------------------------------------

    def save_shm_to_storage(self, ckpt_dir: str = "") -> bool:
        """The breakpoint persist, under the shm lock the trainer stages
        under. The wait is bounded: a dead trainer's dropped connection
        releases its lock, so this cannot wedge; a trainer still staging
        after ``BREAKPOINT_LOCK_TIMEOUT`` may leave a torn segment, so
        nothing is persisted and the committed step stays the restore
        point."""
        lock = self._ipc.state.get_lock(SHM_LOCK)
        if not lock.acquire(timeout=self.BREAKPOINT_LOCK_TIMEOUT):
            logger.error("breakpoint persist: shm lock not acquired in "
                         "%.0fs; refusing to persist a possibly torn "
                         "checkpoint", self.BREAKPOINT_LOCK_TIMEOUT)
            return False
        try:
            return self.persister.save_shm_to_storage(
                ckpt_dir, commit_timeout=self.BREAKPOINT_COMMIT_TIMEOUT)
        finally:
            lock.release()

    def cleanup_shm(self):
        """Unlink the staged segments (only after a successful job end)."""
        for h in self.persister.local_handlers():
            h.close(unlink=True)

    # -- the event loop -----------------------------------------------------

    def _event_loop(self):
        while not self._stop_evt.is_set():
            try:
                raw = self._event_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            except Exception:
                if self._stop_evt.is_set():
                    return
                logger.exception("ckpt event queue read failed")
                time.sleep(1)
                continue
            event = CheckpointEvent.from_wire(raw)
            if event.event_type == "exit":
                return
            if event.event_type == "backup":
                try:
                    self._push_replica(step_hint=event.step)
                except Exception:
                    logger.exception("replica push failed")
                continue
            if event.event_type == "save" and event.persist:
                self._persist(event)

    def _persist(self, event: CheckpointEvent):
        """The shm lock covers only the copy to the local tier (the
        trainer stages under the same lock). The back-pressure is released
        once that copy is done; the fanout reads local files, and it, the
        commit wait and the replica push run outside the lock."""
        entry: Dict[str, Any] = {"step": event.step}
        lock = self._ipc.state.get_lock(SHM_LOCK)
        try:
            t0 = time.perf_counter()
            with lock:
                steps = self.persister.copy_step_to_storage(
                    event.ckpt_dir, event.step)
            entry.update(steps=steps, copy_s=time.perf_counter() - t0)
            self._release_persist_waiters(event.step)
            t1 = time.perf_counter()
            cleared = self.persister.drain_fanouts(event.ckpt_dir)
            for s in sorted(set(steps) | set(cleared)):
                self.persister._maybe_commit(event.ckpt_dir, s)
            entry["fanout_s"] = time.perf_counter() - t1
            if self.replica_manager is not None:
                self._push_replica(step_hint=event.step)
        except Exception as e:
            logger.exception("persist of step %s failed", event.step)
            entry["error"] = repr(e)
        finally:
            # idempotent: also covers a copy that raised
            self._release_persist_waiters(event.step)
            self.persist_log.append(entry)
