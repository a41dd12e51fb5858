"""Training-process side of flash checkpoint (port of
dlrover_tpu/checkpoint/engine.py).

A save stages the train state into this process's shm segment
(shm_handler.py), in the JAX package's layout and under its leaf names; a
storage save then persists the segment in the JAX package's tiered,
CRC-verified layout (saver.py). So either package restores what the other
wrote.

The training pause. The port's trainer updates params and adam moments in
place (train/trainer.py), the counterpart of the JAX step donating its
buffers: once ``save_to_memory`` returns, the next step overwrites the
tensors it was given. So the pause is ``_snapshot_on_device``: one copy of
every tensor leaf into fresh memory on its own device (HBM on the card),
on the current stream, which the next step's in-place update cannot
reach. A background thread then copies the snapshot device to host on a
side stream, ordered after an event behind the snapshot, straight into
the shm segment, whose mapping is registered with CUDA: a DMA, with no
host memcpy and no interpreter lock held while it runs. The mapping is
registered once, by the first save that needs it, before its snapshot:
a refused registration raises from that save. The snapshot is
freed only once the side stream has synchronised, so the caching
allocator cannot hand its blocks to the training stream early. Without
the headroom for a second copy of the state (free device memory plus the
allocator's reserved-but-free bytes, with a 1.15 slack) the save blocks
for the device-to-host copy instead (``last_stage_mode`` "host_gather").

Replica-deduplicated staging (``DLROVER_TPU_CKPT_DEDUP``, default on):
rank ``r`` of a data-parallel group of ``w`` (``ownership_world``) stages
only the pieces ownership.py assigns it; a restore reads the union.

Restore is the JAX package's tier ladder, each rung adding the pieces the
rungs before it were missing: tier 0, shm (this process's segment); tier
1, disk (this node's local tier); tier 2, object (the shared tier, every
node's manifests). Disk and object pieces are CRC-verified, and a corrupt
piece is dropped for the next rung to supply. A restore by target writes
into the target's tensors in place, on their device (host to device from
the registered segment, for the shm tier), so ``requires_grad`` leaves and
the trainer's buffers survive; a leaf the tiers cannot cover fails the
whole restore (None) before any tensor is touched.

The agent's saver. When an ``AsyncCheckpointSaver`` (saver.py) listens on
the node's socket (common/ipc.py), a stage runs under its shm lock, from
the segment's ``begin_write`` through the copies' synchronise to
``publish``, so the saver never reads a torn segment; a storage save
queues a persist event instead of persisting here; and the next stage
first waits for the saver to report that step copied (``copied-<pid>``,
the back-pressure). With no saver listening (a bare run) the staging
thread persists inline, as the JAX engine does without an agent. Under
``DLROVER_TPU_CKPT_REPLICA=1`` every stage also asks the saver to push the
segment to the backup peer (replica.py).

Not ported here, each named in ROADMAP.md: the report of a save to the
master (it waits for the port's master client), the compile-cache default,
and trace spans.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
import warnings
import weakref
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint import ownership
from dlrover_tpu_torch.checkpoint.saver import (
    CKPT_EVENT_QUEUE,
    PERSIST_STATE_DICT,
    SHM_LOCK,
    TRACKER_FILE,
    CheckpointEvent,
    CheckpointPersister,
    local_tier_dir,
    persist_mark,
    step_dir,
)
from dlrover_tpu_torch.checkpoint.shm_handler import (
    CheckpointMeta,
    Leaf,
    SharedMemoryHandler,
    as_bytes,
    decode,
    flatten_state,
    layout,
    shm_name,
    torch_dtype,
)
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.ipc import (
    SharedDict,
    SharedLock,
    SharedQueue,
    default_socket_path,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    PosixDiskStorage,
)

Ranges = ownership.Ranges
# a staged piece as a restore reads it: (ranges in the leaf, its bytes as a
# flat uint8 CPU tensor, the leaf's shape, dtype name)
Piece = Tuple[Ranges, torch.Tensor, Tuple[int, ...], str]

# a second copy of the state needs this much more than its bytes free
HEADROOM_SLACK = 1.15
# seconds a stage waits for the saver's shm lock, and for the saver to copy
# the previous persisted step (the back-pressure)
SHM_LOCK_TIMEOUT = 120.0
PERSIST_WAIT_TIMEOUT = 120.0


@dataclasses.dataclass
class _Stage:
    """One piece to stage: ``data`` is a tensor (on any device) or a numpy
    array; ``index`` its ranges in a leaf of shape ``gshape``."""

    name: str
    data: Any
    gshape: Tuple[int, ...]
    index: Ranges


def _nbytes(value) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    return value.numel() * value.element_size()


def _full(shape) -> Ranges:
    return tuple((0, int(d)) for d in shape)


def _bytes_of(data: bytes) -> torch.Tensor:
    """A file's bytes as a flat uint8 tensor, without a copy."""
    if not data:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        # read-only: nothing writes to a piece's bytes
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(data, dtype=torch.uint8)


def region_covered(needed: Ranges, plist: List[Piece]) -> bool:
    """The pieces' union covers the region: the region is cut on the
    pieces' boundaries and every cell must lie inside some piece."""
    cuts = []
    for d, (ns, ne) in enumerate(needed):
        c = {ns, ne}
        for p_index, _, _, _ in plist:
            ps, pe = p_index[d]
            if ns < ps < ne:
                c.add(ps)
            if ns < pe < ne:
                c.add(pe)
        edges = sorted(c)
        cuts.append(list(zip(edges, edges[1:])))
    for cell in itertools.product(*cuts):
        if not any(
            all(ps <= cs and ce <= pe
                for (cs, ce), (ps, pe) in zip(cell, p_index))
            for p_index, _, _, _ in plist
        ):
            return False
    return True


#: live engines whose in-flight stage must be drained at teardown: one
#: atexit hook and one SIGTERM chain link a process, weakly referenced so
#: an engine dropped without close() is not pinned forever
_DRAIN_REGISTRY = weakref.WeakSet()
_drain_hooks_installed = False


def _drain_all_engines():
    for eng in list(_DRAIN_REGISTRY):
        try:
            eng._drain_at_exit()
        except BaseException as e:  # one engine's failure must not skip
            # the remaining drains or the SIGTERM re-kill chain
            logger.warning("drain of %r at teardown failed: %s", eng, e)


def _install_drain_hooks():
    global _drain_hooks_installed
    if _drain_hooks_installed:
        return
    _drain_hooks_installed = True
    import atexit
    import signal

    atexit.register(_drain_all_engines)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            _drain_all_engines()
            if callable(prev):
                prev(signum, frame)
            else:
                # SIG_DFL or SIG_IGN, or None for a handler installed from
                # C: re-raise with the default action
                signal.signal(signum, prev or signal.SIG_DFL)
                os.kill(os.getpid(), signum)
                # reached only when the re-raise was ignored: keep draining
                # on later SIGTERMs
                signal.signal(signum, _on_term)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # not the main thread: atexit alone still covers exits


class CheckpointEngine:
    def __init__(
        self,
        ckpt_dir: str,
        job_name: str = "",
        node_id: Optional[int] = None,
        process_id: Optional[int] = None,
        storage: Optional[CheckpointStorage] = None,
        async_staging: Optional[bool] = None,
        dedup: Optional[bool] = None,
        ownership_world: Optional[Tuple[int, int]] = None,
        socket_path: str = "",
    ):
        self.ckpt_dir = ckpt_dir
        self.job_name = job_name or flags.JOB_NAME.get()
        self.node_id = (
            node_id if node_id is not None else int(flags.NODE_ID.get())
        )
        self.process_id = (
            process_id if process_id is not None
            else int(flags.PROCESS_ID.get())
        )
        self._storage = storage or PosixDiskStorage()
        self._shm = SharedMemoryHandler(
            shm_name(self.job_name, self.node_id, self.process_id), create=True
        )
        self._socket_path = socket_path or default_socket_path(
            self.job_name, self.node_id)
        self._event_queue: Optional[SharedQueue] = None
        self._shm_lock: Optional[SharedLock] = None
        self._persist_state: Optional[SharedDict] = None
        #: the step of the last queued persist not yet reported copied
        self._awaiting_persist = -1
        self.latest_saved_step = -1
        if async_staging is None:
            async_staging = flags.ASYNC_STAGING.get()
        self._async_staging = bool(async_staging)
        self._device_snapshot_enabled = flags.DEVICE_SNAPSHOT.get()
        self._side_streams: Dict[torch.device, Any] = {}
        self._staging_thread: Optional[threading.Thread] = None
        self._staging_error: Optional[BaseException] = None
        self._crash_drain_installed = False
        #: how the last save staged: "device_snapshot" (pause = one copy on
        #: the tensors' device), "host_gather" (pause = the device-to-host
        #: copy), or "sync" (pause = the whole stage)
        self.last_stage_mode = ""
        #: the last targeted restore: "tier" (shm | disk | object, the
        #: deepest rung that contributed), "tiers_read", "pieces", "bytes",
        #: "register_s" (registering the segment with CUDA), "seconds"
        self.last_restore_stats: Dict[str, Any] = {}
        #: the last completed stage: "step", "mode", "pause_s" (with
        #: "register_s", a new mapping's registration, in it), "stage_s"
        #: (the background's seconds), "wait_s" (waiting for the saver to
        #: copy the previous persisted step), "copy_s" and "device_bytes"
        #: (device to host), "persist" ("inline" or "queued", on a storage
        #: save) and "persist_s" (an inline persist's seconds),
        #: "staged_bytes", "skipped_replica_bytes", "dedup"
        self.last_stage_stats: Dict[str, Any] = {}
        #: the most recent completed stages' stats, oldest first
        self.stage_log: collections.deque = collections.deque(maxlen=64)
        self._dedup = dedup
        self._ownership_world = ownership_world
        self._local_tier_storage = PosixDiskStorage()
        # lives as long as the engine, so its pending-fanout retries
        # survive across bare-run saves (_persist_inline)
        self._inline_persister: Optional[CheckpointPersister] = None

    # -- the agent's saver (lazy: a bare run has none) ----------------------

    def _ipc_available(self) -> bool:
        return os.path.exists(self._socket_path)

    def _queue(self) -> Optional[SharedQueue]:
        if self._event_queue is None and self._ipc_available():
            self._event_queue = SharedQueue(CKPT_EVENT_QUEUE,
                                            self._socket_path)
        return self._event_queue

    def _lock(self) -> Optional[SharedLock]:
        if self._shm_lock is None and self._ipc_available():
            self._shm_lock = SharedLock(SHM_LOCK, self._socket_path)
        return self._shm_lock

    def _persist_dict(self) -> Optional[SharedDict]:
        if self._persist_state is None and self._ipc_available():
            self._persist_state = SharedDict(PERSIST_STATE_DICT,
                                             self._socket_path)
        return self._persist_state

    def _wait_pending_persist(self, timeout: float = PERSIST_WAIT_TIMEOUT):
        """The back-pressure: a queued persist reads the segment as the
        saver finds it, so staging the next step before the saver's copy
        would lose the persisted step (the saver skips a step it was not
        asked for). Wait until the saver reports the step copied; after
        ``timeout``, warn and stage anyway."""
        if self._awaiting_persist < 0:
            return
        state = self._persist_dict()
        if state is None:
            self._awaiting_persist = -1
            return
        deadline = time.time() + timeout
        key = persist_mark(self.process_id)
        while time.time() < deadline:
            try:
                copied = state.get(key)
            except OSError as e:  # the saver went away
                logger.warning("persist state unreadable (%s)", e)
                break
            if copied is not None and int(copied) >= self._awaiting_persist:
                self._awaiting_persist = -1
                return
            time.sleep(0.02)
        logger.warning("persist of step %s still pending after %.0fs; "
                       "staging anyway (that step may not reach storage)",
                       self._awaiting_persist, timeout)
        self._awaiting_persist = -1

    def _claim_segment(self, step: int) -> Tuple[Optional[SharedLock],
                                                 float]:
        """Before a stage overwrites the segment: the back-pressure wait,
        then the saver's shm lock (None without a saver). Returns the lock
        and the seconds both took; raises TimeoutError when the lock is not
        had in ``SHM_LOCK_TIMEOUT``."""
        t0 = time.perf_counter()
        self._wait_pending_persist()
        lock = self._lock()
        if lock is not None and not lock.acquire(timeout=SHM_LOCK_TIMEOUT):
            raise TimeoutError(f"shm lock not acquired in "
                               f"{SHM_LOCK_TIMEOUT:.0f}s; step {step} not "
                               f"staged")
        return lock, time.perf_counter() - t0

    def _request_backup(self, step: int):
        """Replica mode (set by the agent): ask the saver to push the
        staged segment to the backup peer."""
        if flags.CKPT_REPLICA.get() == "1":
            q = self._queue()
            if q is not None:
                q.put(CheckpointEvent("backup", step=step).to_wire())

    def _queue_persist(self, step: int) -> Dict[str, Any]:
        """Hand the persist of the staged ``step`` to the saver, or, with
        none listening, persist it here. Returns its stats."""
        q = self._queue()
        if q is not None:
            q.put(CheckpointEvent(
                "save", step=step, persist=True,
                ckpt_dir=os.path.abspath(self.ckpt_dir)).to_wire())
            self._awaiting_persist = step
            return {"persist": "queued"}
        t0 = time.perf_counter()
        self._persist_inline(step)
        return {"persist": "inline", "persist_s": time.perf_counter() - t0}

    # -- save ---------------------------------------------------------------

    def _ownership_info(self) -> Optional[Tuple[int, int]]:
        """(rank, world) when replica-deduplicated staging applies. The
        port runs one process (data parallelism across processes is a
        later slice), so only ``ownership_world`` gives a world above 1."""
        enabled = (
            bool(self._dedup) if self._dedup is not None
            else flags.CKPT_DEDUP.get()
        )
        if not enabled or self._ownership_world is None:
            return None
        rank, world = self._ownership_world
        return (int(rank), int(world)) if world > 1 else None

    def _plan(self, state) -> Tuple[List[_Stage], List[str], Dict[str, Any]]:
        """The pieces this process stages, in flatten order (under dedup
        only the owned ones: ownership.py's partition), the full leaf
        list, and the staged and skipped bytes. Python scalars are read
        here, at save time."""
        leaves = flatten_state(state)
        own = self._ownership_info()
        rr = ownership.RoundRobin() if own is not None else None
        stages: List[_Stage] = []
        skipped = 0
        for leaf in leaves:
            value = leaf.value
            shape = tuple(value.shape)
            full = _full(shape)
            name = f"{leaf.name}#s0"
            if own is None:
                stages.append(_Stage(name, value, shape, full))
                continue
            mine = [a for a in ownership.assign_leaf(shape, own[1], rr)
                    if a.owner == own[0]]
            if len(mine) == 1 and mine[0].ranges == full:
                stages.append(_Stage(name, value, shape, full))
                continue
            owned = 0
            for j, a in enumerate(mine):
                sub = value[ownership.ranges_to_index(a.ranges)]
                stages.append(_Stage(f"{name}.{j}", sub, shape, a.ranges))
                owned += _nbytes(sub)
            skipped += _nbytes(value) - owned
        stats = {
            "staged_bytes": sum(_nbytes(s.data) for s in stages),
            "skipped_replica_bytes": skipped,
            "dedup": own is not None,
        }
        return stages, [leaf.name for leaf in leaves], stats

    def save_to_memory(self, step: int, state: Any) -> float:
        """Stage into shm; returns the blocking seconds (the training
        pause). With async staging the stage runs in a background thread;
        the next save (or load, or close) joins it first."""
        t0 = time.time()
        if self._async_staging:
            return self._start_async_stage(t0, step, state, persist=False)
        self._stage_sync(step, state)
        return time.time() - t0

    def _install_crash_drain(self):
        """Join the in-flight stage on every teardown the interpreter sees:
        atexit (normal exit, uncaught exceptions) and a chained SIGTERM
        handler (agent restarts, preemption). The snapshot dies with the
        process, so the drain is what turns "save() returned" into "that
        step is recoverable" for every crash short of SIGKILL; a hard kill
        falls back to the last step fully staged (the header is cleared
        before a write and published after it, so a torn write is never
        read) or to the last persist."""
        if self._crash_drain_installed:
            return
        self._crash_drain_installed = True
        _DRAIN_REGISTRY.add(self)
        _install_drain_hooks()

    def _drain_at_exit(self):
        try:
            self.wait_staging(timeout=float(flags.DRAIN_TIMEOUT.get()))
        except BaseException as e:  # staging errors are stored broadly
            logger.warning("checkpoint drain at exit failed: %s", e)

    def _start_async_stage(
        self, t0: float, step: int, state: Any, persist: bool
    ) -> float:
        self._install_crash_drain()
        # a failure of the previous stage lost that step: log it and go on
        # with this one (the join leaves the shm free)
        try:
            self.wait_staging()
        except Exception as e:
            logger.warning(
                "previous background staging failed (%s); continuing", e
            )
        self._staging_error = None
        stages, leaf_paths, plan_stats = self._plan(state)
        plan_stats["register_s"] = self._reserve(stages)
        snapshot = self._snapshot_on_device(stages)
        on_device = snapshot is not None
        self.last_stage_mode = ("device_snapshot" if on_device
                                else "host_gather")
        lock = None
        if on_device:
            payload = list(snapshot)
        else:
            # no headroom or snapshot off: the device-to-host copy happens
            # here, before the caller's next (in-place) step can run, under
            # the shm lock, which the staging thread releases once it has
            # published
            try:
                lock, plan_stats["wait_s"] = self._claim_segment(step)
                payload = [self._write_stages(stages)]
            except Exception as e:
                if lock is not None:
                    lock.release()
                logger.warning("device->host copy of step %s failed: %s",
                               step, e)
                # surfaced by the next wait_staging/load/close
                self._staging_error = e
                return time.time() - t0
        pause = time.time() - t0
        self._staging_thread = threading.Thread(
            target=self._stage_in_background,
            args=(step, payload, leaf_paths, on_device, persist, pause,
                  plan_stats, lock),
            name="ckpt-staging",
            daemon=True,
        )
        self._staging_thread.start()
        return time.time() - t0

    # -- device-side snapshot ----------------------------------------------

    def _snapshot_on_device(self, stages: List[_Stage]):
        """Copy every tensor piece into fresh memory on its device, on the
        current stream, and wait for the copies: the pause. Returns
        ``(snapshot stages, {device: event behind the copies})``, or None
        when the save should block for the device-to-host copy instead
        (snapshot off, no tensor, no headroom, or the copy ran out of
        memory)."""
        if not self._device_snapshot_enabled:
            return None
        if not any(isinstance(s.data, torch.Tensor) for s in stages):
            return None
        if not self._headroom_ok(stages):
            logger.warning(
                "insufficient device memory for a checkpoint snapshot; "
                "blocking for the device-to-host copy instead"
            )
            return None
        events: Dict[torch.device, Any] = {}
        try:
            with torch.no_grad():
                snap = [
                    dataclasses.replace(s, data=s.data.clone(
                        memory_format=torch.contiguous_format))
                    if isinstance(s.data, torch.Tensor) else s
                    for s in stages
                ]
            for s in snap:
                if isinstance(s.data, torch.Tensor) and s.data.is_cuda:
                    dev = s.data.device
                    if dev not in events:
                        events[dev] = torch.cuda.Event()
                        events[dev].record(torch.cuda.current_stream(dev))
            for ev in events.values():
                ev.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            logger.warning("device-side snapshot failed (%s); blocking for "
                           "the device-to-host copy instead", e)
            return None
        return snap, events

    @staticmethod
    def _headroom_ok(stages: List[_Stage], slack: float = HEADROOM_SLACK
                     ) -> bool:
        """Each CUDA device can hold a second copy of its pieces: free
        memory plus the caching allocator's reserved-but-free bytes, over
        the pieces' bytes times ``slack``. Optimistic for the CPU."""
        need: Dict[torch.device, int] = {}
        for s in stages:
            if isinstance(s.data, torch.Tensor) and s.data.is_cuda:
                dev = s.data.device
                need[dev] = need.get(dev, 0) + _nbytes(s.data)
        for dev, nbytes in need.items():
            free, _ = torch.cuda.mem_get_info(dev)
            free += (torch.cuda.memory_reserved(dev)
                     - torch.cuda.memory_allocated(dev))
            if free < nbytes * slack:
                return False
        return True

    def _side_stream(self, device: torch.device):
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device=device)
        return self._side_streams[device]

    def _reserve(self, stages: List[_Stage]) -> float:
        """Size the segment for ``stages`` and, when a piece is on the
        card, register it with CUDA (once a mapping), in the saving
        thread: a refused registration raises from the save, and the
        one-time cost of registering (PERF.md, PR 7) is the pause of the
        save that pays it. Returns the registration's seconds."""
        self._shm.reserve(sum(_nbytes(s.data) for s in stages))
        if any(isinstance(s.data, torch.Tensor) and s.data.is_cuda
               for s in stages):
            return self._shm.pin()
        return 0.0

    def _write_stages(self, stages: List[_Stage], events=None
                      ) -> Tuple[list, Dict[str, Any]]:
        """Copy the pieces into the segment at the JAX layout's offsets,
        with its header cleared; returns their metas and copy stats. CUDA
        pieces are DMAs into the registered mapping: on a side stream
        ordered after ``events`` (a snapshot), else on the current stream
        (after the step that made them). Waits for the copies."""
        metas = layout([(s.name, s.data) for s in stages],
                       {s.name: (s.gshape, s.index) for s in stages})
        seg = self._shm.begin_write(sum(m.nbytes for m in metas))
        cuda = [s for s in stages
                if isinstance(s.data, torch.Tensor) and s.data.is_cuda]
        t0 = time.perf_counter()
        streams = {}
        for m, s in zip(metas, stages):
            dst = seg[m.offset:m.offset + m.nbytes]
            src = as_bytes(s.data)
            if not src.is_cuda:
                dst.copy_(src)
                continue
            dev = src.device
            if dev not in streams:
                if events is None:
                    streams[dev] = torch.cuda.current_stream(dev)
                else:
                    streams[dev] = self._side_stream(dev)
                    streams[dev].wait_event(events[dev])
            with torch.cuda.stream(streams[dev]):
                dst.copy_(src, non_blocking=True)
        for stream in streams.values():
            stream.synchronize()  # releases the interpreter lock
        return metas, {
            "copy_s": time.perf_counter() - t0,
            "device_bytes": sum(_nbytes(s.data) for s in cuda),
        }

    def _publish(self, step: int, metas, leaf_paths: List[str]):
        self._shm.publish(CheckpointMeta(
            step=step, leaves=metas, timestamp=time.time(), world_size=1,
            process_id=self.process_id, total_bytes=sum(
                m.nbytes for m in metas),
            ckpt_dir=os.path.abspath(self.ckpt_dir), leaf_paths=leaf_paths,
        ))
        self.latest_saved_step = step

    def wait_staging(self, timeout: Optional[float] = None):
        """Join any in-flight background stage; re-raise its failure.
        Raises TimeoutError (keeping the thread tracked) if it is still
        running after ``timeout``: callers must not touch the shm then."""
        thread = self._staging_thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise TimeoutError(
                    f"checkpoint staging still running after {timeout}s"
                )
            self._staging_thread = None
        if self._staging_error is not None:
            err, self._staging_error = self._staging_error, None
            raise err

    def _stage_in_background(
        self, step: int, payload: list, leaf_paths: List[str],
        on_device: bool, persist: bool, pause: float,
        plan_stats: Dict[str, Any], lock: Optional[SharedLock],
    ):
        """The stage's second half. ``lock``: the shm lock a host gather
        took in the saving thread (one connection's lock, so this thread
        may release it); a snapshot's stage claims the segment here, the
        device snapshot alive while it waits."""
        stats: Dict[str, Any] = {"step": step, "mode": self.last_stage_mode,
                                 "pause_s": pause, **plan_stats}
        try:
            if on_device:
                lock, stats["wait_s"] = self._claim_segment(step)
                t0 = time.perf_counter()
                snap, events = payload
                metas, copy_stats = self._write_stages(snap, events)
                # the side stream has synchronised: the snapshot may go
                del snap
            else:
                t0 = time.perf_counter()
                metas, copy_stats = payload[0]
            payload.clear()
            stats.update(copy_stats)
            self._publish(step, metas, leaf_paths)
            if lock is not None:
                lock.release()
                lock = None
            stats["stage_s"] = time.perf_counter() - t0
            self._request_backup(step)
            if persist:
                stats.update(self._queue_persist(step))
            self.last_stage_stats = stats
            self.stage_log.append(stats)
        except BaseException as e:  # re-raised by the next wait_staging
            logger.exception("background staging of step %s failed", step)
            # the only reader (wait_staging) joins this thread first
            self._staging_error = e
        finally:
            payload.clear()
            if lock is not None:
                lock.release()

    def _stage_sync(self, step: int, state: Any):
        self.last_stage_mode = "sync"
        stages, leaf_paths, plan_stats = self._plan(state)
        plan_stats["register_s"] = self._reserve(stages)
        lock, plan_stats["wait_s"] = self._claim_segment(step)
        try:
            metas, copy_stats = self._write_stages(stages)
            self._publish(step, metas, leaf_paths)
        finally:
            if lock is not None:
                lock.release()
        self._request_backup(step)
        self.last_stage_stats = {"step": step, "mode": "sync", **plan_stats,
                                 **copy_stats}
        self.stage_log.append(self.last_stage_stats)

    def save_to_storage(self, step: int, state: Any) -> float:
        """Stage, then persist: a persist event to the agent's saver, or,
        with none listening, inline (in the staging thread, with async
        staging). Returns the blocking seconds."""
        t0 = time.time()
        if self._async_staging:
            return self._start_async_stage(t0, step, state, persist=True)
        try:
            self._stage_sync(step, state)
        except TimeoutError as e:
            # nothing was staged: a persist event would make the saver
            # persist an older step as if it were this one
            logger.error("%s; skipping persist", e)
            return time.time() - t0
        self.last_stage_stats.update(self._queue_persist(step))
        return time.time() - t0

    def _persist_inline(self, step: int):
        if self._inline_persister is None:
            self._inline_persister = CheckpointPersister(
                job_name=self.job_name,
                node_id=self.node_id,
                local_process_ids=[self.process_id],
                storage=self._storage,
            )
        self._inline_persister.persist_step(self.ckpt_dir, step)

    # -- load ---------------------------------------------------------------

    def load(self, target: Any = None) -> Optional[Tuple[int, Any]]:
        """Restore ``(step, state)`` through the tier ladder: shm, then
        the node-local disk tier, then the shared object tier, each rung
        adding the pieces the earlier ones were missing. With a
        target the state is the target, its tensors overwritten in place;
        without one, ``{leaf name: CPU tensor}``."""
        try:
            self.wait_staging()
        except Exception as e:
            logger.warning("in-flight staging failed before load: %s", e)
        t0 = time.perf_counter()
        self.last_restore_stats = {}
        result = self._load_tiered(target)
        if result is not None and target is not None:
            self.last_restore_stats["seconds"] = time.perf_counter() - t0
        return result

    # -- tiered load (shm -> local disk -> object) --------------------------

    def _staged_shm_meta(self) -> Optional[CheckpointMeta]:
        """This process's staged shm meta, unless another checkpoint
        directory's engine staged it under the same name."""
        meta = self._shm.read_meta()
        if (
            meta is not None and meta.ckpt_dir
            and meta.ckpt_dir != os.path.abspath(self.ckpt_dir)
        ):
            logger.info(
                "staged shm belongs to %s (this engine: %s); ignoring",
                meta.ckpt_dir, os.path.abspath(self.ckpt_dir),
            )
            return None
        return meta

    def _load_tiered(self, target: Any = None):
        shm_meta = self._staged_shm_meta()
        shm_step = shm_meta.step if shm_meta is not None else -1
        committed = self.committed_step()
        candidates = []
        if shm_step >= 0:
            candidates.append(shm_step)
        if committed >= 0 and committed != shm_step:
            candidates.append(committed)
        for step in candidates:
            result = self._restore_step_tiered(
                step, target, shm_meta if step == shm_step else None
            )
            if result is not None:
                return result
        if candidates:
            # coverage gaps after the last rung mean lost pieces; a
            # partial state is the one outcome worse than no restore
            logger.error(
                "tiered restore failed: no tier union covers the target "
                "for candidate steps %s (shm/local-disk/object read)",
                candidates,
            )
        return None

    def _merge_tier_pieces(
        self, storage, sdir: str, step: int, pieces, seen, expected
    ) -> Tuple[int, int]:
        """Merge one disk tier's pieces of ``step`` into ``pieces``,
        skipping (leaf, region)s an earlier rung supplied and verifying
        each leaf file's CRC (a corrupt piece is dropped for the next rung
        to supply). Leaf files are read and checked by a pool. Returns
        (pieces added, bytes added)."""
        added_p = added_b = 0
        for name in storage.listdir(sdir):
            if not name.startswith("proc-"):
                continue
            pdir = os.path.join(sdir, name)
            try:
                meta = CheckpointMeta.from_json(
                    storage.read(os.path.join(pdir, "meta.json")).decode()
                )
            except (FileNotFoundError, ValueError, KeyError):
                continue  # manifest-less dir = torn write; skip it
            if meta.step != step:
                continue
            if not expected and meta.leaf_paths:
                expected.extend(meta.leaf_paths)
            todo = [(i, lm) for i, lm in enumerate(meta.leaves)
                    if (lm.path.rsplit("#", 1)[0], lm.index) not in seen]

            def read(item):
                i, lm = item
                try:
                    data = storage.read(os.path.join(pdir, f"leaf-{i}.bin"))
                except OSError:
                    return None, False
                return data, (not lm.crc32
                              or zlib.crc32(data) == (lm.crc32 & 0xFFFFFFFF))

            workers = max(1, min(int(flags.CKPT_PERSIST_WORKERS.get()),
                                 len(todo)))
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="ckpt-read") as pool:
                results = list(pool.map(read, todo))
            for (i, lm), (data, crc_ok) in zip(todo, results):
                base = lm.path.rsplit("#", 1)[0]
                key = (base, lm.index)
                if data is None or key in seen:
                    continue
                if not crc_ok:
                    logger.warning(
                        "CRC mismatch for %s piece %s under %s; dropping "
                        "the corrupt piece (a later tier supplies it)",
                        base, lm.index, pdir,
                    )
                    continue
                try:
                    itemsize = torch.empty(0, dtype=torch_dtype(
                        lm.dtype)).element_size()
                except ValueError as e:
                    logger.warning("unreadable piece %s under %s (%s); "
                                   "dropping", base, pdir, e)
                    continue
                if len(data) != int(np.prod(lm.shape)) * itemsize:
                    logger.warning("piece %s under %s holds %d bytes, not "
                                   "its shape's; dropping", base, pdir,
                                   len(data))
                    continue
                pieces.setdefault(base, []).append(
                    (lm.index, _bytes_of(data), lm.global_shape, lm.dtype)
                )
                seen.add(key)
                added_p += 1
                added_b += len(data)
        return added_p, added_b

    def _restore_step_tiered(self, step: int, target, shm_meta):
        """Accumulate pieces of ``step`` rung by rung, trying to assemble
        after every rung that contributed; the deepest rung read is the
        restore's tier."""
        pieces: Dict[str, List[Piece]] = {}
        seen: set = set()
        expected: List[str] = []  # full leaf list, manifest flatten order
        contributed: List[str] = []
        total_p = total_b = 0

        def attempt():
            if not pieces:
                return None
            return self._assemble(step, pieces, target,
                                  expected_paths=expected or None,
                                  from_shm="shm" in contributed)

        def success(result):
            stats = self.last_restore_stats if target is not None else {}
            stats["tier"] = contributed[-1]
            stats["tiers_read"] = list(contributed)
            stats["pieces"] = total_p
            stats["bytes"] = total_b
            self.last_restore_stats = stats
            logger.info(
                "restored step %s via tier %s (%d pieces, %d bytes, rungs "
                "read: %s)", step, stats["tier"], total_p, total_b,
                contributed,
            )
            return result

        # tier 0: this process's shm segment
        if shm_meta is not None and shm_meta.step == step:
            if not expected and shm_meta.leaf_paths:
                expected.extend(shm_meta.leaf_paths)
            added = 0
            for base, plist in self._read_pieces_from_shm(shm_meta).items():
                for piece in plist:
                    key = (base, tuple(piece[0]))
                    if key in seen:
                        continue
                    seen.add(key)
                    pieces.setdefault(base, []).append(piece)
                    added += 1
                    total_b += piece[1].numel()
            if added:
                total_p += added
                contributed.append("shm")
                result = attempt()
                if result is not None:
                    return success(result)
        # tier 1: the node-local disk tier (this node's process manifests)
        local_sdir = step_dir(local_tier_dir(self.ckpt_dir, self.node_id),
                              step)
        p, b = self._merge_tier_pieces(
            self._local_tier_storage, local_sdir, step, pieces, seen,
            expected,
        )
        if p:
            total_p += p
            total_b += b
            contributed.append("disk")
            result = attempt()
            if result is not None:
                return success(result)
        # tier 2: the shared object tier (every node's manifests)
        p, b = self._merge_tier_pieces(
            self._storage, step_dir(self.ckpt_dir, step), step, pieces, seen,
            expected,
        )
        if p:
            total_p += p
            total_b += b
            contributed.append("object")
            result = attempt()
            if result is not None:
                return success(result)
        return None

    def _read_pieces_from_shm(self, meta: CheckpointMeta
                              ) -> Dict[str, List[Piece]]:
        """The segment's pieces as views of it (no copy)."""
        pieces: Dict[str, List[Piece]] = {}
        for lm in meta.leaves:
            base = lm.path.rsplit("#", 1)[0]
            pieces.setdefault(base, []).append(
                (tuple(lm.index), self._shm.leaf_bytes(lm),
                 tuple(lm.global_shape), lm.dtype)
            )
        return pieces

    def _assemble(
        self, step, pieces: Dict[str, List[Piece]], target,
        expected_paths: Optional[List[str]] = None, from_shm: bool = False,
    ):
        """Rebuild the state from pieces. With a ``target`` every leaf is
        checked first (shape, and that the pieces cover it) and only then
        written in place; otherwise a flat
        ``{leaf name: CPU tensor}`` in the manifest's order.

        ``expected_paths``: the checkpoint's full leaf list. A target leaf
        in it with no pieces is missing data (None, so the caller reads
        the next tier), while a leaf outside it was never saved and keeps
        its target value. ``from_shm``: some pieces are views of the
        segment."""
        expected_set = set(expected_paths) if expected_paths else None
        if target is not None:
            plan = []
            for leaf in flatten_state(target):
                plist = pieces.get(leaf.name)
                if not plist:
                    if expected_set is not None and leaf.name in expected_set:
                        logger.warning(
                            "leaf %s is in the checkpoint manifest but no "
                            "pieces are available from the tiers read so "
                            "far", leaf.name,
                        )
                        return None
                    logger.warning("checkpoint missing leaf %s; keeping "
                                   "target", leaf.name)
                    continue
                gshape = tuple(plist[0][2])
                if gshape != tuple(leaf.value.shape):
                    # same path, another shape: not this checkpoint (a
                    # stale segment of an unrelated job under the name)
                    logger.warning(
                        "checkpoint leaf %s shape %s != target %s; "
                        "rejecting this source",
                        leaf.name, gshape, tuple(leaf.value.shape),
                    )
                    return None
                if not region_covered(_full(gshape), plist):
                    logger.info("staged pieces do not cover leaf %s; "
                                "falling back to storage", leaf.name)
                    return None
                plan.append((leaf, plist))
            self.last_restore_stats = self._place(plan, from_shm)
            return step, target
        if expected_set is not None:
            missing = [p for p in expected_paths if p not in pieces]
            if missing:
                logger.warning("checkpoint leaves %s have no pieces in the "
                               "tiers read so far", missing[:3])
                return None
            paths = list(expected_paths)
        else:
            paths = list(pieces)
        out = {}
        for path in paths:
            plist = pieces[path]
            gshape = tuple(plist[0][2])
            if not region_covered(_full(gshape), plist):
                logger.info("staged pieces do not cover %s; need storage "
                            "restore", path)
                return None
            full = torch.zeros(gshape, dtype=torch_dtype(plist[0][3]))
            for index, data, _, dt in plist:
                extent = tuple(e - s for s, e in index)
                full[ownership.ranges_to_index(index)] = decode(
                    data.clone(), dt, extent)
            out[path] = full
        return step, out

    def _place(self, plan: List[Tuple[Leaf, List[Piece]]],
               from_shm: bool) -> Dict[str, Any]:
        """Write checked pieces into the target in place: a tensor leaf
        on its device (a whole-leaf piece of its dtype as one copy of
        bytes, a DMA from the registered segment when ``from_shm``), a
        Python scalar by replacing it in its container."""
        cuda = {leaf.value.device for leaf, _ in plan
                if isinstance(leaf.value, torch.Tensor) and leaf.value.is_cuda}
        stats: Dict[str, Any] = {
            "register_s": self._shm.pin() if cuda and from_shm else 0.0,
            "placed": len(plan),
        }
        with torch.no_grad():
            for leaf, plist in plan:
                value = leaf.container[leaf.key]
                if isinstance(value, (bool, int, float)):
                    _, data, _, dt = plist[0]
                    leaf.container[leaf.key] = type(value)(
                        decode(data.clone(), dt, ()).item())
                    continue
                if isinstance(value, np.ndarray):
                    value = torch.from_numpy(value)
                for index, data, gshape, dt in plist:
                    if (index == _full(gshape) and value.is_contiguous()
                            and torch_dtype(dt) == value.dtype):
                        as_bytes(value).copy_(data, non_blocking=True)
                    else:
                        extent = tuple(e - s for s, e in index)
                        value[ownership.ranges_to_index(index)].copy_(
                            decode(data.clone(), dt, extent))
        # the copies read the segment, which the next save overwrites
        for dev in cuda:
            torch.cuda.current_stream(dev).synchronize()
        return stats

    # -- misc ---------------------------------------------------------------

    def committed_step(self) -> int:
        try:
            return int(
                self._storage.read(os.path.join(self.ckpt_dir, TRACKER_FILE))
            )
        except (FileNotFoundError, ValueError):
            return -1

    def close(self, unlink_shm: bool = False):
        """Drain the in-flight stage and release the segment.
        ``unlink_shm`` also removes it: for short-lived tools whose staged
        state must not outlive them; a training process keeps it, so a
        restart restores from it."""
        _DRAIN_REGISTRY.discard(self)
        self._crash_drain_installed = False
        try:
            self.wait_staging(timeout=300)
        except Exception as e:
            logger.warning("in-flight staging failed at close: %s", e)
        for client in (self._event_queue, self._shm_lock,
                       self._persist_state):
            if client is not None:
                client.close()
        self._shm.close(unlink=unlink_shm)
