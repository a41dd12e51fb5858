"""Worker-side elastic data plumbing: the port's own copy of
dlrover_tpu/train/data.py.

- ``ShardingClient``: dynamic shard consumption from the master, chief-
  driven. Process 0 leases shard ranges (``lease_shards``: a batch of
  shards a call, the previous batch's completions riding the same call)
  and broadcasts each task to every process, so all ranks of a
  data-parallel world train the same shard in lockstep.
- ``ElasticDistributedSampler`` and ``ElasticDataLoader``: deterministic
  sample order (``numpy.random.RandomState(seed + epoch)``) with a
  mid-epoch resume position, the loader's batch size tunable through the
  parallel-config file.
- ``prefetch_to_device``: keeps ``size`` batches in flight on the card
  (pinned host memory, a copy on a side stream the compute stream waits
  on, ``record_stream``).

Where the JAX module reads ``jax.process_count()`` and
``jax.process_index()``, this one reads the default process group's world
size and rank (``train/bootstrap.py``), 1 and 0 without a group; its
broadcast runs on the device the group's backend takes (the card for NCCL,
the CPU for gloo).
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.agent.paral_config_tuner import read_paral_config
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    DatasetShardParams,
    ShardLeaseResponse,
    Task,
)
from dlrover_tpu_torch.rpc import policy as rpc_policy
from dlrover_tpu_torch.train import bootstrap


def _broadcast_tuple(values: Tuple[int, ...], is_source: bool) -> Tuple[int, ...]:
    """Broadcast small ints from process 0 to all (no-op single process)."""
    if bootstrap.process_count() == 1:
        return values
    import torch
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.int64,
                     device=bootstrap.collective_device())
    dist.broadcast(t, src=0)
    return tuple(int(v) for v in t.tolist())


class ShardingClient:
    """Lockstep-safe dynamic shard consumption for data-parallel workers.

    The chief's master traffic runs the batched lease protocol by
    default: ``lease_shards`` prefetches
    ``lease_count`` shards under one per-worker lease per RPC and the
    SAME call acks the previous batch's completions, so the data plane
    costs ~1/(2·lease_count) of the per-task ``get_task``+``report``
    protocol at fleet scale. The lease renews via the agent's folded
    WorkerReport (zero extra steady-state RPCs); if this worker dies,
    lease expiry re-enqueues its undone shards at-least-once and the
    fence keeps its zombie reports from double-counting.
    ``lease_count=0`` (or an old master that does not know the RPC)
    falls back to the legacy one-task-per-RPC path."""

    def __init__(
        self,
        dataset_name: str,
        master_client=None,
        lease_count: Optional[int] = None,
    ):
        self.dataset_name = dataset_name
        self._client = master_client
        self._is_chief = bootstrap.process_index() == 0
        self._current_task: Optional[Task] = None
        self._lease_count = int(
            lease_count if lease_count is not None
            else flags.SHARD_LEASE_COUNT.get()
        )
        self._lease_supported = True
        self._lease_epoch = -1
        self._prefetched: List[Task] = []
        self._done_ids: List[int] = []

    def register_dataset(
        self,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "text",
    ):
        if self._is_chief and self._client is not None:
            self._client.report_dataset_shard_params(
                DatasetShardParams(
                    dataset_name=self.dataset_name,
                    dataset_size=dataset_size,
                    shard_size=shard_size,
                    num_epochs=num_epochs,
                    shuffle=shuffle,
                    storage_type=storage_type,
                )
            )

    # -- leased prefetch (chief only) ---------------------------------------

    def _lease(self, count: int,
               failed_ids=()) -> Optional[ShardLeaseResponse]:
        """One lease RPC: pending completions + up to ``count`` fresh
        shards. Returns None when the master predates the protocol
        (the caller falls back to per-task dispatch)."""
        done, self._done_ids = self._done_ids, []
        try:
            resp = self._client.lease_shards(
                self.dataset_name,
                count,
                done_ids=done,
                failed_ids=list(failed_ids),
                lease_epoch=self._lease_epoch,
            )
        except Exception:
            # the RPC (and its whole retry budget) failed: the
            # completions are NOT lost — they ride the next call.
            # Dropping them would leave the shards in the master's
            # doing set until lease expiry and force an avoidable
            # re-delivery of up to a full batch.
            self._done_ids = done + self._done_ids
            raise
        if not isinstance(resp, ShardLeaseResponse):
            # version skew: an old master answers the unknown message
            # with a SimpleResponse — switch to the legacy protocol and
            # re-report the completions through it
            logger.warning(
                "master does not support lease_shards; falling back to "
                "per-task shard dispatch"
            )
            self._lease_supported = False
            for tid in done:
                self._client.report_task_result(self.dataset_name, tid, True)
            for tid in failed_ids:
                self._client.report_task_result(self.dataset_name, tid, False)
            return None
        # done ids the master did NOT ack were fenced off (this lease
        # expired and the shards were re-issued): drop them — the new
        # holder's completion is the one that counts
        if resp.lease_epoch >= 0:
            self._lease_epoch = resp.lease_epoch
        return resp

    def _fetch_leased(self) -> Task:
        """Pop the next prefetched shard, leasing the next batch when
        the queue runs dry. An IDLE grant (todo drained but shards
        still in flight on other workers) is NOT end-of-data: a death
        elsewhere will re-enqueue them, and ending the epoch here
        would silently lose those records — the chief polls (jittered,
        growing) until the master says ``exhausted``. Each poll also
        flushes any pending completions, so the final batch's acks
        never strand."""
        if self._prefetched:
            return self._prefetched.pop(0)
        delays = None
        while True:
            resp = self._lease(self._lease_count)
            if resp is None:
                return self._client.get_task(self.dataset_name)
            self._prefetched.extend(resp.tasks)
            if self._prefetched:
                return self._prefetched.pop(0)
            if resp.exhausted and not self._done_ids:
                return Task()  # epoch truly complete, everything acked
            if resp.exhausted:
                continue  # one more call flushes the final completions
            # idle: wait for a re-enqueue (or completion) elsewhere
            if delays is None:
                delays = rpc_policy.poll_intervals()
            time.sleep(next(delays))

    def fetch_task(self) -> Optional[Task]:
        """Chief fetches; everyone receives the same task (or None at end)."""
        task_tuple: Tuple[int, ...]
        if self._is_chief:
            if self._client is None:
                task = Task()
            elif self._lease_count > 0 and self._lease_supported:
                task = self._fetch_leased()
            else:
                task = self._client.get_task(self.dataset_name)
            task_tuple = (
                task.task_id,
                task.shard_start,
                task.shard_end,
                task.epoch,
            )
        else:
            task_tuple = (-1, 0, 0, 0)
        task_tuple = _broadcast_tuple(task_tuple, is_source=self._is_chief)
        task_id, start, end, epoch = task_tuple
        if task_id < 0:
            self._current_task = None
            return None
        self._current_task = Task(
            task_id=task_id,
            dataset_name=self.dataset_name,
            shard_start=start,
            shard_end=end,
            epoch=epoch,
        )
        return self._current_task

    def report_task_done(self, success: bool = True):
        if (
            self._is_chief
            and self._client is not None
            and self._current_task is not None
        ):
            if self._lease_count > 0 and self._lease_supported:
                if success:
                    # completions batch up and ride the NEXT lease call
                    self._done_ids.append(self._current_task.task_id)
                else:
                    # failures flush immediately so the master requeues
                    # the shard for someone else without waiting a TTL
                    self._lease(0, failed_ids=[self._current_task.task_id])
            else:
                self._client.report_task_result(
                    self.dataset_name, self._current_task.task_id, success
                )
        self._current_task = None

    def iter_tasks(self) -> Iterator[Task]:
        while True:
            task = self.fetch_task()
            if task is None:
                return
            yield task
            self.report_task_done()

    # -- shard checkpoint (mid-epoch resume) --------------------------------

    def checkpoint_shards(self) -> str:
        if self._is_chief and self._client is not None:
            if self._done_ids and self._lease_supported:
                # the shard checkpoint must reflect everything consumed
                self._lease(0)
            return self._client.get_shard_checkpoint(self.dataset_name)
        return ""

    def restore_shards(self, content: str):
        if self._is_chief and self._client is not None and content:
            self._client.report_shard_checkpoint(self.dataset_name, content)


@dataclass
class SamplerState:
    epoch: int = 0
    completed_samples: int = 0


class ElasticDistributedSampler:
    """Deterministic per-process sample indices with mid-epoch resume.

    ``state_dict/load_state_dict`` carry the completed-sample offset so a
    restarted (possibly resized) world resumes where it left off.
    """

    def __init__(
        self,
        dataset_size: int,
        batch_size: int,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset_size = dataset_size
        self.batch_size = batch_size  # per-replica batch
        self.num_replicas = (
            num_replicas if num_replicas is not None
            else bootstrap.process_count()
        )
        self.rank = rank if rank is not None else bootstrap.process_index()
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.state = SamplerState()

    def _global_order(self) -> np.ndarray:
        order = np.arange(self.dataset_size)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.state.epoch)
            rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator[List[int]]:
        order = self._global_order()
        global_batch = self.batch_size * self.num_replicas
        start = self.state.completed_samples
        for gstart in range(start, self.dataset_size, global_batch):
            gbatch = order[gstart : gstart + global_batch]
            if len(gbatch) < global_batch and self.drop_last:
                break
            local = gbatch[self.rank :: self.num_replicas][: self.batch_size]
            self.state.completed_samples = min(
                gstart + global_batch, self.dataset_size
            )
            yield local.tolist()
        # Epoch exhausted (including a drop_last partial tail): advance.
        self.state.epoch += 1
        self.state.completed_samples = 0

    def state_dict(self) -> dict:
        return {
            "epoch": self.state.epoch,
            "completed_samples": self.state.completed_samples,
        }

    def load_state_dict(self, state: dict):
        self.state.epoch = int(state.get("epoch", 0))
        completed = int(state.get("completed_samples", 0))
        # Align to the *new* global batch so a resized world resumes cleanly.
        global_batch = self.batch_size * self.num_replicas
        self.state.completed_samples = (completed // global_batch) * global_batch


class ElasticDataLoader:
    """Batches from an indexable dataset with runtime-tunable batch size.

    As in the JAX loader, the batch size reloads from the ParalConfigTuner JSON the agent maintains,
    so a master-pushed ``dataloader_batch_size`` (e.g. the brain's HBM-OOM
    micro-batch adjustment) takes effect at the next batch without code
    changes in the training loop. ``collate`` turns a list of samples into
    the yielded batch (default: numpy stack).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        collate=None,
        config_path: str = "",
        sampler: Optional[ElasticDistributedSampler] = None,
    ):
        self.dataset = dataset
        self._base_batch_size = batch_size
        self._config_path = config_path
        self._config_version = -1
        self._collate = collate or _default_collate
        self.sampler = sampler or ElasticDistributedSampler(
            dataset_size=len(dataset),
            batch_size=batch_size,
            shuffle=shuffle,
            seed=seed,
            drop_last=drop_last,
        )

    @property
    def batch_size(self) -> int:
        return self.sampler.batch_size

    def update_batch_size_from_config(self) -> bool:
        """Apply the tuner config; returns True when the size changed.

        Lockstep-safe: process 0 reads its node's file and BROADCASTS
        (version, size) so every process applies the identical change —
        per-node tuner files update on independent poll schedules, and a
        mismatched micro-batch across data-parallel ranks hangs the
        gradient reduction.
        Called only between epochs: the sampler's iterator captures the
        global batch at epoch start, so a mid-epoch change would skip or
        duplicate samples.
        """
        version, new_size = self._config_version, self.sampler.batch_size
        config = read_paral_config(self._config_path)
        if config:
            version = int(config.get("dataloader_version", 0))
            new_size = int(config.get("dataloader_batch_size", 0))
            if new_size <= 0:
                # relative adjustment (HBM-OOM recovery halves micro-batch)
                scale = float(config.get("micro_batch_scale", 1.0) or 1.0)
                new_size = max(1, int(self._base_batch_size * scale))
        version, new_size = _broadcast_tuple(
            (version, new_size), is_source=bootstrap.process_index() == 0
        )
        if version == self._config_version:
            return False
        self._config_version = version
        if new_size == self.sampler.batch_size or new_size <= 0:
            return False
        logger.info(
            "elastic dataloader: batch size %s -> %s (config v%s)",
            self.sampler.batch_size,
            new_size,
            version,
        )
        self.sampler.batch_size = new_size
        return True

    def __iter__(self):
        # the JAX loader opens a py_tracer span around each fetch and
        # collate; it waits for the tracing slice (ROADMAP item 13)
        self.update_batch_size_from_config()
        for indices in self.sampler:
            yield self._collate([self.dataset[i] for i in indices])
        # next epoch may pick up a new config (never mid-epoch)

    def state_dict(self) -> dict:
        return self.sampler.state_dict()

    def load_state_dict(self, state: dict):
        self.sampler.load_state_dict(state)


def _default_collate(samples):
    if isinstance(samples[0], (tuple, list)):
        return tuple(
            np.stack([s[i] for s in samples])
            for i in range(len(samples[0]))
        )
    if isinstance(samples[0], dict):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return np.stack(samples)


def _map_leaves(fn, batch):
    """``fn`` over every array of a batch tree (an array, a tuple or list,
    or a dict of them)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_leaves(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_leaves(fn, v) for k, v in batch.items()}
    return fn(batch)


def prefetch_to_device(iterator, size: int = 2, device="cuda",
                       rows: Optional[slice] = None):
    """Overlap host-to-device transfer with compute by keeping ``size``
    batches in flight on the device.

    Each host batch (a numpy array or tensor, or a tuple, list or dict of
    them) is placed on ``device``. On a card, each leaf is copied into
    pinned host memory (a ``non_blocking`` copy from pageable memory runs
    synchronously) and from there to the card on a side stream; the
    compute stream waits on that copy's event before the batch is yielded,
    and ``record_stream`` ties the batch's memory to the compute stream so
    the caching allocator cannot hand it to a later copy while a step still
    reads it. On the CPU, placement is the identity. As in the JAX version,
    ``size=0`` still places each batch; only the overlap is dropped.

    ``rows`` selects the rows of each leaf's second axis this process
    places (``ElasticTrainer.rows``): every process holds the identical
    global batch and copies only its own rows, the counterpart of the JAX
    version's replicated mode.

    The returned generator is one-shot (it follows the wrapped iterator):
    re-wrap per epoch.
    """
    import torch

    device = torch.device(device)
    # accept iterables (ElasticDataLoader defines only __iter__): without
    # this, each islice would restart iteration from batch 0
    iterator = iter(iterator)
    side = compute = None
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)

    def host(leaf):
        if rows is not None:
            leaf = leaf[:, rows]
        if isinstance(leaf, torch.Tensor):
            return leaf.contiguous()
        return torch.from_numpy(np.ascontiguousarray(leaf))

    def put(batch):
        if side is None:
            return _map_leaves(lambda leaf: host(leaf).to(device), batch), None
        staged = _map_leaves(lambda leaf: host(leaf).pin_memory(), batch)
        with torch.cuda.stream(side):
            out = _map_leaves(
                lambda leaf: leaf.to(device, non_blocking=True), staged)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(placed):
        out, done = placed
        if done is not None:
            compute.wait_event(done)
            _map_leaves(lambda t: t.record_stream(compute), out)
        return out

    if size <= 0:
        # no overlap, but placement is still honored
        for data in iterator:
            yield ready(put(data))
        return

    queue = collections.deque()

    def enqueue(n):
        for data in itertools.islice(iterator, n):
            queue.append(put(data))

    enqueue(size)
    while queue:
        out = ready(queue.popleft())
        enqueue(1)
        yield out
