"""Dataset splitters: a shard is a record-index range. The port's own copy
of dlrover_tpu/master/shard/dataset_splitter.py: the text, table (with
huge-dataset sub-epochs) and streaming splitters and the factory, with the
same seeded shard order (``random.Random(seed + epoch)``), so both packages'
masters hand out the same shards in the same order.
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional

from dlrover_tpu_torch.common.log import logger

_MAX_SHARDS_PER_EPOCH = 50_000_000


@dataclass
class Shard:
    """A unit of data: records [start, end) of ``name``.

    ``record_indices`` carries the shuffled sample indices when per-record
    shuffle is on (reference keeps the same field).
    """

    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = field(default_factory=list)


class PartitionOffsets:
    """Unbounded streaming partitions: partition -> consumed offset."""

    def __init__(self, partition_offsets: dict):
        self.partition_offsets = dict(partition_offsets)

    def partitions(self):
        return list(self.partition_offsets)


class DatasetSplitter(ABC):
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int, num_epochs: int):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self._num_epochs = num_epochs
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> bool:
        """Populate the next epoch's shards; False if no epochs remain."""

    @abstractmethod
    def get_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self._num_epochs

    #: what ``epoch`` counts for this splitter (checkpoint unit tag)
    EPOCH_UNIT = "pass"
    #: sub-units per data pass the writer used (1 for pass-counting)
    EPOCH_FACTOR = 1

    def restore_epoch(self, epoch: int, unit: str = "pass", factor: int = 1):
        """Adopt a checkpointed epoch counter, converting between units.
        A sub-epoch-counted checkpoint converts to completed passes
        (rounding DOWN: the partial pass re-reads — at-least-once, never
        silently skipped)."""
        if unit == "subepoch":
            epoch = int(epoch) // max(1, int(factor))
        self.epoch = int(epoch)


class TextDatasetSplitter(DatasetSplitter):
    """Shards by record line-number ranges, with optional shuffle.

    Reference: ``TextDatasetSplitter`` :257 (record-level shuffle inside
    shards) — here shard-order shuffle plus optional per-record indices.
    """

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._seed = seed
        self._shards: List[Shard] = []

    def create_shards(self) -> bool:
        if self.epoch_finished():
            return False
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(name=self.dataset_name, start=start, end=end))
        if self._shuffle:
            rng = random.Random(self._seed + self.epoch)
            rng.shuffle(shards)
        self._shards = shards
        self.epoch += 1
        logger.info(
            "dataset %s: epoch %s with %s shards",
            self.dataset_name,
            self.epoch,
            len(shards),
        )
        return True

    def get_shards(self) -> List[Shard]:
        return list(self._shards)


class TableDatasetSplitter(DatasetSplitter):
    """Row-range splitter for table storage (Hive/BigQuery-style) with
    huge-dataset sub-epochs.

    Reference ``TableDatasetSplitter`` :144: when a table has more shards
    than ``max_shard_count``, each logical epoch is split into sub-epochs
    and ``create_shards`` materializes only one sub-epoch's shard objects
    — a trillion-row table never holds its whole shard list in master
    memory. ``epoch`` counts sub-epochs (the unit the task manager
    checkpoints/restores)."""

    def __init__(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        max_shard_count: int = 100_000,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._seed = seed
        self._max_shard_count = max(1, max_shard_count)
        shard_count = -(-dataset_size // max(1, shard_size))
        self._subepochs = max(1, -(-shard_count // self._max_shard_count))
        # epoch_finished() compares against sub-epoch counts
        self._num_epochs = num_epochs * self._subepochs
        self._shards: List[Shard] = []
        if self._subepochs > 1:
            logger.info(
                "table dataset %s: %s shards split into %s sub-epochs "
                "of <=%s shards",
                dataset_name, shard_count, self._subepochs,
                self._max_shard_count,
            )

    EPOCH_UNIT = "subepoch"

    @property
    def EPOCH_FACTOR(self) -> int:  # noqa: N802 — checkpoint metadata tag
        return self._subepochs

    def restore_epoch(self, epoch: int, unit: str = "pass", factor: int = 1):
        """Unit/factor-aware adoption: pass-counted checkpoints multiply
        into sub-epochs; sub-epoch checkpoints written under a DIFFERENT
        factor (table grew, max_shard_count changed) convert through
        completed passes, rounding DOWN so the partial pass re-reads
        (at-least-once) instead of being skipped."""
        epoch = int(epoch)
        if unit != self.EPOCH_UNIT:
            epoch = epoch * self._subepochs
        elif int(factor) != self._subepochs:
            epoch = (epoch // max(1, int(factor))) * self._subepochs
        self.epoch = epoch

    def create_shards(self) -> bool:
        if self.epoch_finished():
            return False
        sub = self.epoch % self._subepochs
        rows_per_sub = self._max_shard_count * self.shard_size
        base = sub * rows_per_sub
        stop = min(self.dataset_size, base + rows_per_sub)
        shards = [
            Shard(name=self.dataset_name, start=s,
                  end=min(s + self.shard_size, stop))
            for s in range(base, stop, self.shard_size)
        ]
        if self._shuffle:
            rng = random.Random(self._seed + self.epoch)
            rng.shuffle(shards)
        self._shards = shards
        self.epoch += 1
        return True

    def get_shards(self) -> List[Shard]:
        return list(self._shards)


class StreamingDatasetSplitter(DatasetSplitter):
    """Splits unbounded streams by (partition, offset range).

    Reference: ``StreamingDatasetSplitter`` :359. Each call to
    ``create_shards`` emits up to ``max_shard_count`` new shards advancing
    the per-partition offsets by ``shard_size``.
    """

    def __init__(
        self,
        dataset_name: str,
        shard_size: int,
        partition_offsets: PartitionOffsets,
        dataset_size: int = -1,
        max_shard_count: int = 1024,
    ):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs=1)
        self._offsets = partition_offsets
        self._max_shard_count = max_shard_count
        self._shards: List[Shard] = []

    def create_shards(self) -> bool:
        shards = []
        count = 0
        for partition in self._offsets.partitions():
            if count >= self._max_shard_count:
                break
            offset = self._offsets.partition_offsets[partition]
            start, end = offset, offset + self.shard_size
            shards.append(Shard(name=str(partition), start=start, end=end))
            self._offsets.partition_offsets[partition] = end
            count += 1
        self._shards = shards
        return bool(shards)

    def get_shards(self) -> List[Shard]:
        return list(self._shards)

    def epoch_finished(self) -> bool:
        return False

    @property
    def offsets(self) -> dict:
        """Current consumed offset per partition (checkpoint surface)."""
        return dict(self._offsets.partition_offsets)

    def reset_offsets(self, offsets: dict):
        """Restore consumed offsets (checkpoint restore)."""
        self._offsets = PartitionOffsets(offsets)
        self._shards = []


def new_dataset_splitter(
    splitter_type: str,
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    partition_offsets: Optional[dict] = None,
) -> DatasetSplitter:
    if splitter_type in ("text", ""):
        return TextDatasetSplitter(dataset_name, dataset_size, shard_size, num_epochs, shuffle)
    if splitter_type == "table":
        return TableDatasetSplitter(dataset_name, dataset_size, shard_size, num_epochs, shuffle)
    if splitter_type == "streaming":
        return StreamingDatasetSplitter(
            dataset_name, shard_size, PartitionOffsets(partition_offsets or {})
        )
    raise ValueError(f"unknown splitter type: {splitter_type}")
