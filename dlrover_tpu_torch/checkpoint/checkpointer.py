"""User-facing flash-checkpoint facade (port of
dlrover_tpu/checkpoint/checkpointer.py).

Usage::

    ckpt = Checkpointer("/nfs/job/ckpt")
    ckpt.save(step, state)                      # memory snapshot
    ckpt.save(step, state, StorageType.DISK)    # + persist
    restored = ckpt.load(target=state)          # shm, else disk, else object

The JAX facade falls back to an Orbax checkpoint in the same directory when
nothing of its own is there; the port's counterpart, interop with
``torch.distributed.checkpoint``, is a later slice (ROADMAP.md).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional, Tuple

from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common.log import logger


class StorageType(enum.Enum):
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    def __init__(
        self,
        ckpt_dir: str,
        storage=None,
        save_storage_interval: int = 0,
        async_staging: Optional[bool] = None,
    ):
        """``save_storage_interval > 0`` upgrades every Nth memory save to
        a disk persist, so callers can save to memory every step and still
        get periodic durability."""
        self._engine = CheckpointEngine(
            ckpt_dir, storage=storage, async_staging=async_staging
        )
        self._save_storage_interval = max(0, save_storage_interval)
        self.last_blocking_s = 0.0

    def save(
        self,
        step: int,
        state: Any,
        storage_type: StorageType = StorageType.MEMORY,
    ) -> float:
        """Returns the blocking seconds (the training pause)."""
        if (
            storage_type == StorageType.MEMORY
            and self._save_storage_interval > 0
            and step % self._save_storage_interval == 0
        ):
            storage_type = StorageType.DISK
        if storage_type == StorageType.DISK:
            blocking = self._engine.save_to_storage(step, state)
        else:
            blocking = self._engine.save_to_memory(step, state)
        self.last_blocking_s = blocking
        logger.info("flash ckpt save step=%s type=%s blocking=%.3fs",
                    step, storage_type.value, blocking)
        return blocking

    def load(self, target: Any = None) -> Optional[Tuple[int, Any]]:
        """(step, state) from shm if staged for this directory, else the
        newest committed step from disk; None if nothing exists. With a
        target, its tensors are overwritten in place."""
        return self._engine.load(target)

    @property
    def last_restore_stats(self) -> Dict[str, Any]:
        """How the last targeted restore went, ``tier`` (shm | disk |
        object) included."""
        return self._engine.last_restore_stats

    @property
    def last_stage_mode(self) -> str:
        """How the last save staged: "device_snapshot", "host_gather" or
        "sync"."""
        return self._engine.last_stage_mode

    @property
    def stage_log(self):
        """Stats of the most recent completed stages, oldest first."""
        return self._engine.stage_log

    def wait_staging(self, timeout: Optional[float] = None):
        """Join any in-flight background stage (and its inline persist);
        re-raises a staging failure."""
        self._engine.wait_staging(timeout)

    def committed_step(self) -> int:
        return self._engine.committed_step()

    def close(self, unlink_shm: bool = False):
        self._engine.close(unlink_shm=unlink_shm)
