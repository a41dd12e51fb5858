"""Typed ``DLROVER_TPU_*`` environment flags: the port's own copy of the
part of dlrover_tpu/common/flags.py it reads.

The names and defaults are the JAX package's, so one exported variable
flips both packages. Semantics are kept: the environment is re-read on
every ``get()``; an empty string is unset; a bool flag is ``raw != "0"``;
a value that fails to parse logs one warning and gives the default. A
flag's type is its default's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One environment flag of the type of its default (bool, int, float
    or str)."""

    name: str
    default: Any
    help: str = ""

    def get(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        kind = type(self.default)
        if kind is bool:
            return raw != "0"
        if kind is str:
            return raw
        try:
            return kind(raw)
        except ValueError:
            logger.warning("%s=%r is not a valid %s; using default %r",
                           self.name, raw, kind.__name__, self.default)
            return self.default


CHUNKED_CE = EnvFlag(
    "DLROVER_TPU_CHUNKED_CE", True,
    "Chunked fused cross-entropy kill-switch: 0 restores the dense "
    "[B,T,V] logits path (ops/chunked_ce.py). Read at every loss call.",
)

FUSED_CE = EnvFlag(
    "DLROVER_TPU_FUSED_CE", True,
    "Fused lm-head cross-entropy kernels (ops/fused_ce.py): 0 takes the "
    "chunked cross-entropy instead. Read at every loss call.",
)

# -- flash checkpoint (checkpoint/engine.py, checkpoint/saver.py)

ASYNC_STAGING = EnvFlag(
    "DLROVER_TPU_ASYNC_STAGING", True,
    "Checkpoint staging kill-switch: 0 stages shm copies synchronously "
    "on the training thread (checkpoint/engine.py).",
)
DEVICE_SNAPSHOT = EnvFlag(
    "DLROVER_TPU_DEVICE_SNAPSHOT", True,
    "0 disables the on-device state snapshot before async staging "
    "(falls back to blocking for the device-to-host copy).",
)
DRAIN_TIMEOUT = EnvFlag(
    "DLROVER_TPU_DRAIN_TIMEOUT", 20.0,
    "Seconds to wait for in-flight checkpoint staging at teardown; "
    "pair with the pod's terminationGracePeriodSeconds.",
)
CKPT_DEDUP = EnvFlag(
    "DLROVER_TPU_CKPT_DEDUP", True,
    "Replica-deduplicated checkpoint staging kill-switch "
    "(checkpoint/ownership.py): 0 stages one full copy per process.",
)
CKPT_LOCAL_DIR = EnvFlag(
    "DLROVER_TPU_CKPT_LOCAL_DIR", "",
    "Root of the node-local disk checkpoint tier (tier 1; a node-local "
    "SSD). Empty: <ckpt_dir>/_local. Each node writes under "
    "<root>/node-<id>.",
)
CKPT_PERSIST_WORKERS = EnvFlag(
    "DLROVER_TPU_CKPT_PERSIST_WORKERS", 4,
    "Concurrent leaf-file writers in the persist pool (local-tier "
    "writes and object-tier fanout run this many files in parallel).",
)
CKPT_REPLICA = EnvFlag(
    "DLROVER_TPU_CKPT_REPLICA", "",
    "Agent-set replica mode: exactly '1' streams staged checkpoints "
    "to the backup peer (checkpoint/replica.py).",
)
REPLICA_MAX_BYTES = EnvFlag(
    "DLROVER_TPU_REPLICA_MAX_BYTES", 64 << 30,
    "Replica server per-payload size bound (memory-DoS refusal).",
)

# -- agent wiring (NodeEnv names; injected by the agent/launcher)

NODE_ID = EnvFlag(
    NodeEnv.NODE_ID, 0,
    "This worker's node id (agent-injected).",
)
PROCESS_ID = EnvFlag(
    NodeEnv.PROCESS_ID, 0,
    "This worker's process index within its node (agent-injected).",
)
JOB_NAME = EnvFlag(
    NodeEnv.JOB_NAME, "local",
    "Job name: keys the shm segments.",
)
