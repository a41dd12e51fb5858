"""Typed ``DLROVER_TPU_*`` environment flags: the port's own copy of the
part of dlrover_tpu/common/flags.py it reads.

The names are the JAX package's, so one exported variable flips both
packages. Semantics are kept: the environment is re-read on every
``get()``; an empty string is unset; a bool flag is ``raw != "0"``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One boolean environment flag."""

    name: str
    default: bool
    help: str = ""

    def get(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        return raw != "0"


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
