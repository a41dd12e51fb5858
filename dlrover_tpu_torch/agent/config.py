"""Elastic launch configuration: the port's own copy of
dlrover_tpu/agent/config.py (``ElasticLaunchConfig``).

``accelerator`` is ``cuda`` (the default: workers form an NCCL world on
their local rank's card) or ``cpu`` (gloo, the test mode). ``tpu_timer``
loads the device timer into the workers (profiler/tpu_timer.py), each
local rank serving its metrics on ``tpu_timer_port + local_rank``. The
JAX config's comm-metrics, compile-cache and replica knobs wait for their
modules (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from dlrover_tpu_torch.common.constants import TpuTimerConsts

ACCELERATORS = ("cuda", "cpu")


@dataclass
class ElasticLaunchConfig:
    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1  # worker processes per host
    node_id: int = 0
    job_name: str = "dlrover-tpu-job"
    master_addr: str = ""

    max_restarts: int = 3
    monitor_interval: float = 2.0
    accelerator: str = "cuda"  # "cuda" | "cpu" (cpu = gloo test mode)
    tpu_timer: bool = False  # load the device timer into the workers
    tpu_timer_port: int = TpuTimerConsts.DEFAULT_PORT

    entrypoint: str = ""
    entrypoint_args: List[str] = field(default_factory=list)

    def auto_configure(self):
        """Check the configuration (the JAX config's name for the step
        that also reads the TPU topology hints, which no GPU platform
        sets: the wire's ``slice_name`` and ``coords`` stay empty)."""
        if self.accelerator not in ACCELERATORS:
            raise ValueError(f"accelerator {self.accelerator!r} is not one "
                             f"of {ACCELERATORS}")
        return self
