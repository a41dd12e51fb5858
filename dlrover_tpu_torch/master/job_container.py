"""JobContainer: the per-job master state behind one root, as far as the
port's master has it (the part of dlrover_tpu/master/job_container.py that
holds the job's uid and name, the job context, the master config, the
durable state store, the speed monitor and the goodput planner's slot).

The JAX container also owns the metrics registry, which waits for the
metric collector (ROADMAP 5b.3). Each master builds its own container and
hands its slots to the objects it wires, so two masters in one process
share nothing.
"""

from __future__ import annotations

from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.state_store import (
    MasterStateManager,
    MemoryStateBackend,
)


class JobContainer:
    """All mutable master state for one job, keyed by ``job_uid``."""

    def __init__(self, job_uid: str = "", job_name: str = "",
                 state_backend=None, clock=None):
        self.job_uid = job_uid
        self.job_name = job_name
        #: node registry + diagnosis action queue (master/node/job_context)
        self.job_context = JobContext()
        #: runtime-mutable master tunables; consumers hold this instance
        #: and re-read attributes per use
        self.config = MasterConfigContext()
        #: durable continuity state (shard queues, the speed ledger); the
        #: memory backend unless one is given
        self.state_manager = MasterStateManager(
            state_backend if state_backend is not None
            else MemoryStateBackend(),
            job_uid=job_uid,
        )
        #: goodput ledger + step/straggler observation (injectable clock)
        self.speed_monitor = SpeedMonitor(clock=clock)
        #: goodput planner slot: attached by the master when armed
        self.planner = None

    def attach_planner(self, planner) -> None:
        self.planner = planner
