"""JobContainer: the per-job master state behind one root, as far as the
port's master has it (the part of dlrover_tpu/master/job_container.py that
holds the job context, the master config and the speed monitor).

The JAX container also owns the durable state store, the metrics registry
and the planner slot; those wait for their modules (ROADMAP.md). Each
master builds its own container and hands its slots to the objects it
wires, so two masters in one process share nothing.
"""

from __future__ import annotations

from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.node.job_context import JobContext


class JobContainer:
    """All mutable master state for one job."""

    def __init__(self):
        #: node registry + diagnosis action queue (master/node/job_context)
        self.job_context = JobContext()
        #: goodput ledger + step/straggler observation
        self.speed_monitor = SpeedMonitor()
        #: runtime-mutable master tunables; consumers hold this instance
        #: and re-read attributes per use
        self.config = MasterConfigContext()
