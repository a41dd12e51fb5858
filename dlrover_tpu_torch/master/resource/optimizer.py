"""Resource optimizers: generate ResourcePlans per job stage. The port's own
copy of dlrover_tpu/master/resource/optimizer.py (its ``LocalOptimizer``;
the brain service's ``brain_optimizer.py`` waits for the brain, ROADMAP
item 15).

- CREATE: no runtime stats yet -> start from configured counts, rounded
  to ``node_unit``.
- SAMPLE: early steps observed -> right-size host CPU/memory from usage.
- RUNNING: steady state -> scale the node count toward the speed knee;
  the cards a node drives are fixed, so throughput scaling moves whole
  nodes.

OOM recovery: a device OOM cannot be fixed by a bigger host, so the plan
halves the micro-batch through the runtime-mutable parallel config (and
doubles grad-accum to keep the global batch), while a host-RAM OOM
doubles host memory. With the goodput planner armed the auto-scaler's
periodic cycle takes the planner's decision instead of these heuristics;
the OOM path stays.
"""

from __future__ import annotations

import statistics
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.resource.plan import ResourcePlan


class OptimizeMode:
    SINGLE_JOB = "single-job"  # local heuristics
    CLUSTER = "cluster"  # brain service


class JobOptStage:
    CREATE = "job_stage_create"
    SAMPLE = "job_stage_sample"
    RUNNING = "job_stage_running"


@dataclass
class WorkerStats:
    """Runtime observations the optimizer consumes."""

    cpu_percents: List[float] = field(default_factory=list)
    memory_mbs: List[float] = field(default_factory=list)
    duty_cycles: List[float] = field(default_factory=list)  # device busy fraction
    speed_steps_per_sec: float = 0.0
    worker_num: int = 0


class ResourceOptimizer(ABC):
    def set_restart_cost(self, seconds: float) -> None:
        """Observed average downtime one restart costs this job (scale-up
        forces one); optimizers may gate growth on it. Default: ignored."""

    @abstractmethod
    def generate_opt_plan(self, stage: str, stats: WorkerStats) -> ResourcePlan:
        ...

    @abstractmethod
    def generate_oom_recovery_plan(
        self, node_names: List[str], stage: str, host_oom: bool
    ) -> ResourcePlan:
        ...


class LocalOptimizer(ResourceOptimizer):
    """Single-job heuristics, no external service.

    ``speed_history`` keeps (worker_num, steps/sec) observations so the
    RUNNING stage can estimate the marginal speedup of adding nodes.
    """

    def __init__(
        self,
        min_workers: int = 1,
        max_workers: int = 0,
        node_unit: int = 1,
        host_memory_mb: float = 0.0,
    ):
        self._min_workers = max(1, min_workers)
        self._max_workers = max_workers or self._min_workers
        self._node_unit = max(1, node_unit)
        self._host_memory_mb = host_memory_mb
        self._speed_history: List[Tuple[int, float]] = []

    # -- observations ------------------------------------------------------

    def observe_speed(self, worker_num: int, steps_per_sec: float):
        if worker_num > 0 and steps_per_sec > 0:
            self._speed_history.append((worker_num, steps_per_sec))
            if len(self._speed_history) > 64:
                self._speed_history.pop(0)

    # -- plan generation ---------------------------------------------------

    def generate_opt_plan(self, stage: str, stats: WorkerStats) -> ResourcePlan:
        if stage == JobOptStage.CREATE:
            return self._create_plan()
        if stage == JobOptStage.SAMPLE:
            return self._sample_plan(stats)
        return self._running_plan(stats)

    def _round_to_unit(self, n: int) -> int:
        unit = self._node_unit
        n = max(self._min_workers, min(n, self._max_workers))
        return max(unit, (n // unit) * unit)

    def _create_plan(self) -> ResourcePlan:
        plan = ResourcePlan(comment=JobOptStage.CREATE)
        plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
            count=self._round_to_unit(self._max_workers)
        )
        return plan

    def _sample_plan(self, stats: WorkerStats) -> ResourcePlan:
        """Right-size host CPU/memory from early samples (x1.5 headroom)."""
        plan = ResourcePlan(comment=JobOptStage.SAMPLE)
        if not stats.memory_mbs:
            return plan
        mem = max(stats.memory_mbs) * 1.5
        cpu = max(stats.cpu_percents or [0.0]) / 100.0 * 1.5
        plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
            count=stats.worker_num or self._max_workers,
            node_resource=NodeResource(cpu=cpu, memory_mb=mem),
        )
        return plan

    def _running_plan(self, stats: WorkerStats) -> ResourcePlan:
        """Scale the node count toward the throughput knee.

        Fits marginal speedup from history: if doubling workers gave
        <30% speedup, scaling further wastes chips -> shrink to the knee;
        if near-linear (>70%), grow toward max_workers.
        """
        plan = ResourcePlan(comment=JobOptStage.RUNNING)
        if len(self._speed_history) < 2 or stats.worker_num <= 0:
            return plan
        by_n: Dict[int, List[float]] = {}
        for n, s in self._speed_history:
            by_n.setdefault(n, []).append(s)
        sizes = sorted(by_n)
        if len(sizes) < 2:
            # only one world size observed: grow if below max and busy
            busy = statistics.mean(stats.duty_cycles) if stats.duty_cycles else 1.0
            if stats.worker_num < self._max_workers and busy > 0.5:
                plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
                    count=self._round_to_unit(stats.worker_num + self._node_unit)
                )
            return plan
        # compare the two largest observed world sizes
        n1, n2 = sizes[-2], sizes[-1]
        s1 = statistics.median(by_n[n1])
        s2 = statistics.median(by_n[n2])
        if n2 == n1 or s1 <= 0:
            return plan
        marginal = (s2 / s1 - 1.0) / (n2 / n1 - 1.0)  # 1.0 = linear scaling
        if marginal < 0.3 and n1 >= self._min_workers:
            plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
                count=self._round_to_unit(n1)
            )
            plan.comment += ":shrink_to_knee"
        elif marginal > 0.7 and n2 < self._max_workers:
            plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
                count=self._round_to_unit(n2 + self._node_unit)
            )
            plan.comment += ":grow"
        return plan

    # -- OOM recovery ------------------------------------------------------

    def generate_oom_recovery_plan(
        self, node_names: List[str], stage: str, host_oom: bool = False
    ) -> ResourcePlan:
        plan = ResourcePlan(comment="oom_recovery")
        if host_oom:
            # host-RAM OOM: double configured memory
            mem = (self._host_memory_mb or 8192) * 2
            self._host_memory_mb = mem
            for name in node_names:
                plan.node_resources[name] = NodeResource(memory_mb=mem)
        else:
            # device OOM: halve micro-batch, double grad-accum (global
            # batch kept)
            plan.paral_config = {
                "micro_batch_scale": 0.5,
                "grad_accum_scale": 2.0,
                "restart": True,
            }
        return plan
