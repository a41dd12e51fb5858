"""JobAutoScaler: the periodic optimize -> plan -> scale loop in the master.
The port's own copy of dlrover_tpu/master/node/job_auto_scaler.py.

It wires the speed monitor's observations into the ``LocalOptimizer`` and
executes the resulting plans through a ``Scaler``; it also handles OOM
recovery plans for failed nodes and pushes runtime hyperparameter
refinements as versioned parallel configs.

With a :class:`~dlrover_tpu_torch.brain.planner.GoodputPlanner` attached,
the periodic cycle runs the planner's goodput-ledger decision instead of
the legacy CPU/memory heuristics: an accepted plan still flows through the
same ResourcePlan → Scaler path, and the planner is told about the
execution so its cooldown window starts (and its growth gate opens).

One addition (ROADMAP's known differences): given the training
rendezvous (``rdzv_manager``), the auto-scaler bills an executed plan's
re-form. Once a round completes after the execution, it opens a downtime
bracket backdated to the fleet's last progress stamp (the last step the
old world reported), which the new world's first step report closes, so
the goodput ledger bills the resize and the planner's ``avg_downtime``
learns what one costs. The bracket is not opened at the execution itself:
the seated world keeps stepping until its agents see the waiter, and its
next step report would close it. The JAX local master bills no bracket
for a planned re-form (its k8s master bills pod events).

The whole decision path is clock-injected: ``sweep(now=)`` and
``optimize_once(now=)`` read only the injected clock, and a test pins that
no wall-clock read creeps in.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from dlrover_tpu_torch.brain import planner as planner_mod
from dlrover_tpu_torch.common.constants import NodeExitReason, NodeType
from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import ParallelConfig
from dlrover_tpu_torch.common.node import NodeGroupResource
from dlrover_tpu_torch.master.hyperparams import ModelProfile
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.resource.optimizer import (
    JobOptStage,
    LocalOptimizer,
    WorkerStats,
)
from dlrover_tpu_torch.master.resource.plan import ResourcePlan, ScalePlan


class JobAutoScaler:
    def __init__(
        self,
        optimizer: LocalOptimizer,
        scaler,
        speed_monitor=None,
        interval_secs: Optional[float] = None,
        sample_after_steps: Optional[int] = None,
        strategy_generator=None,
        metric_collector=None,
        refine_cooldown_secs: float = 300.0,
        planner=None,
        clock: Optional[Callable[[], float]] = None,
        job_context=None,
        config=None,
        rdzv_manager=None,
    ):
        self._optimizer = optimizer
        self._scaler = scaler
        self._speed_monitor = speed_monitor
        #: goodput planner (brain/planner.py): when set, optimize
        #: cycles decide from the goodput ledger instead of the legacy
        #: heuristics
        self._planner = planner
        #: injected "now": the only time source of the decision path
        #: (never read time.time() directly here: a test pins it)
        self._clock = clock or time.time
        # the per-job runtime-mutable config (JobContainer slot):
        # attributes re-read per cycle, so an operator's update retunes
        # the live loop; explicit ctor args still override
        self._config = (
            config if config is not None else MasterConfigContext()
        )
        self._interval_override = interval_secs
        self._sample_after_steps_override = sample_after_steps
        #: hyperparam refinement (master/hyperparams.py): model-aware
        #: batch growth from observed memory headroom
        self._strategy_generator = strategy_generator
        self._metric_collector = metric_collector
        self._refine_cooldown = refine_cooldown_secs
        self._last_refine_ts = 0.0
        self._job_context = (
            job_context if job_context is not None else JobContext()
        )
        self._cordoned_hot_hosts: set = set()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_ts = 0.0
        #: the training rendezvous, and its round when the last plan was
        #: executed (None: no re-form to bill; module docstring)
        self._rdzv = rdzv_manager
        self._resize_round: Optional[int] = None

    @property
    def _interval(self) -> float:
        if self._interval_override is not None:
            return self._interval_override
        return self._config.seconds_interval_to_optimize

    @property
    def _sample_after_steps(self) -> int:
        if self._sample_after_steps_override is not None:
            return self._sample_after_steps_override
        return self._config.sample_count_to_adjust_worker

    @property
    def _autoscale_enabled(self) -> bool:
        return self._config.auto_worker_enabled

    # -- lifecycle ---------------------------------------------------------

    def start_auto_scaling(self):
        self._started_ts = self._clock()
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="job-auto-scaler", daemon=True
        )
        self._thread.start()

    def stop_auto_scaling(self):
        self._stop_evt.set()

    def _loop(self):
        while not self._stop_evt.wait(self._interval):
            try:
                self.sweep()
            except Exception:
                logger.exception("auto-scale cycle failed")

    def sweep(self, now: Optional[float] = None) -> Optional[ScalePlan]:
        """One guarded cycle on the injected clock: the thread's body, and
        the local master's poll loop's (it calls this instead of running
        the thread)."""
        if not self._autoscale_enabled:
            return None
        now = self._clock() if now is None else now
        if self._started_ts == 0.0:
            self._started_ts = now
        warmup = self._config.seconds_to_autoscale_worker
        if now - self._started_ts < warmup:
            return None  # let rendezvous + first steps settle first
        return self.optimize_once(now=now)

    # -- one optimization cycle -------------------------------------------

    def _current_stage(self) -> str:
        step = (
            self._speed_monitor.completed_global_step
            if self._speed_monitor is not None
            else 0
        )
        if step <= 0:
            return JobOptStage.CREATE
        if step < self._sample_after_steps:
            return JobOptStage.SAMPLE
        return JobOptStage.RUNNING

    def _collect_stats(self) -> WorkerStats:
        workers = self._job_context.running_nodes(NodeType.WORKER)
        stats = WorkerStats(worker_num=len(workers))
        for node in workers:
            if node.used_resource.cpu:
                stats.cpu_percents.append(node.used_resource.cpu)
            if node.used_resource.memory_mb:
                stats.memory_mbs.append(node.used_resource.memory_mb)
        if self._speed_monitor is not None:
            stats.speed_steps_per_sec = self._speed_monitor.running_speed()
            self._optimizer.observe_speed(
                stats.worker_num, stats.speed_steps_per_sec
            )
            self._optimizer.set_restart_cost(
                self._speed_monitor.avg_downtime()
            )
        return stats

    def optimize_once(self, now: Optional[float] = None) -> ScalePlan:
        now = self._clock() if now is None else now
        if self._planner is not None:
            return self._planner_cycle(now)
        stats = self._collect_stats()
        stage = self._current_stage()
        plan = self._optimizer.generate_opt_plan(stage, stats)
        scale_plan = self.execute_job_optimization_plan(plan)
        if stage == JobOptStage.RUNNING:
            self.maybe_refine_hyperparams(now=now)
        return scale_plan

    def _planner_cycle(self, now: float) -> ScalePlan:
        """The goodput-planner decision path: throttled decide; an
        accepted RESIZE becomes a worker-count ResourcePlan executed
        through the normal scale path, and the planner is told so its
        cooldown window opens (at most one executed plan per window).
        HOLD decisions (instability, cooldown, hysteresis, no paying
        candidate) execute nothing."""
        self._bill_planned_reform()
        decision = self._planner.sweep(now=now)
        scale_plan = ScalePlan()
        if decision is None or decision["verdict"] != planner_mod.RESIZE:
            return scale_plan
        target = self._planner.intent()
        if target is None:
            return scale_plan
        plan = ResourcePlan(comment=f"planner:{decision['reason']}")
        plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
            count=target.world_size
        )
        scale_plan = self.execute_job_optimization_plan(plan)
        self._planner.note_executed(target, now=now)
        if self._rdzv is not None:
            self._resize_round = self._rdzv.get_rdzv_round()
        logger.info(
            "planner plan executed: workers -> %d (%s; payback %.0fs)",
            target.world_size, target.spec,
            decision.get("payback_s") or 0.0,
        )
        return scale_plan

    def _bill_planned_reform(self):
        """Open the downtime bracket of an executed plan's re-form once
        its round has completed, backdated to the last progress stamp
        (module docstring). A bracket already open is kept."""
        if self._resize_round is None or self._speed_monitor is None:
            return
        if self._rdzv.get_rdzv_round() == self._resize_round:
            return
        self._resize_round = None
        last = self._speed_monitor.last_progress_ts()
        if last > 0:
            self._speed_monitor.mark_downtime_start(ts=last)

    def maybe_refine_hyperparams(self, now: Optional[float] = None):
        """Runtime batch growth from observed memory headroom, with
        lr/weight-decay sqrt coupling (master/hyperparams.py); pushed to
        workers via the versioned paral-config channel. Its caller with a
        metric collector is the k8s master (ROADMAP 5b.3)."""
        now = self._clock() if now is None else now
        if self._strategy_generator is None or self._metric_collector is None:
            return
        if now - self._last_refine_ts < self._refine_cooldown:
            return
        profile_d = self._metric_collector.metrics.model_profile
        if not profile_d:
            return
        mp = ModelProfile(
            param_count=self._metric_collector.metrics.model_params,
            seq_len=int(profile_d.get("seq_len", 0)),
            hidden_dim=int(profile_d.get("hidden_dim", 0)),
            n_layers=int(profile_d.get("n_layers", 0)),
            n_heads=int(profile_d.get("n_heads", 0)),
            remat=bool(profile_d.get("remat", True)),
        )
        workers = [
            n for n in self._job_context.workers().values()
            if not n.is_released
        ]
        used = max(
            (n.used_resource.memory_mb for n in workers
             if n.used_resource.memory_mb), default=0.0,
        )
        total = min(
            (n.config_resource.memory_mb for n in workers
             if n.config_resource.memory_mb), default=0.0,
        )
        if used <= 0 or total <= 0:
            return
        current: dict = {}
        for node in workers:
            if node.paral_config:
                current = {
                    k: v for k, v in node.paral_config.items()
                    if k != "dataloader_version"
                }
                break
        if not current.get("dataloader_batch_size"):
            current["dataloader_batch_size"] = int(
                profile_d.get("batch_size", 0)
            )
        suggestion = self._strategy_generator.refine_strategy(
            current, mp, host_mem_used_mb=used, host_mem_total_mb=total
        )
        if suggestion is None:
            return
        self._last_refine_ts = now
        cfg = {**current, **suggestion.to_paral_config()}
        logger.info(
            "hyperparam refinement: batch %s->%s (headroom %.0fMB), "
            "lr->%g, accum->%s",
            current.get("dataloader_batch_size"),
            suggestion.micro_batch_size,
            total - used,
            suggestion.learning_rate,
            suggestion.grad_accum_steps,
        )
        self._push_paral_config(cfg)

    def execute_job_optimization_plan(self, plan: ResourcePlan) -> ScalePlan:
        scale_plan = ScalePlan()
        if plan is None or plan.empty() and not plan.paral_config:
            return scale_plan
        if plan.hot_hosts:
            self._cordon_hot_hosts(plan.hot_hosts)
        scale_plan.node_group_resources = dict(plan.node_group_resources)
        scale_plan.paral_config = dict(plan.paral_config)
        if plan.paral_config:
            self._push_paral_config(plan.paral_config)
        if not scale_plan.empty():
            self._scaler.scale(scale_plan)
        return scale_plan

    def _cordon_hot_hosts(self, hosts: list):
        """Brain-flagged contended hosts (cpu pegged, device duty
        lagging): cordon so relaunches and scale-ups land elsewhere."""
        for host in hosts:
            if host in self._cordoned_hot_hosts:
                continue
            try:
                self._scaler.cordon(host)
                self._cordoned_hot_hosts.add(host)
                logger.warning("cordoned hot host %s (brain hot-host guard)",
                               host)
            except Exception:
                logger.exception("cordon of hot host %s failed", host)

    def _push_paral_config(self, cfg: dict):
        filtered = ParallelConfig.filter_known(cfg)
        dropped = set(cfg) - set(filtered)
        if dropped:
            logger.warning("paral config keys without a wire field: %s", dropped)
        for node in self._job_context.workers().values():
            current = {
                k: v
                for k, v in node.paral_config.items()
                if k != "dataloader_version"
            }
            if current == filtered:
                continue  # no-op push: don't churn versions/files
            version = int(node.paral_config.get("dataloader_version", 0)) + 1
            node.paral_config = {**filtered, "dataloader_version": version}

    # -- failure hooks -----------------------------------------------------

    def handle_node_failure(self, node_type: str, node_id: int):
        """OOM-aware recovery: a device OOM halves the micro-batch (and
        doubles the accumulation), a host OOM doubles host memory. Its
        caller is the k8s master's node event callback (ROADMAP 5b.3)."""
        node = self._job_context.get_node(node_type, node_id)
        if node is None or node.exit_reason != NodeExitReason.OOM:
            return
        host_oom = "host" in (node.reported_status or "")
        plan = self._optimizer.generate_oom_recovery_plan(
            [node.name], self._current_stage(), host_oom=host_oom
        )
        logger.warning(
            "OOM recovery for %s-%s: %s", node_type, node_id,
            "host memory x2" if host_oom else "micro-batch/2 accum x2",
        )
        self.execute_job_optimization_plan(plan)
