"""Single-process job master for ``--standalone`` runs and tests: the port's
own copy of dlrover_tpu/master/local_master.py.

It wires the servicer, the training and network-check rendezvous managers,
the KV store, the sync service, the speed monitor (goodput, downtime and
stragglers, handed to the servicer, the job manager and the task manager
as the JAX master hands it), the data-sharding task manager, the local job
manager with its error monitor and the collective-hang watchdog
(master/monitor/hang_watchdog.py, started under
``DLROVER_TPU_HANG_WATCHDOG``) onto one port of the port's transport
(rpc/transport.py), serves ``/metrics`` under
``DLROVER_TPU_MASTER_METRICS_PORT`` (master/metrics.py), and ``run``
decides the job's exit and logs the goodput attribution.

The goodput planner (brain/planner.py), armed by ``planner=True`` or
``DLROVER_TPU_PLANNER``: the master builds it over the speed monitor, the
training rendezvous and the job context, installs its growth gate on the
training rendezvous (scale-out waits for its executed plan), hands it to
the servicer (the membership poll carries its speculation hint) and to
``/metrics``, and wraps it in a ``JobAutoScaler`` over a
``LocalOptimizer`` and a ``LocalScaler``; every poll of ``run`` runs the
auto-scaler's ``sweep`` (throttled by the planner's decide interval and
the master config's ``seconds_to_autoscale_worker`` warmup) and writes
the planner's ledger through to the state store, which ``prepare``
restores before serving.

Relaunch continuity, as the JAX master wires it: the job's container sits
on ``create_state_backend(DLROVER_TPU_JOB_NAME)`` (master/state_store.py;
memory unless ``DLROVER_TPU_STATE_BACKEND`` says ``file``), the task
manager writes every dataset through to it, ``run`` snapshots the speed
ledger every poll and clears the state when the job succeeds, and
``prepare`` restores the datasets and the ledger BEFORE it serves: a
master SIGKILLed and started again on the same port with the same state
directory (``python -m dlrover_tpu_torch.master.main --port P``) honours
the surviving workers' leases and fences, carries the global step and the
goodput ledger on, and bills the gap as downtime backdated to the old
master's last snapshot.

The diagnosis manager (master/diagnosis/manager.py): the servicer routes
the agents' ``DiagnosisReportData`` and the straggler records to it, and
``prepare`` starts its observe loop (every ``seconds_diagnosis_interval``
of the master config, 60 s by default as in the JAX master): a hang the device timers flag and the step
reports confirm gets a synchronized hang dump and then a restart of every
worker, a failure signature in a shipped log tail a restart or a relaunch.
The JAX master also wires the metric collector; the servicer and job
manager skip it, and it waits in ROADMAP.md.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

from dlrover_tpu_torch.brain.planner import GoodputPlanner
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import JobExitReason, RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master import metrics as master_metrics
from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.job_container import JobContainer
from dlrover_tpu_torch.master.monitor.error_monitor import ErrorMonitor
from dlrover_tpu_torch.master.monitor.hang_watchdog import HangWatchdog
from dlrover_tpu_torch.master.node.job_auto_scaler import JobAutoScaler
from dlrover_tpu_torch.master.node.job_manager import LocalJobManager
from dlrover_tpu_torch.master.rendezvous.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous.manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.rendezvous.sync_service import SyncService
from dlrover_tpu_torch.master.resource.optimizer import LocalOptimizer
from dlrover_tpu_torch.master.scaler.base import LocalScaler
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.state_store import create_state_backend
from dlrover_tpu_torch.rpc.transport import RpcServer


class LocalJobMaster:
    def __init__(
        self,
        port: int = 0,
        node_num: int = 1,
        heartbeat_timeout: float = 600,
        min_node_num: Optional[int] = None,
        rdzv_waiting_timeout: float = 60,
        clock=None,
        planner: Optional[bool] = None,
        planner_kwargs: Optional[Dict] = None,
    ):
        # per-job state container: a fresh master gets a fresh container;
        # its continuity state is memory by default (dies with the
        # process), DLROVER_TPU_STATE_BACKEND=file makes a killed and
        # relaunched master resume its shard queues and ledger. clock:
        # the injectable "now" of the ledger, the rendezvous, the
        # planner and the auto-scaler (None = wall time)
        job_name = flags.JOB_NAME.get()
        self.container = JobContainer(
            job_name=job_name,
            state_backend=create_state_backend(job_name),
            clock=clock,
        )
        ctx = self.container.job_context
        self.state_manager = self.container.state_manager
        self.speed_monitor = self.container.speed_monitor
        self.speed_monitor.set_target_worker_num(node_num)
        self.task_manager = TaskManager(
            speed_monitor=self.speed_monitor,
            state_manager=self.state_manager,
            clock=clock,
        )
        self.error_monitor = ErrorMonitor()
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(
                clock=clock, config=self.container.config
            ),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(
                clock=clock, config=self.container.config
            ),
        }
        self.job_manager = LocalJobManager(
            speed_monitor=self.speed_monitor,
            heartbeat_timeout=heartbeat_timeout,
            error_monitor=self.error_monitor,
            rdzv_managers=self.rdzv_managers,
            job_context=ctx,
        )
        min_n = min_node_num if min_node_num is not None else node_num
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(
                min_nodes=min_n,
                max_nodes=node_num,
                waiting_timeout=rdzv_waiting_timeout,
                node_unit=1,
            )
        self.kv_store = KVStoreService()
        self.sync_service = SyncService(ctx)
        self.diagnosis_manager = DiagnosisManager(
            speed_monitor=self.speed_monitor,
            job_context=ctx,
            config=self.container.config,
        )
        # the goodput planner: observe -> decide -> act over the speed
        # monitor's measured ledgers (module docstring)
        self.planner = None
        self.auto_scaler = None
        armed = planner if planner is not None else flags.PLANNER.get()
        if armed:
            training = self.rdzv_managers[RendezvousName.TRAINING]
            self.planner = GoodputPlanner(
                speed_monitor=self.speed_monitor,
                rdzv_manager=training,
                job_context=ctx,
                clock=clock,
                min_nodes=min_n,
                max_nodes=node_num,
                **(planner_kwargs or {}),
            )
            self.container.attach_planner(self.planner)
            training.set_growth_gate(self.planner.growth_allowed)
            self.auto_scaler = JobAutoScaler(
                optimizer=LocalOptimizer(
                    min_workers=min_n, max_workers=node_num
                ),
                scaler=LocalScaler(job_context=ctx),
                speed_monitor=self.speed_monitor,
                planner=self.planner,
                clock=clock,
                job_context=ctx,
                config=self.container.config,
                rdzv_manager=training,
            )
        # eviction must also re-enqueue the dead node's data shards
        self.job_manager.attach_task_manager(self.task_manager)
        self.servicer = MasterServicer(
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            speed_monitor=self.speed_monitor,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            planner=self.planner,
            diagnosis_manager=self.diagnosis_manager,
            job_context=ctx,
        )
        self._server = RpcServer(self.servicer, port=port)
        # Overloaded replies advertise how far a worker may widen its
        # cadence before the heartbeat evictor declares it dead
        self._server.gate.liveness_ceiling_s = heartbeat_timeout / 3.0
        # shed-aware liveness: the evictor treats a recently shed node
        # as alive
        self.job_manager.attach_gate(self._server.gate)
        self.hang_watchdog = HangWatchdog(
            speed_monitor=self.speed_monitor,
            rdzv_manager=self.rdzv_managers[RendezvousName.TRAINING],
            job_context=ctx,
            task_manager=self.task_manager,
            clock=clock,
        )
        self.port = self._server.port
        self._metrics_server = None
        self._exit_code = 0
        self._exit_reason = ""

    def prepare(self):
        # restore BEFORE serving: surviving workers retry their lease
        # calls against this address, and an empty registry reads as
        # the end of the data
        restored = self.task_manager.restore_from_state()
        speed_state = self.state_manager.load_speed()
        if speed_state:
            self.speed_monitor.import_state(speed_state)
        if self.planner is not None:
            planner_state = self.state_manager.load_planner()
            if planner_state:
                # the relaunched planner keeps its cooldown window and
                # hysteresis streak: it must not re-execute the plan the
                # dead master paid for
                self.planner.import_state(planner_state)
        if restored or speed_state:
            logger.info(
                "local master resumed state: %s datasets, global_step=%s",
                restored,
                self.speed_monitor.completed_global_step,
            )
            # the gap while no master was serving is downtime, backdated
            # to the old master's last ledger snapshot
            snap_ts = float((speed_state or {}).get("snapshot_time", 0.0))
            self.speed_monitor.mark_downtime_start(ts=snap_ts or None)
        self._server.start()
        self._metrics_server = master_metrics.maybe_start(
            self._server, self.speed_monitor, planner=self.planner)
        self.task_manager.start()
        self.job_manager.start()
        self.diagnosis_manager.start_observing()
        if flags.HANG_WATCHDOG.get():
            self.hang_watchdog.start()
        logger.info("local master serving on port %s", self.port)

    def run(self, poll_interval: float = 1.0) -> int:
        """Block until all workers exit; returns the exit code (0 when the
        job succeeded)."""
        try:
            while True:
                time.sleep(poll_interval)
                self.state_manager.save_speed(
                    self.speed_monitor.export_state())
                if self.auto_scaler is not None:
                    # the decision cycle rides the poll loop (throttled
                    # by the planner's decide interval)
                    try:
                        self.auto_scaler.sweep()
                    except Exception:
                        logger.exception("planner sweep failed")
                if self.planner is not None:
                    self.state_manager.save_planner(
                        self.planner.export_state())
                if self.job_manager.all_workers_succeeded():
                    self._exit_reason = JobExitReason.SUCCEEDED
                    break
                if self.job_manager.any_worker_failed_fatally():
                    self._exit_reason = JobExitReason.ERROR
                    self._exit_code = 1
                    break
                if self.job_manager.all_workers_exited():
                    workers = self.container.job_context.workers()
                    if workers:
                        self._exit_reason = JobExitReason.SUCCEEDED
                        break
        finally:
            self.stop()
            # after stop's last flush, so no drain writes a dataset back
            if self._exit_reason == JobExitReason.SUCCEEDED:
                self.state_manager.clear()
        logger.info(goodput_summary(self.speed_monitor))
        logger.info(
            "local master exiting: %s; checkpoint steps by node %s",
            self._exit_reason, self.container.job_context.ckpt_steps(),
        )
        return self._exit_code

    def stop(self):
        # the server and the watchdog first: neither mutates a dataset
        # after the task manager's last flush
        self._server.stop(grace=1)
        self.hang_watchdog.stop()
        self.diagnosis_manager.stop()
        self.task_manager.stop()
        self.job_manager.stop()
        if self._metrics_server is not None:
            self._metrics_server.stop()


def goodput_summary(speed_monitor) -> str:
    """A speed monitor's reading, one line: goodput, downtime seconds,
    global step, straggler ids, the lost-time attribution and the closed
    downtime brackets as ``[start, end]`` epoch seconds."""
    sm = speed_monitor
    brackets = [[e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6]
                for e in sm.trace_events()]
    return (f"goodput {sm.goodput():.6f}, downtime "
            f"{sm.total_downtime():.3f}s, global step "
            f"{sm.completed_global_step}, stragglers {sm.stragglers()}; "
            f"attribution {json.dumps(sm.attribution())}; downtime brackets "
            f"{json.dumps(brackets)}")


def start_local_master(
    port: int = 0, node_num: int = 1, **kw
) -> LocalJobMaster:
    """Test/standalone helper: boot a master, return it (already serving)."""
    master = LocalJobMaster(port=port, node_num=node_num, **kw)
    master.prepare()
    return master
