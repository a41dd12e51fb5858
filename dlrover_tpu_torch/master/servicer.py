"""The master's control-plane API: one ``get`` + one ``report`` dispatch.
The port's own copy of dlrover_tpu/master/servicer.py: every handler, with
the same ``None`` guards, so a master wired with only what the port has
(no metric collector yet) answers every request the JAX master answers,
with the same reply. One addition: a
``CheckpointStepReport``'s step is kept in the job context
(``JobContext.ckpt_steps``) for the master's exit line; its blocking
seconds go to the speed monitor, as in the JAX master, which keeps no step.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import NodeType, RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.rendezvous.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous.manager import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.rendezvous.net_topology import NodeTopologyMeta
from dlrover_tpu_torch.master.rendezvous.sync_service import SyncService


class MasterServicer:
    def __init__(
        self,
        task_manager=None,
        job_manager=None,
        speed_monitor=None,
        rdzv_managers: Optional[Dict] = None,
        diagnosis_manager=None,
        kv_store: Optional[KVStoreService] = None,
        sync_service: Optional[SyncService] = None,
        elastic_run_configs: Optional[Dict] = None,
        metric_collector=None,
        planner=None,
        job_context=None,
    ):
        self._metric_collector = metric_collector
        #: goodput planner: the membership poll carries its
        #: speculation hint
        self._planner = planner
        self._task_manager = task_manager
        self._job_manager = job_manager
        self._speed_monitor = speed_monitor
        self._rdzv_managers = rdzv_managers or {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self._diagnosis_manager = diagnosis_manager
        self._kv_store = kv_store or KVStoreService()
        self._job_context = (
            job_context if job_context is not None else JobContext()
        )
        self._sync_service = sync_service or SyncService(job_context)
        self._elastic_run_configs = elastic_run_configs or {}
        self.start_training_time: float = 0.0

        self._get_handlers = {
            msg.TaskRequest: self._get_task,
            msg.ShardLeaseRequest: self._lease_shards,
            msg.ShardCheckpointRequest: self._get_shard_checkpoint,
            msg.DatasetEpochRequest: self._get_dataset_epoch,
            msg.JoinRendezvousRequest: self._join_rendezvous,
            msg.CommWorldRequest: self._get_comm_world,
            msg.NumNodesWaitingRequest: self._num_nodes_waiting,
            msg.NetworkReadyRequest: self._network_ready,
            msg.FaultNodesRequest: self._get_fault_nodes,
            msg.StragglersRequest: self._get_stragglers,
            msg.KVStoreGet: self._kv_get,
            msg.KVStoreMultiGet: self._kv_multi_get,
            msg.KVStoreAdd: self._kv_add,
            msg.RunningNodesRequest: self._running_nodes,
            msg.TrainingStatusRequest: self._training_status,
            msg.ParallelConfigRequest: self._get_paral_config,
            msg.ElasticRunConfigRequest: self._get_elastic_run_config,
            msg.SyncQuery: self._sync_query,
            msg.PreCheckRequest: self._pre_check,
        }
        self._report_handlers = {
            msg.DatasetShardParams: self._new_dataset,
            msg.TaskResult: self._report_task_result,
            msg.ShardCheckpointReport: self._restore_shard_checkpoint,
            msg.NodeAddressReport: self._report_node_address,
            msg.HeartbeatReport: self._report_heartbeat,
            msg.NodeFailureReport: self._report_failure,
            msg.SucceededReport: self._report_succeeded,
            msg.ResourceUsageReport: self._report_resource,
            msg.GlobalStepReport: self._report_global_step,
            msg.ModelInfoReport: self._report_model_info,
            msg.NetworkCheckResult: self._report_network_check,
            msg.NodeCheckStatusReport: self._report_node_check_status,
            msg.KVStoreSet: self._kv_set,
            msg.KVStoreMultiSet: self._kv_multi_set,
            msg.SyncJoin: self._sync_join,
            msg.SyncFinish: self._sync_finish,
            msg.DiagnosisReportData: self._report_diagnosis_data,
            msg.CheckpointStepReport: self._report_ckpt_step,
            msg.ResizeBreakdownReport: self._report_resize_breakdown,
            msg.WorkerReport: self._worker_report,
        }

    # -- dispatch -----------------------------------------------------------

    def get(self, request, context=None):
        handler = self._get_handlers.get(type(request))
        if handler is None:
            logger.warning("no get handler for %s", type(request).__name__)
            # the SAME reply shape transport._skew_reply sends for a
            # type serde cannot even decode: clients get one skew
            # signature to feature-detect on, with the type named
            return msg.SimpleResponse(
                success=False,
                reason=(
                    f"unknown message type {type(request).__name__!r} "
                    "(version skew)"
                ),
            )
        return handler(request)

    def report(self, request, context=None):
        handler = self._report_handlers.get(type(request))
        if handler is None:
            logger.warning("no report handler for %s", type(request).__name__)
            return msg.SimpleResponse(
                success=False,
                reason=(
                    f"unknown message type {type(request).__name__!r} "
                    "(version skew)"
                ),
            )
        return handler(request)

    # -- data sharding ------------------------------------------------------

    def _new_dataset(self, request: msg.DatasetShardParams):
        self._task_manager.new_dataset(request)
        return msg.SimpleResponse()

    def _get_task(self, request: msg.TaskRequest):
        return self._task_manager.get_dataset_task(
            request.node_id, request.dataset_name
        )

    def _report_task_result(self, request: msg.TaskResult):
        ok = self._task_manager.report_dataset_task(
            request.dataset_name,
            request.task_id,
            request.success,
            lease_epoch=getattr(request, "lease_epoch", -1),
        )
        return msg.SimpleResponse(success=ok)

    def _lease_shards(self, request: msg.ShardLeaseRequest):
        """The batched data plane (docs/design/data_plane.md): one call
        acks the previous batch's completions under the presented fence
        and leases up to ``count`` fresh shards under the node's lease.
        Classified as a *get* so it sheds at the higher watermark — a
        shed lease stalls training, a shed heartbeat costs nothing."""
        grant = self._task_manager.lease_shards(
            request.node_id,
            request.dataset_name,
            request.count,
            done_ids=request.done_task_ids,
            failed_ids=request.failed_task_ids,
            lease_epoch=request.lease_epoch,
        )
        return msg.ShardLeaseResponse(
            tasks=grant.tasks,
            lease_epoch=grant.lease_epoch,
            deadline_ts=grant.deadline,
            acked=grant.acked,
            idle=grant.idle,
            exhausted=grant.exhausted,
        )

    def _get_shard_checkpoint(self, request: msg.ShardCheckpointRequest):
        ckpt = self._task_manager.checkpoint_dataset(request.dataset_name)
        return msg.ShardCheckpointResponse(content=ckpt.to_json() if ckpt else "")

    def _restore_shard_checkpoint(self, request: msg.ShardCheckpointReport):
        ok = self._task_manager.restore_dataset_checkpoint(request.content)
        return msg.SimpleResponse(success=bool(ok))

    def _get_dataset_epoch(self, request: msg.DatasetEpochRequest):
        return msg.DatasetEpochResponse(
            epoch=self._task_manager.get_epoch(request.dataset_name)
        )

    # -- rendezvous ---------------------------------------------------------

    def _join_rendezvous(self, request: msg.JoinRendezvousRequest):
        mgr = self._rdzv_managers[request.rdzv_name or RendezvousName.TRAINING]
        meta = NodeTopologyMeta(
            node_id=request.node_id,
            node_rank=request.node_rank,
            process_num=request.local_world_size,
            node_ip=request.node_ip,
            node_port=request.node_port,
            slice_name=request.slice_name,
            coords=tuple(request.coords),
        )
        rdzv_round = mgr.join_rendezvous(request.node_id, request.node_rank, meta)
        if self._job_manager is not None and hasattr(
            self._job_manager, "get_or_register_node"
        ):
            self._job_manager.get_or_register_node(NodeType.WORKER, request.node_id)
        return msg.JoinRendezvousResponse(round=rdzv_round)

    def _get_comm_world(self, request: msg.CommWorldRequest):
        mgr = self._rdzv_managers[request.rdzv_name or RendezvousName.TRAINING]
        rdzv_round, group, world, coord = mgr.get_comm_world(request.node_id)
        wire_world = {
            str(rank): [m.node_id, m.process_num, m.node_ip, m.node_port]
            for rank, m in world.items()
        }
        # slice names ride a separate field, so agents can size the DCN
        # axis of a multislice mesh from the live world (slice-count
        # elasticity) while old agents' 4-tuple unpack keeps working
        slice_names = {
            str(rank): getattr(m, "slice_name", "") or ""
            for rank, m in world.items()
        }
        return msg.CommWorldResponse(
            rdzv_round=rdzv_round,
            group=group,
            world=wire_world,
            coordinator_addr=coord,
            completed=bool(world),
            slice_names=slice_names,
        )

    def _num_nodes_waiting(self, request: msg.NumNodesWaitingRequest):
        mgr = self._rdzv_managers[request.rdzv_name or RendezvousName.TRAINING]
        hint: Dict = {}
        if self._planner is not None:
            # the planner's intended next world rides the poll every
            # agent already makes — zero extra RPCs for the hint
            hint = self._planner.speculation_hint()
        return msg.NumNodesWaitingResponse(
            waiting_num=mgr.num_nodes_waiting(),
            # workers seated in an OLDER round than this are hung in a
            # dead collective (post-watchdog re-form) and must re-join
            latest_round=mgr.get_rdzv_round(),
            speculation_hint=hint,
        )

    def _network_ready(self, request: msg.NetworkReadyRequest):
        mgr = self._rdzv_managers[RendezvousName.NETWORK_CHECK]
        success, reason = mgr.network_check_success()
        return msg.SimpleResponse(success=success, reason=reason)

    def _get_fault_nodes(self, request: msg.FaultNodesRequest):
        mgr = self._rdzv_managers[RendezvousName.NETWORK_CHECK]
        nodes, reason = mgr.check_fault_node()
        return msg.FaultNodesResponse(nodes=nodes, reason=reason)

    def _get_stragglers(self, request: msg.StragglersRequest):
        mgr = self._rdzv_managers[RendezvousName.NETWORK_CHECK]
        nodes, _ = mgr.get_straggler()
        if self._speed_monitor is not None:
            # union of the pre-training network-check stragglers and
            # the RUNTIME ones the step-digest detector flagged
            # (master/monitor/straggler.py)
            nodes = sorted(set(nodes) | set(self._speed_monitor.stragglers()))
        return msg.StragglersResponse(nodes=nodes)

    def _report_network_check(self, request: msg.NetworkCheckResult):
        mgr = self._rdzv_managers[RendezvousName.NETWORK_CHECK]
        mgr.report_network_check_result(
            request.node_id, request.normal, request.elapsed_time
        )
        return msg.SimpleResponse()

    # -- node lifecycle -----------------------------------------------------

    def _report_node_address(self, request: msg.NodeAddressReport):
        if self._job_manager is not None:
            if hasattr(self._job_manager, "get_or_register_node"):
                self._job_manager.get_or_register_node(
                    request.node_type, request.node_id
                )
            self._job_manager.update_node_address(
                request.node_type,
                request.node_id,
                request.addr,
                request.port,
                request.slice_name,
                request.coords,
            )
        return msg.SimpleResponse()

    def _report_heartbeat(self, request: msg.HeartbeatReport):
        actions = []
        if self._job_manager is not None:
            action = self._job_manager.collect_node_heartbeat(
                request.node_type, request.node_id, request.timestamp or time.time()
            )
            if action is not None:
                actions.append(action)
        return msg.HeartbeatResponse(actions=actions)

    def _report_failure(self, request: msg.NodeFailureReport):
        if self._job_manager is not None:
            self._job_manager.handle_training_failure(
                request.node_type,
                request.node_id,
                request.restart_count,
                request.error_data,
                request.level,
                request.exit_code,
            )
        if self._task_manager is not None:
            self._task_manager.remove_node_tasks(request.node_id)
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(request.node_id)
        if self._speed_monitor is not None:
            # a delayed/retried failure report opens the bracket at the
            # true failure time, not its arrival time
            self._speed_monitor.mark_downtime_start(
                ts=request.timestamp or None
            )
        return msg.SimpleResponse()

    def _report_succeeded(self, request: msg.SucceededReport):
        if self._job_manager is not None:
            self._job_manager.handle_node_succeeded(
                request.node_type or NodeType.WORKER, request.node_id
            )
        return msg.SimpleResponse()

    def _report_resource(self, request: msg.ResourceUsageReport):
        if self._job_manager is not None:
            self._job_manager.update_node_resource_usage(
                request.node_type,
                request.node_id,
                request.cpu_percent,
                request.memory_mb,
                tpu_duty_cycle=request.tpu_duty_cycle,
                tpu_hbm_used_mb=request.tpu_hbm_used_mb,
            )
        return msg.SimpleResponse()

    def _report_global_step(self, request: msg.GlobalStepReport):
        if self._speed_monitor is not None:
            self._speed_monitor.collect_global_step(
                request.step, request.timestamp or time.time()
            )
            self._speed_monitor.mark_downtime_end(
                ts=request.timestamp or None
            )
            digest = getattr(request, "digest", None)
            if digest:
                self._collect_digest(
                    request.node_id, digest,
                    request.timestamp or time.time(),
                )
            comm_links = getattr(request, "comm_links", None)
            # getattr-with-default: a pre-overlap worker's report has
            # no overlap_ratio field — skew reads the sentinel
            ratio = getattr(request, "overlap_ratio", -1.0)
            if comm_links or (ratio is not None and ratio >= 0.0):
                # per-link comm split (profiler/comm.py) + DCN overlap
                # ratio: feeds the goodput report's ici/dcn section
                self._speed_monitor.record_comm_links(
                    request.node_id, comm_links or {},
                    overlap_ratio=ratio if ratio is not None else -1.0,
                )
        return msg.SimpleResponse()

    def _collect_digest(self, node_id: int, digest: Dict, ts: float):
        """Fold one rank's step-time digest; a NEWLY flagged straggler
        enters the diagnosis pipeline like any other observation — the
        resolve chain decides whether to act on it."""
        record = self._speed_monitor.collect_step_digest(
            node_id, digest, ts=ts
        )
        if record is not None and self._diagnosis_manager is not None:
            import json as _json

            self._diagnosis_manager.collect_diagnosis_data(
                msg.DiagnosisReportData(
                    data_cls="StragglerRecordData",
                    data_content=_json.dumps(record.to_dict()),
                    node_id=record.node_id,
                )
            )

    def _worker_report(self, request: msg.WorkerReport):
        """The folded periodic report (heartbeat + step digest +
        resource usage in one RPC). Heartbeat semantics
        match ``_report_heartbeat`` exactly (re-adoption after a master
        relaunch included); the step/digest section only touches the
        goodput ledger when it carries actual progress, so a heartbeat
        sent during a stall never closes a downtime bracket."""
        node_type = request.node_type or NodeType.WORKER
        ts = request.timestamp or time.time()
        actions = []
        if self._job_manager is not None:
            action = self._job_manager.collect_node_heartbeat(
                node_type, request.node_id, ts
            )
            if action is not None:
                actions.append(action)
            if request.has_resource:
                # getattr: reports from pre-HBM senders deserialize
                # without the field (wire default 0.0 = not measured)
                self._job_manager.update_node_resource_usage(
                    node_type,
                    request.node_id,
                    request.cpu_percent,
                    request.memory_mb,
                    tpu_duty_cycle=request.tpu_duty_cycle,
                    tpu_hbm_used_mb=getattr(
                        request, "tpu_hbm_used_mb", 0.0
                    ),
                )
        if self._speed_monitor is not None:
            digest = request.digest or {}
            if request.step >= 0:
                self._speed_monitor.collect_global_step(request.step, ts)
            if request.step >= 0 or int(digest.get("count", 0) or 0) > 0:
                self._speed_monitor.mark_downtime_end(
                    ts=request.timestamp or None
                )
            if digest:
                self._collect_digest(request.node_id, digest, ts)
        data_todo: Dict = {}
        if self._task_manager is not None:
            # data-plane liveness rides the report: every heartbeat
            # renews the node's shard leases (zero extra RPCs), and the
            # ack carries the queued-shard hint so idle workers learn a
            # death re-enqueued shards without polling. Renewal uses
            # the MASTER's clock (not the wire timestamp): deadlines
            # and expiry sweeps are stamped master-side, and a worker
            # whose clock lags by more than the TTL could otherwise
            # never extend its lease despite healthy reporting
            self._task_manager.renew_node_leases(request.node_id)
            data_todo = self._task_manager.todo_counts()
        return msg.WorkerReportResponse(actions=actions, data_todo=data_todo)

    def _report_model_info(self, request: msg.ModelInfoReport):
        if self._metric_collector is not None:
            self._metric_collector.set_model_info(
                request.param_count,
                request.flops_per_step,
                profile={
                    "seq_len": request.seq_len,
                    "hidden_dim": request.hidden_dim,
                    "n_layers": request.n_layers,
                    "n_heads": request.n_heads,
                    "remat": request.remat,
                    "batch_size": request.batch_size,
                },
            )
        return msg.SimpleResponse()

    def _report_node_check_status(self, request: msg.NodeCheckStatusReport):
        if self._job_manager is not None:
            self._job_manager.update_node_reported_status(
                NodeType.WORKER, request.node_id, request.status
            )
        return msg.SimpleResponse()

    def _running_nodes(self, request: msg.RunningNodesRequest):
        nodes = []
        for n in self._job_context.running_nodes():
            nodes.append(
                msg.NodeMeta(
                    node_type=n.type,
                    node_id=n.id,
                    node_rank=n.rank_index,
                    addr=n.host_addr,
                    port=n.host_port,
                    slice_name=n.topology.slice_name,
                    coords=tuple(n.topology.coords),
                )
            )
        return msg.RunningNodesResponse(nodes=nodes)

    def _training_status(self, request: msg.TrainingStatusRequest):
        status = "running" if self._speed_monitor and self._speed_monitor.completed_global_step > 0 else "pending"
        return msg.TrainingStatusResponse(status=status)

    # -- kv / sync ----------------------------------------------------------

    def _kv_set(self, request: msg.KVStoreSet):
        self._kv_store.set(request.key, request.value)
        return msg.SimpleResponse()

    def _kv_multi_set(self, request: msg.KVStoreMultiSet):
        self._kv_store.multi_set(request.kvs)
        return msg.SimpleResponse()

    def _kv_get(self, request: msg.KVStoreGet):
        value = self._kv_store.get(request.key)
        return msg.KVStoreResponse(found=bool(value), value=value)

    def _kv_multi_get(self, request: msg.KVStoreMultiGet):
        kvs = self._kv_store.multi_get(request.keys)
        return msg.KVStoreResponse(found=all(kvs.values()), kvs=kvs)

    def _kv_add(self, request: msg.KVStoreAdd):
        num = self._kv_store.add(request.key, request.amount)
        return msg.KVStoreResponse(found=True, num=num)

    def _sync_join(self, request: msg.SyncJoin):
        ok = self._sync_service.join_sync(request.sync_name, request.node_rank)
        return msg.SimpleResponse(success=ok)

    def _sync_finish(self, request: msg.SyncFinish):
        ok = self._sync_service.barrier(request.sync_name)
        return msg.SimpleResponse(success=ok)

    def _sync_query(self, request: msg.SyncQuery):
        return msg.SyncResponse(
            success=self._sync_service.sync_finished(request.sync_name)
        )

    # -- config / diagnosis -------------------------------------------------

    def _get_paral_config(self, request: msg.ParallelConfigRequest):
        node = self._job_context.get_node(NodeType.WORKER, request.node_id)
        if node is not None and node.paral_config:
            return msg.ParallelConfig(
                **msg.ParallelConfig.filter_known(node.paral_config)
            )
        return msg.ParallelConfig()

    def _get_elastic_run_config(self, request: msg.ElasticRunConfigRequest):
        return msg.ElasticRunConfigResponse(configs=dict(self._elastic_run_configs))

    def _pre_check(self, request: msg.PreCheckRequest):
        return msg.PreCheckResponse(status="pass")

    def _report_diagnosis_data(self, request: msg.DiagnosisReportData):
        if self._diagnosis_manager is not None:
            self._diagnosis_manager.collect_diagnosis_data(request)
        return msg.SimpleResponse()

    def _report_ckpt_step(self, request: msg.CheckpointStepReport):
        self._job_context.record_ckpt_step(request.node_id, request.step)
        if self._speed_monitor is not None:
            # the seconds a save blocked training feed the goodput
            # attribution's "checkpoint" category (it used to be
            # reported and then dropped on the floor here); per-rank so
            # the attribution can max instead of N-x-overcounting the
            # same job-wide pause
            self._speed_monitor.record_ckpt_blocking(
                request.blocking_s, node_id=request.node_id
            )
        return msg.SimpleResponse()

    def _report_resize_breakdown(self, request: msg.ResizeBreakdownReport):
        if self._speed_monitor is not None:
            self._speed_monitor.record_downtime_breakdown(
                rendezvous_s=request.rendezvous_s,
                compile_s=request.compile_s,
                state_transfer_s=request.state_transfer_s,
                # restore_tier postdates the message (wire_schema marks
                # it skew-guarded): a pre-tier worker's report simply
                # lacks it — found by wirecheck WC002
                restore_tier=getattr(request, "restore_tier", ""),
            )
        return msg.SimpleResponse()
