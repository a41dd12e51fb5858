"""Agent/worker-side client of the master (typed wrappers): the
port's own copy of dlrover_tpu/agent/master_client.py, over the port's
transport (rpc/transport.py).

It carries every call the port's agent and worker make: rendezvous (the
membership poll with the goodput planner's speculation hint included),
node lifecycle, the folded worker report, the global step and the
checkpoint step; data sharding (dataset params, per-task dispatch, batched
shard leases, the shard checkpoint, the dataset epoch); the parallel
config the agent's tuner fetches; and the KV store. The JAX client's
process singleton and its other calls (the network check, barriers, model
info, diagnosis data, the resize breakdown, the legacy heartbeat and
resource reports) wait for the code that makes them (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import NodeType, RendezvousName
from dlrover_tpu_torch.rpc import policy as rpc_policy
from dlrover_tpu_torch.rpc.transport import RpcClient


class MasterClient:
    def __init__(
        self,
        master_addr: str,
        node_id: int,
        node_type: str = NodeType.WORKER,
    ):
        # the node id rides every call as a cheap header so the master's
        # admission gate knows who it shed
        self._client = RpcClient(master_addr, node_id=node_id)
        self.master_addr = master_addr
        self.node_id = node_id
        self.node_type = node_type

    def available(self, timeout: float = 5.0) -> bool:
        return self._client.available(timeout)

    # -- rendezvous ---------------------------------------------------------

    def join_rendezvous(
        self,
        node_rank: int,
        local_world_size: int = 1,
        rdzv_name: str = RendezvousName.TRAINING,
        node_ip: str = "",
        node_port: int = 0,
    ) -> int:
        resp = self._client.get(
            msg.JoinRendezvousRequest(
                node_id=self.node_id,
                node_rank=node_rank,
                local_world_size=local_world_size,
                rdzv_name=rdzv_name,
                node_ip=node_ip,
                node_port=node_port,
            )
        )
        return resp.round

    def get_comm_world(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> msg.CommWorldResponse:
        return self._client.get(
            msg.CommWorldRequest(node_id=self.node_id, rdzv_name=rdzv_name)
        )

    def num_nodes_waiting(self, rdzv_name: str = RendezvousName.TRAINING) -> int:
        resp = self._client.get(msg.NumNodesWaitingRequest(rdzv_name=rdzv_name))
        return resp.waiting_num

    def rendezvous_status(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> Tuple[int, int, Dict]:
        """(waiting_num, latest_round, speculation_hint). A worker whose
        seated round is older than ``latest_round`` is hung in a dead
        collective (the hang watchdog re-formed the world without it).
        The hint is the goodput planner's intended next world ({} = no
        executed intent, or a master without the field: the ``getattr``
        default keeps version skew harmless); it rides the same response,
        so a caller that already polls membership pays no extra RPC."""
        resp = self._client.get(msg.NumNodesWaitingRequest(rdzv_name=rdzv_name))
        return (
            resp.waiting_num,
            getattr(resp, "latest_round", 0),
            dict(getattr(resp, "speculation_hint", None) or {}),
        )

    def speculation_hint(
        self, rdzv_name: str = RendezvousName.TRAINING
    ) -> Dict:
        """Hint-only poll for processes that do not otherwise poll
        membership (the training worker's throttled
        ``WorkerContext.poll_speculation_hint``)."""
        return self.rendezvous_status(rdzv_name)[2]

    # -- node lifecycle -----------------------------------------------------

    def report_node_address(self, addr: str, port: int = 0):
        return self._client.report(
            msg.NodeAddressReport(
                node_type=self.node_type,
                node_id=self.node_id,
                addr=addr,
                port=port,
            )
        )

    def report_failure(
        self,
        error_data: str,
        restart_count: int = 0,
        level: str = "error",
        exit_code: int = 1,
        timestamp: float = 0.0,
    ):
        return self._client.report(
            msg.NodeFailureReport(
                node_type=self.node_type,
                node_id=self.node_id,
                restart_count=restart_count,
                error_data=error_data,
                level=level,
                exit_code=exit_code,
                # stamped at send, so a retried report (a master
                # relaunch gap) still carries the true failure time
                timestamp=timestamp or time.time(),
            ),
            retries=8,
            policy=rpc_policy.RELAUNCH_TOLERANT,
        )

    def report_succeeded(self):
        # the agent's LAST message: it concludes the job master-side.
        # RELAUNCH_TOLERANT: finishing during a master relaunch gap
        # must conclude the job, not crash the agent after a clean run
        return self._client.report(
            msg.SucceededReport(node_type=self.node_type, node_id=self.node_id),
            retries=8,
            policy=rpc_policy.RELAUNCH_TOLERANT,
        )

    def report_global_step(
        self,
        step: int,
        digest: Optional[Dict] = None,
        timestamp: float = 0.0,
    ):
        """The worker's step and its window of the step-time digest (the
        JAX report's comm split waits for the profiler slice)."""
        return self._client.report(
            msg.GlobalStepReport(
                node_id=self.node_id,
                step=step,
                timestamp=timestamp or time.time(),
                digest=dict(digest) if digest else {},
            )
        )

    def report_worker_status(
        self,
        cpu_percent: float,
        memory_mb: float,
        tpu_duty_cycle: float = 0.0,
        tpu_hbm_used_mb: float = 0.0,
    ) -> msg.WorkerReportResponse:
        """The folded periodic report: heartbeat and resource usage in one
        RPC. ``on_overload="raise"``: a shed periodic report is not
        retried; the caller honors the backpressure by widening its
        interval (:class:`~dlrover_tpu_torch.rpc.policy.AdaptiveInterval`)."""
        return self._client.report(
            msg.WorkerReport(
                node_type=self.node_type,
                node_id=self.node_id,
                timestamp=time.time(),
                has_resource=True,
                cpu_percent=cpu_percent,
                memory_mb=memory_mb,
                tpu_duty_cycle=tpu_duty_cycle,
                tpu_hbm_used_mb=tpu_hbm_used_mb,
            ),
            retries=1,
            on_overload="raise",
        )

    def report_diagnosis_data(self, data_cls: str, content: str,
                              node_rank: int = -1):
        """One observation for the master's diagnosis manager: ``data_cls``
        names its record class (diagnosis/data.py), ``content`` is its
        JSON."""
        return self._client.report(
            msg.DiagnosisReportData(
                data_cls=data_cls,
                data_content=content,
                node_id=self.node_id,
                node_type=self.node_type,
                node_rank=node_rank,
            )
        )

    # -- data sharding ------------------------------------------------------

    def report_dataset_shard_params(self, params: msg.DatasetShardParams):
        return self._client.report(params)

    def get_task(self, dataset_name: str) -> msg.Task:
        # RELAUNCH_TOLERANT backoff (~45s of cumulative sleep over 9
        # attempts): the data path stalls through a master relaunch gap
        # instead of failing the epoch
        return self._client.get(
            msg.TaskRequest(dataset_name=dataset_name, node_id=self.node_id),
            timeout=60,
            retries=9,
            policy=rpc_policy.RELAUNCH_TOLERANT,
        )

    def report_task_result(
        self,
        dataset_name: str,
        task_id: int,
        success: bool = True,
        lease_epoch: int = -1,
    ):
        return self._client.report(
            msg.TaskResult(
                dataset_name=dataset_name,
                task_id=task_id,
                node_id=self.node_id,
                success=success,
                lease_epoch=lease_epoch,
            ),
            retries=9,
            policy=rpc_policy.RELAUNCH_TOLERANT,
        )

    def lease_shards(
        self,
        dataset_name: str,
        count: int,
        done_ids: Optional[List[int]] = None,
        failed_ids: Optional[List[int]] = None,
        lease_epoch: int = -1,
    ) -> msg.ShardLeaseResponse:
        """The batched data plane: ack the finished shards of the
        previous batch and lease up to ``count`` fresh shards under one
        per-worker lease in a single RPC (renewed by the folded
        WorkerReport; expiry re-enqueues at-least-once, the fence dedups).
        RELAUNCH_TOLERANT like get_task."""
        return self._client.get(
            msg.ShardLeaseRequest(
                dataset_name=dataset_name,
                node_id=self.node_id,
                count=count,
                done_task_ids=[int(t) for t in done_ids or ()],
                failed_task_ids=[int(t) for t in failed_ids or ()],
                lease_epoch=lease_epoch,
            ),
            timeout=60,
            retries=9,
            policy=rpc_policy.RELAUNCH_TOLERANT,
        )

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._client.get(
            msg.ShardCheckpointRequest(dataset_name=dataset_name))
        return resp.content

    def report_shard_checkpoint(self, dataset_name: str, content: str):
        return self._client.report(
            msg.ShardCheckpointReport(dataset_name=dataset_name,
                                      content=content)
        )

    def get_dataset_epoch(self, dataset_name: str) -> int:
        return self._client.get(
            msg.DatasetEpochRequest(dataset_name=dataset_name)
        ).epoch

    # -- runtime config -----------------------------------------------------

    def get_paral_config(self) -> msg.ParallelConfig:
        """The parallel config the master pushed for this node (the
        agent's ``ParalConfigTuner`` polls it)."""
        return self._client.get(msg.ParallelConfigRequest(node_id=self.node_id))

    # -- kv store ----------------------------------------------------------

    def kv_store_set(self, key: str, value: bytes):
        return self._client.report(msg.KVStoreSet(key=key, value=value))

    def kv_store_get(self, key: str) -> bytes:
        return self._client.get(msg.KVStoreGet(key=key)).value

    def kv_store_multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        return self._client.get(msg.KVStoreMultiGet(keys=keys)).kvs

    def kv_store_multi_set(self, kvs: Dict[str, bytes]):
        return self._client.report(msg.KVStoreMultiSet(kvs=kvs))

    def kv_store_add(self, key: str, amount: int = 1) -> int:
        return self._client.get(msg.KVStoreAdd(key=key, amount=amount)).num

    # -- checkpoint ---------------------------------------------------------

    def report_ckpt_step(self, step: int, blocking_s: float, persist_s: float = 0.0):
        return self._client.report(
            msg.CheckpointStepReport(
                node_id=self.node_id,
                step=step,
                blocking_s=blocking_s,
                persist_s=persist_s,
            )
        )

    def close(self):
        self._client.close()

