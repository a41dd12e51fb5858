"""Agent/worker-side client of the master (typed wrappers): the
port's own copy of dlrover_tpu/agent/master_client.py, over the port's
transport (rpc/transport.py).

It carries every call the slice's agent and worker make: rendezvous, node
lifecycle, the folded worker report, the global step and the checkpoint
step; and the KV store. The JAX client's process singleton and its other
calls (data sharding, the network check, barriers, model info, parallel
config, diagnosis data, the resize breakdown, the legacy heartbeat and
resource reports) wait for the code that makes them (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Dict, List

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

    def report_global_step(self, step: int, timestamp: float = 0.0):
        """The worker's step (the JAX report's digest and comm split wait
        for the tracing slice)."""
        return self._client.report(
            msg.GlobalStepReport(
                node_id=self.node_id,
                step=step,
                timestamp=timestamp or time.time(),
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

