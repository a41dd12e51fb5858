"""Control-plane message vocabulary (master <-> agent/worker): the port's
own copy of dlrover_tpu/common/messages.py.

Every class, field and default is the JAX package's, under the same
registered name, so a message one package serialises decodes in the other.
All classes are wire-safe via :mod:`dlrover_tpu_torch.common.serde`.
"""

from __future__ import annotations

from dataclasses import field
from typing import Dict, List, Tuple

from dlrover_tpu_torch.common.serde import message

# ---------------------------------------------------------------------------
# Generic envelopes
# ---------------------------------------------------------------------------


@message
class BaseMessage:
    node_type: str = ""
    node_id: int = -1


@message
class SimpleResponse:
    success: bool = True
    reason: str = ""


@message
class OverloadedResponse:
    """Explicit backpressure: the server's admission gate shed this
    request instead of queueing it (rpc/transport.py RequestGate).
    Clients honor it by widening their report interval (periodic
    reporters) or sleeping at least ``retry_after_s`` before retrying
    (one-shot calls). Version-skew note: a PRE-gate client has no
    ``OverloadedResponse`` class at all, so its serde raises on the
    unknown ``_t``. Clients from this tree onward map that into the
    typed, non-retried :class:`~dlrover_tpu_torch.rpc.policy.
    UnknownMessageTypeError` naming the type (wirecheck WC003);
    clients OLDER than that mapping still surface it as a raw
    ValueError outside their retry loop — so the rollout rule stands:
    upgrade masters LAST (or raise the cap during the rollout) when
    old agents are in the fleet."""

    retry_after_s: float = 1.0
    queue_depth: int = 0
    reason: str = ""
    # the server's liveness ceiling: widen your cadence, but NEVER past
    # this, or the heartbeat evictor will declare you dead while you
    # are politely backing off (found by the fleet chaos harness: naive
    # AIMD widening under a 10x overload pushed healthy workers past
    # the eviction timeout). 0 = server didn't say; clients keep their
    # own bound.
    max_interval_s: float = 0.0


# ---------------------------------------------------------------------------
# Rendezvous
# ---------------------------------------------------------------------------


@message
class JoinRendezvousRequest:
    node_id: int = -1
    node_rank: int = -1
    local_world_size: int = 1  # chips driven by this host process
    rdzv_name: str = ""
    node_ip: str = ""
    node_port: int = 0
    slice_name: str = ""
    coords: Tuple = ()


@message
class JoinRendezvousResponse:
    round: int = 0


@message
class CommWorldRequest:
    node_id: int = -1
    rdzv_name: str = ""


@message
class CommWorldResponse:
    """The built world: rank assignment plus JAX bootstrap info.

    ``world`` maps node_rank -> (node_id, local_world_size).
    ``coordinator_addr`` feeds ``jax.distributed.initialize``.
    """

    rdzv_round: int = 0
    group: int = 0
    world: Dict = field(default_factory=dict)
    coordinator_addr: str = ""
    completed: bool = False
    # node_rank -> TPU slice name; a SEPARATE field (not a 5th world
    # element) so agents still running the 4-tuple unpack survive a
    # version-skewed master relaunch (serde drops unknown fields)
    slice_names: Dict = field(default_factory=dict)


@message
class NumNodesWaitingRequest:
    rdzv_name: str = ""


@message
class NumNodesWaitingResponse:
    waiting_num: int = 0
    # the latest completed rendezvous round: a worker seated in an
    # OLDER round is hung in a dead collective (the hang watchdog
    # re-formed the world without it) and must re-join even though
    # nobody is waiting. 0 on a pre-watchdog master — old workers keep
    # the waiting_num-only behavior (serde drops unknown fields)
    latest_round: int = 0
    # the goodput planner's speculation hint (brain/planner.py): the
    # EXACT world the planner intends to resize to next —
    # {"spec": "dp200", "world": 200, "n_slices": 1} — so agents
    # warm-compile that target instead of blind ±node/±slice neighbors
    # and a planner-directed resize lands on a pre-compiled executable.
    # Empty = no intent / planner off. Skew-safe both ways: an old
    # agent's serde drops the unknown field, a new agent treats a
    # missing/malformed payload as no hint.
    speculation_hint: Dict = field(default_factory=dict)


@message
class NetworkReadyRequest:
    pass


@message
class NetworkCheckResult:
    node_id: int = -1
    normal: bool = True
    elapsed_time: float = 0.0


@message
class FaultNodesRequest:
    pass


@message
class FaultNodesResponse:
    nodes: List[int] = field(default_factory=list)
    reason: str = ""


@message
class StragglersRequest:
    pass


@message
class StragglersResponse:
    nodes: List[int] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Node lifecycle
# ---------------------------------------------------------------------------


@message
class NodeMeta:
    node_type: str = ""
    node_id: int = -1
    node_rank: int = -1
    addr: str = ""
    port: int = 0  # auxiliary service port (ckpt replica server)
    slice_name: str = ""
    coords: Tuple = ()


@message
class NodeAddressReport:
    node_type: str = ""
    node_id: int = -1
    addr: str = ""
    port: int = 0
    slice_name: str = ""
    coords: Tuple = ()


@message
class HeartbeatReport:
    node_type: str = ""
    node_id: int = -1
    timestamp: float = 0.0


@message
class HeartbeatResponse:
    """Heartbeat ack optionally carrying diagnosis actions for the agent."""

    actions: List = field(default_factory=list)


@message
class NodeFailureReport:
    node_type: str = ""
    node_id: int = -1
    restart_count: int = 0
    error_data: str = ""
    level: str = "error"
    exit_code: int = 0
    # when the failure actually happened (0 = "now" on the master's
    # clock). Lets a delayed/retried report open the downtime bracket
    # at the true failure time, and lets the fleet harness drive the
    # goodput ledger on its virtual clock through the real wire.
    timestamp: float = 0.0


@message
class NodeCheckStatusReport:
    node_id: int = -1
    status: str = ""


@message
class SucceededReport:
    node_type: str = ""
    node_id: int = -1


@message
class ResourceUsageReport:
    node_type: str = ""
    node_id: int = -1
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0
    tpu_hbm_used_mb: float = 0.0


@message
class GlobalStepReport:
    node_id: int = -1
    step: int = 0
    timestamp: float = 0.0
    # windowed step-time digest (observability/digest.py): {count,
    # mean_s, p50_s, p95_s, max_s, input_wait_s} folded worker-side and
    # drained once per (throttled) report — per-rank timing reaches the
    # master's straggler detector and lost-time attribution with zero
    # extra RPCs. Empty = a pre-digest worker (serde drops unknown
    # fields both ways, so version skew is harmless).
    digest: Dict = field(default_factory=dict)
    # per-link-class analytic comm bytes/step ({"ici": N, "dcn": M},
    # profiler/comm.py CommLedger.link_bytes): rides the same throttled
    # report so the master's goodput report — and through it the
    # brain/tuner — sees how loaded the slow inter-slice link is.
    # Empty = single-link world or a pre-link worker (skew-safe).
    comm_links: Dict = field(default_factory=dict)
    # DCN overlap ratio of the running step program (overlapped /
    # total trip-weighted DCN bytes — the shardcheck SC006 split the
    # worker knows analytically from its schedule). Own float field —
    # comm_links values are int-coerced master-side. −1.0 sentinel =
    # not measured (single-slice, fused-hier, or a pre-overlap worker:
    # serde fills the default on skew, so old reports stay harmless).
    overlap_ratio: float = -1.0


@message
class ModelInfoReport:
    node_id: int = -1
    param_count: int = 0
    flops_per_step: float = 0.0
    batch_size: int = 0
    # transformer shape for the master's activation-memory model
    # (hyperparams.ModelProfile)
    seq_len: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    remat: bool = True


@message
class WorkerReport:
    """The folded periodic worker report, for backpressure:
    heartbeat + step progress/digest + resource usage in ONE RPC where
    the chatty protocol sent three. Every section is optional —
    ``step < 0`` means "no step progress to report" (a heartbeat during
    a stall must NOT close the master's downtime bracket), an empty
    ``digest`` means no window drained, ``has_resource`` gates the
    resource fields (0.0 is a legitimate cpu reading)."""

    node_type: str = ""
    node_id: int = -1
    timestamp: float = 0.0
    step: int = -1
    digest: Dict = field(default_factory=dict)
    has_resource: bool = False
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0
    # per-device HBM occupancy (MB) — the fleet-side input to the
    # planner's memcheck headroom oracle; 0.0 = not measured (old
    # senders omit the field entirely, wire default applies)
    tpu_hbm_used_mb: float = 0.0


@message
class WorkerReportResponse:
    """Ack of a folded report: diagnosis actions ride back exactly as
    on the heartbeat ack. ``data_todo`` maps dataset name -> queued
    shard count, so a worker whose lease polls went idle (empty todo)
    learns that a death re-enqueued shards WITHOUT polling the data
    plane — the report it already sends doubles as the wakeup."""

    actions: List = field(default_factory=list)
    data_todo: Dict = field(default_factory=dict)


@message
class RunningNodesRequest:
    pass


@message
class RunningNodesResponse:
    nodes: List[NodeMeta] = field(default_factory=list)


@message
class TrainingStatusRequest:
    pass


@message
class TrainingStatusResponse:
    status: str = ""


# ---------------------------------------------------------------------------
# Data sharding
# ---------------------------------------------------------------------------


@message
class DatasetShardParams:
    """Register a dataset to shard (reference: DatasetShardParams)."""

    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0
    num_epochs: int = 1
    shuffle: bool = False
    storage_type: str = "text"
    num_minibatches_per_shard: int = 0
    # streaming datasets: {partition -> starting offset}
    partition_offsets: Dict = field(default_factory=dict)


@message
class TaskRequest:
    dataset_name: str = ""
    node_id: int = -1


@message
class Task:
    task_id: int = -1
    task_type: str = ""  # "train" | "eval" | None
    dataset_name: str = ""
    shard_start: int = 0
    shard_end: int = 0
    shard_indices: List[int] = field(default_factory=list)
    epoch: int = 0
    partition: str = ""  # streaming datasets: source partition of the range

    @property
    def empty(self) -> bool:
        return self.task_id < 0


@message
class TaskResult:
    dataset_name: str = ""
    task_id: int = -1
    node_id: int = -1
    success: bool = True
    # the lease fence the task was issued under (-1 = legacy per-task
    # dispatch). A report whose fence no longer matches the master's
    # issue record is a zombie's late report of a re-issued shard and
    # is REJECTED — completed_records can never double-count
    lease_epoch: int = -1


@message
class ShardLeaseRequest:
    """Batched data-plane RPC (docs/design/data_plane.md): acknowledge
    the previously leased shards that finished (``done_task_ids`` /
    ``failed_task_ids``, fenced by ``lease_epoch``) and lease up to
    ``count`` fresh shards under one per-worker lease in the SAME round
    trip — steady-state the data plane costs one RPC per batch where
    the per-task protocol cost two per shard."""

    dataset_name: str = ""
    node_id: int = -1
    count: int = 0
    done_task_ids: List[int] = field(default_factory=list)
    failed_task_ids: List[int] = field(default_factory=list)
    lease_epoch: int = -1


@message
class ShardLeaseResponse:
    """``tasks`` are leased until ``deadline_ts`` under fence
    ``lease_epoch``; the lease renews on every folded ``WorkerReport``
    (zero extra steady-state RPCs) and expiry re-enqueues the undone
    shards at-least-once. ``acked`` lists the done ids that were
    actually counted (a stale fence acks nothing). ``idle`` = the todo
    queue is empty but shards are still in flight elsewhere (a death
    may re-enqueue them — wait for the report-ack data hint);
    ``exhausted`` = the dataset epoch is truly complete."""

    tasks: List[Task] = field(default_factory=list)
    lease_epoch: int = -1
    deadline_ts: float = 0.0
    acked: List[int] = field(default_factory=list)
    idle: bool = False
    exhausted: bool = False


@message
class ShardCheckpointRequest:
    dataset_name: str = ""


@message
class ShardCheckpointResponse:
    content: str = ""  # JSON-encoded DatasetShardCheckpoint


@message
class ShardCheckpointReport:
    dataset_name: str = ""
    content: str = ""


@message
class DatasetEpochRequest:
    dataset_name: str = ""


@message
class DatasetEpochResponse:
    epoch: int = 0


# ---------------------------------------------------------------------------
# KV store / sync barriers
# ---------------------------------------------------------------------------


@message
class KVStoreSet:
    key: str = ""
    value: bytes = b""


@message
class KVStoreGet:
    key: str = ""


@message
class KVStoreMultiGet:
    keys: List[str] = field(default_factory=list)


@message
class KVStoreMultiSet:
    kvs: Dict = field(default_factory=dict)


@message
class KVStoreAdd:
    key: str = ""
    amount: int = 1


@message
class KVStoreResponse:
    found: bool = False
    value: bytes = b""
    kvs: Dict = field(default_factory=dict)
    num: int = 0


@message
class SyncJoin:
    sync_name: str = ""
    node_id: int = -1
    node_rank: int = -1


@message
class SyncFinish:
    sync_name: str = ""


@message
class SyncQuery:
    sync_name: str = ""


@message
class SyncResponse:
    success: bool = False


# ---------------------------------------------------------------------------
# Elastic run / parallel config
# ---------------------------------------------------------------------------


@message
class ParallelConfig:
    """Runtime-tunable knobs pushed master->worker (reference grpc.py:477)."""

    dataloader_batch_size: int = 0
    dataloader_num_workers: int = 0
    dataloader_version: int = 0
    optimizer_learning_rate: float = 0.0
    optimizer_weight_decay: float = 0.0
    grad_accum_steps: int = 0
    optimizer_version: int = 0
    # relative adjustments (OOM recovery plans): applied to the worker's
    # own base config when the absolute fields above are 0
    micro_batch_scale: float = 1.0
    grad_accum_scale: float = 1.0
    restart: bool = False

    @classmethod
    def filter_known(cls, d: Dict) -> Dict:
        """Keep only keys that are wire fields (plans may carry extras)."""
        import dataclasses

        known = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in known}


@message
class ParallelConfigRequest:
    node_id: int = -1


@message
class ElasticRunConfigRequest:
    pass


@message
class ElasticRunConfigResponse:
    configs: Dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Checkpoint control
# ---------------------------------------------------------------------------


@message
class CheckpointStepReport:
    node_id: int = -1
    step: int = 0
    blocking_s: float = 0.0
    persist_s: float = 0.0


@message
class ResizeBreakdownReport:
    """Per-resize downtime breakdown (train/live_reshard.py): seconds a
    membership change spent in rendezvous vs the step rebuild vs moving
    the train state — feeds the SpeedMonitor's goodput attribution."""

    node_id: int = -1
    rendezvous_s: float = 0.0
    compile_s: float = 0.0
    state_transfer_s: float = 0.0
    # where the state that ended the downtime came from: "live"
    # (device-to-device reshard) or the checkpoint engine's restore
    # tier ("shm" | "disk" | "object"); "" = unreported
    restore_tier: str = ""


# ---------------------------------------------------------------------------
# Diagnosis
# ---------------------------------------------------------------------------


@message
class DiagnosisReportData:
    data_cls: str = ""
    data_content: str = ""
    node_id: int = -1
    node_type: str = ""
    node_rank: int = -1


@message
class DiagnosisAction:
    """An action the master asks the agent (or itself) to take."""

    action_cls: str = "NoAction"
    action_content: str = ""
    instance: int = -1  # target node id, -1 = any/master
    expired_ts: float = 0.0


@message
class PreCheckRequest:
    node_id: int = -1


@message
class PreCheckResponse:
    status: str = "pass"


# ---------------------------------------------------------------------------
# Autoscale / scale plan
# ---------------------------------------------------------------------------


@message
class ScalePlanMessage:
    node_group_counts: Dict = field(default_factory=dict)  # type -> count
    remove_nodes: List[int] = field(default_factory=list)
    launch_nodes: List[int] = field(default_factory=list)
