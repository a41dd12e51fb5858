"""Names shared with the JAX package's processes: the port's own copy of the
part of dlrover_tpu/common/constants.py it reads.

The values are the JAX package's, so a checkpoint, a shm segment, a
control-plane message or a worker's environment one package writes is read
by the other under the same names.
"""


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    CHIEF = "chief"
    PS = "ps"
    EVALUATOR = "evaluator"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"  # health-check failed
    UNKNOWN = "unknown"

    @classmethod
    def terminal(cls) -> set:
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeEventType:
    CREATED = "created"
    MODIFIED = "modified"
    DELETED = "deleted"
    ERROR = "error"


class NodeExitReason:
    """Why a node/worker process died; drives the relaunch policy."""

    SUCCEEDED = "succeeded"
    KILLED = "killed"  # external kill (e.g. pod deleted)
    OOM = "oom"
    FATAL_ERROR = "fatal_error"  # user-code error: do not relaunch
    HARDWARE_ERROR = "hardware_error"  # device/host fault: relaunch elsewhere
    PREEMPTED = "preempted"  # VM preemption: always relaunch
    UNKNOWN_ERROR = "unknown_error"

    RELAUNCHABLE = {KILLED, OOM, HARDWARE_ERROR, PREEMPTED, UNKNOWN_ERROR}


class JobExitReason:
    SUCCEEDED = "succeeded"
    NODE_CHECK_FAILED = "node_check_failed"
    PENDING_TIMEOUT = "pending_timeout"
    INSUFFICIENT_WORKER = "insufficient_worker"
    HANG = "hang"
    ERROR = "error"


class RendezvousName:
    TRAINING = "training"
    NETWORK_CHECK = "network-check"


class NetworkFailureReason:
    NO_INIT = "no_init"
    NODE_FAILURE = "node_failure"
    WAITING_NODE = "waiting_node"


class TrainingExceptionLevel:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


class CheckpointConstant:
    MODEL_STATES_NAME = "model_states"
    TRACKER_FILE = "latest_step.txt"
    STEP_DONE_DIR = "._step_done"
    SHM_PREFIX = "dlrover_tpu_ckpt"


class DefaultValues:
    # Master-side timeouts (seconds)
    SEC_HEARTBEAT_TIMEOUT = 600
    SEC_RDZV_PEND_TIMEOUT = 3600
    SEC_NODE_START_TIMEOUT = 1800
    SEC_MONITOR_INTERVAL = 5
    SEC_MASTER_JOIN_TIMEOUT = 600
    # Agent-side
    SEC_AGENT_HEARTBEAT_INTERVAL = 15
    SEC_WORKER_MONITOR_INTERVAL = 3
    MAX_NODE_RESTARTS = 3
    # OOM recovery fallback when a node had no configured memory
    MB_DEFAULT_HOST_MEMORY = 8192
    # Data sharding
    TASK_TIMEOUT_SECS = 1800
    # Speed monitor
    SPEED_SAMPLE_WINDOW = 10


class NodeEnv:
    """Environment variables wired from master/agent into workers."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    MONITOR_ENABLED = "DLROVER_TPU_MONITOR_ENABLED"


class TpuTimerConsts:
    """The device timer (profiler/tpu_timer.py, profiler/csrc/): the JAX
    package's metrics port and hang timeout."""

    DEFAULT_PORT = 18890
    DEFAULT_HANG_SECS = 300
