"""Names shared with the JAX package's processes: the port's own copy of the
part of dlrover_tpu/common/constants.py it reads.

The values are the JAX package's, so a checkpoint or a shm segment one
package writes is found by the other under the same names.
"""


class CheckpointConstant:
    MODEL_STATES_NAME = "model_states"
    TRACKER_FILE = "latest_step.txt"
    STEP_DONE_DIR = "._step_done"
    SHM_PREFIX = "dlrover_tpu_ckpt"


class NodeEnv:
    """Environment variables the agent injects into a worker, as far as the
    port's flags read them."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
