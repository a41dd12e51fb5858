"""Flash checkpoint (port of dlrover_tpu/checkpoint/): the training
process's engine and facade, and the agent's saver."""
from dlrover_tpu_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine  # noqa: F401
from dlrover_tpu_torch.checkpoint.saver import (  # noqa: F401
    AsyncCheckpointSaver,
    CheckpointPersister,
)
