"""Flash checkpoint: the training process's side (port of
dlrover_tpu/checkpoint/)."""
