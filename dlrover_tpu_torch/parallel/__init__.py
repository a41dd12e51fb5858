"""Parallelism layer: device meshes and sharding rules (port of
dlrover_tpu/parallel/).

One ``DeviceMesh`` with the JAX package's dp/pp/fsdp/ep/sp/tp axes over
the default process group, specs in the JAX canonical form, and DTensor
placements built from them.
"""

from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    BATCH_AXES,
    DP,
    EP,
    FSDP,
    PP,
    SP,
    TP,
    MeshConfig,
    axes_group,
    axis_sizes,
    build_mesh,
    check_ported_axes,
    config_for,
    data_parallel,
    mesh_for,
    remesh,
    sp_group,
    sp_index,
    sp_size,
    tp_group,
    tp_index,
    tp_size,
    validate_divisibility,
)
from dlrover_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_spec,
    from_local,
    local_of,
    local_region,
    named_placements,
    pad_batch_to,
    place_local,
    placements_for,
    region_at,
    shard_pytree,
    shard_regions,
    spec_for_resize,
    spec_of,
    with_constraints,
)
