"""Device-mesh construction (port of dlrover_tpu/parallel/mesh.py).

The mesh is the world: every parallel strategy is an axis of one
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group's ranks, one rank a card. The axis names and their order are the
JAX package's, outermost first::

    dp    pure data parallelism (gradient reduction)
    pp    pipeline parallelism (layer stages)
    fsdp  data parallelism with parameter/optimizer sharding
    ep    expert parallelism for MoE layers
    sp    sequence/context parallelism
    tp    tensor parallelism (innermost)

Every mesh has all six dims, most of them of size 1, so a spec or a
placement names the same axis in both packages. Ranks fill the mesh in
row-major order, as ``np.array(devices).reshape(shape)`` fills the JAX
mesh on a plain device list, so on a pure-dp mesh rank ``r`` is dp index
``r``.

Not ported here: the multislice layout (``_build_multislice_mesh`` and
``mesh_slice_of*``), which waits for the hierarchical collectives
(``ops/hier_collectives.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

# Canonical axis names, outermost first.
DP = "dp"
PP = "pp"
FSDP = "fsdp"
EP = "ep"
SP = "sp"
TP = "tp"
AXIS_ORDER = (DP, PP, FSDP, EP, SP, TP)

# Axes over which a data batch is split (sharding of the batch dimension).
BATCH_AXES = (DP, FSDP, EP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``-1`` for dp means "absorb remaining devices"
    so the same config survives elastic resizes: tp/sp/ep/fsdp are model
    properties, dp is whatever the current world provides."""

    dp: int = -1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        fixed = self.pp * self.fsdp * self.ep * self.sp * self.tp
        if self.dp == -1:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"pp*fsdp*ep*sp*tp={fixed}"
                )
            return dataclasses.replace(self, dp=n_devices // fixed)
        if self.dp * fixed != n_devices:
            raise ValueError(
                f"mesh {self.shape()} wants {self.dp * fixed} devices, "
                f"got {n_devices}"
            )
        return self

    def shape(self) -> dict:
        return {
            DP: self.dp,
            PP: self.pp,
            FSDP: self.fsdp,
            EP: self.ep,
            SP: self.sp,
            TP: self.tp,
        }

    @property
    def data_parallel_size(self) -> int:
        """Number of independent batch shards (for global-batch math)."""
        return self.dp * self.fsdp * self.ep

    @staticmethod
    def auto(
        n_devices: int,
        tp: int = 1,
        sp: int = 1,
        ep: int = 1,
        pp: int = 1,
        prefer_fsdp: bool = True,
    ) -> "MeshConfig":
        """Pick a mesh for ``n_devices``: model axes given, the data axes
        inferred. With ``prefer_fsdp`` the whole data dimension is fsdp
        (ZeRO-style, the usual choice for large models); otherwise pure dp."""
        model = tp * sp * ep * pp
        if n_devices % model:
            raise ValueError(
                f"{n_devices} devices not divisible by tp*sp*ep*pp={model}"
            )
        data = n_devices // model
        if prefer_fsdp:
            return MeshConfig(dp=1, pp=pp, fsdp=data, ep=ep, sp=sp, tp=tp)
        return MeshConfig(dp=data, pp=pp, fsdp=1, ep=ep, sp=sp, tp=tp)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    beside its ``shape``, a tuple of ints), a ``MeshConfig``, or a mapping
    of names to sizes."""
    if isinstance(mesh, MeshConfig):
        return mesh.shape()
    if isinstance(mesh, Mapping):
        return {str(a): int(s) for a, s in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError(f"mesh {mesh!r} has no axis names")
    return {str(a): int(s) for a, s in zip(names, mesh.shape)}


def data_parallel(mesh) -> Tuple[int, int]:
    """``(index, size)`` of this rank over the batch axes of a
    ``DeviceMesh`` (``BATCH_AXES``, major first): which block of a global
    batch's rows it trains, as JAX's ``P(BATCH_AXES)`` tiles the batch
    dim over dp, then fsdp, then ep."""
    sizes = axis_sizes(mesh)
    index, size = 0, 1
    for a in BATCH_AXES:
        index = index * sizes.get(a, 1) + (
            mesh.get_local_rank(a) if a in sizes else 0)
        size *= sizes.get(a, 1)
    return index, size


def check_ported_axes(mesh) -> None:
    """Raise on a mesh axis whose path the port does not have yet: it
    trains dp, fsdp, sp and tp; ep (the MoE layers, ``models/moe.py``) and
    pp (the pipeline schedules, ``parallel/pp_schedule.py``) above 1 raise
    rather than run replicated."""
    sizes = axis_sizes(mesh)
    later = {a: sizes[a] for a in (PP, EP) if sizes.get(a, 1) > 1}
    if later:
        raise ValueError(
            f"mesh axes {later}: ep and pp are not ported yet; the port "
            "trains dp, fsdp, sp and tp")


def tp_size(mesh) -> int:
    """The size of the mesh's tp axis (1 without a mesh)."""
    return 1 if mesh is None else axis_sizes(mesh).get(TP, 1)


def tp_index(mesh) -> int:
    """This rank's coordinate on the tp axis: which contiguous block of
    heads, ffn columns and vocab rows it holds (0 at tp 1, where a mesh
    may be a ``MeshConfig`` or a mapping)."""
    return mesh.get_local_rank(TP) if tp_size(mesh) > 1 else 0


def tp_group(mesh):
    """The process group of this rank's tp ranks (``get_group("tp")``)."""
    return mesh.get_group(TP)


def sp_size(mesh) -> int:
    """The size of the mesh's sp axis (1 without a mesh)."""
    return 1 if mesh is None else axis_sizes(mesh).get(SP, 1)


def sp_index(mesh) -> int:
    """This rank's coordinate on the sp axis: which contiguous chunk of
    ``s/sp`` positions of every row it holds (0 at sp 1, where a mesh may
    be a ``MeshConfig`` or a mapping)."""
    return mesh.get_local_rank(SP) if sp_size(mesh) > 1 else 0


def sp_group(mesh):
    """The process group of this rank's sp ranks (``get_group("sp")``), in
    sp order: group rank ``i`` holds chunk ``i``."""
    return mesh.get_group(SP)


#: (mesh, live axes) -> the process group over them (``axes_group``)
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[object, object]] = {}


def axes_group(mesh, axes):
    """The process group over the mesh axes ``axes``: the ranks that share
    every other coordinate with this one. Axes of size 1 are dropped; one
    axis above 1 is the mesh's group of it; every axis above 1 of the mesh
    is the default group (None); any other set is a group of its own,
    built on first use (``dist.new_group`` for each such group of the
    mesh, in one order on every rank, so every rank must ask for the same
    sets in the same order) and kept for the mesh's life. No axis above 1
    raises: a reduction over one rank is a caller's fault."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    live = tuple(a for a in names if a in axes and sizes[a] > 1)
    if not live:
        raise ValueError(f"no axis of {tuple(axes)} is above size 1 on the "
                         f"mesh {sizes}")
    if live == tuple(a for a in names if sizes[a] > 1):
        return None
    if len(live) == 1:
        return mesh.get_group(live[0])
    key = (id(mesh), live)
    if key in _GROUPS and _GROUPS[key][0] is mesh:
        return _GROUPS[key][1]
    import torch.distributed as dist

    ranks = mesh.mesh
    order = ([i for i, a in enumerate(names) if a not in live]
             + [names.index(a) for a in live])
    rows = ranks.permute(order).reshape(
        -1, math.prod(sizes[a] for a in live)).tolist()
    me = dist.get_rank()
    mine = None
    for row in rows:
        group = dist.new_group(sorted(row))
        if me in row:
            mine = group
    _GROUPS[key] = (mesh, mine)
    return mine


def build_mesh(config: MeshConfig, device_type: str = "cuda",
               n_devices: int = 0):
    """The ``DeviceMesh`` of ``config`` over the default process group's
    ranks (``n_devices``: its world size when 0), all six axes in
    ``AXIS_ORDER``. ``device_type`` is ``"cuda"`` unless the caller asks
    for ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    from dlrover_tpu_torch.train import bootstrap

    config = config.resolve(n_devices or bootstrap.process_count())
    shape = tuple(config.shape()[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def config_for(world) -> MeshConfig:
    """The :class:`MeshConfig` a
    :class:`~dlrover_tpu_torch.common.world.WorldDescriptor` describes,
    fully resolved (no ``-1`` dp). The inverse of
    ``WorldDescriptor.from_axis_sizes(cfg.shape())``."""
    sizes = world.axis_sizes()
    cfg = MeshConfig(**{a: sizes.get(a, 1) for a in AXIS_ORDER})
    return cfg.resolve(world.world_size)


def mesh_for(world, device_type: str = "cuda"):
    """Build the mesh a WorldDescriptor describes over the default process
    group and check the result against it: the one descriptor-to-mesh
    path. A multislice world, or a world the process group does not hold,
    raises."""
    from dlrover_tpu_torch.train import bootstrap

    if world.n_slices > 1:
        raise ValueError(
            f"{world.spec}: multislice meshes are not ported yet "
            "(they wait for ops/hier_collectives.py)")
    n = bootstrap.process_count()
    if n != world.world_size:
        raise ValueError(
            f"{world.spec} needs {world.world_size} processes; the process "
            f"group has {n}")
    mesh = build_mesh(config_for(world), device_type, n)
    world.check_mesh(mesh)
    return mesh


def remesh(config: MeshConfig, n_devices: int) -> MeshConfig:
    """Re-fit a mesh config after an elastic membership change.

    Model axes (tp/sp/ep/pp) are preserved: they are baked into checkpoint
    layouts and kernel choices. The data axes absorb the new world size,
    keeping the fsdp:dp preference of the original config. Raises if the
    new world cannot host the model axes at all."""
    model = config.tp * config.sp * config.ep * config.pp
    if n_devices % model:
        raise ValueError(
            f"cannot remesh: {n_devices} devices vs model axes {model}"
        )
    data = n_devices // model
    if config.fsdp > 1 and config.dp > 1:
        # keep fsdp fixed if possible, scale dp
        if data % config.fsdp == 0:
            return dataclasses.replace(
                config, dp=data // config.fsdp
            )
        # else collapse to fsdp-only
        return dataclasses.replace(config, dp=1, fsdp=data)
    if config.fsdp > 1 or (config.dp == 1 and config.fsdp == 1):
        return dataclasses.replace(config, dp=1, fsdp=data)
    return dataclasses.replace(config, dp=data, fsdp=1)


def validate_divisibility(config: MeshConfig, *, n_heads: int,
                          n_kv_heads: int, seq_len: int, vocab: int,
                          n_layers: int = 0) -> None:
    """Fail fast (before the first step) on shape/mesh mismatches."""
    if n_layers and n_layers % max(config.pp, 1):
        raise ValueError(
            f"n_layers={n_layers} not divisible by pp={config.pp}"
        )
    if n_heads % config.tp:
        raise ValueError(f"n_heads={n_heads} not divisible by tp={config.tp}")
    if n_kv_heads % config.tp:
        raise ValueError(
            f"n_kv_heads={n_kv_heads} not divisible by tp={config.tp} "
            "(kv-head replication across tp is not supported)"
        )
    if seq_len % max(config.sp, 1):
        raise ValueError(f"seq_len={seq_len} not divisible by sp={config.sp}")
    if vocab % max(config.tp, 1):
        raise ValueError(f"vocab={vocab} not divisible by tp={config.tp}")
