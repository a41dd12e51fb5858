"""ZeRO-1: weight-update sharding across the dp axis (port of
dlrover_tpu/train/zero1.py).

Under dp every rank used to hold all of adam's ``mu`` and ``nu`` and
repeat the whole update. With zero-1 on (``TrainConfig.zero1``, or the
``DLROVER_TPU_ZERO1`` flag, which overrides the knob in both directions)
at dp above 1, each step of the trainer (train/trainer.py):

- reduce-scatters each accumulated gradient leaf over the mesh's dp
  group into this rank's shard (``Layout.reduce_scatter``), where the
  replicated step all-reduces it;
- updates only this rank's shard of the params, from moments that hold
  only this rank's shard (DTensors with ``Shard(d)`` on the mesh's dp dim;
  train/optim.py works on their ``to_local()``);
- all-gathers the params in place (``Layout.all_gather_``).

The sharding rule (``partition_spec``) is the JAX package's: a leaf
partitions along its leading dim whose per-shard extent divides by dp; a
leaf with no such dim falls back to replicated (its moments stay whole and
its gradient is all-reduced); a scalar never shards. The rule is
deterministic in (spec, shape, axis sizes), so a checkpoint restore onto
another dp re-derives every layout. A spec is a tuple in the JAX
canonical form (parallel/sharding.py), so a spec compares equal across
the packages.

``mode_for`` gives ``"off"``, ``"scatter"`` (the JAX package's pure-dp
strategy) or ``"gspmd"`` (zero-1 beside fsdp, sp or tp): the params are
DTensors split over fsdp and tp (models/llama.py; whole tensors beside sp
alone, which splits the rows' positions, not the params), and the layout
works
on the shard each rank holds over the dp group, so a leaf whose
partition dim already carries fsdp or tp (the lm-head, ``(("fsdp",
"dp"), "tp")``; the embedding beside tp, ``(("tp", "dp"), "fsdp")``)
tiles it with dp minor, as JAX tiles a spec entry, and its moments'
placements are nested (parallel/sharding.py). The "scatter" mode stays
pure dp. Zero-1 beside ep, and with pp, wait for those axes' paths: such
a request raises, where the JAX package returns ``"gspmd"`` (or ``"off"``
for pp), and never silently runs replicated.

Known difference: the JAX scatter step reduce-scatters each microbatch's
gradients and averages the ranks' local loss means; the port
reduce-scatters once a step after accumulation and keeps the global token
mean of its replicated dp step (the valid-target count all-reduced first),
so the two agree exactly when each rank's rows hold as many valid targets.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.mesh import FSDP, SP, TP, axis_sizes

Spec = Tuple[Any, ...]

#: the axis the weight update shards over
ZERO1_AXIS = "dp"

__all__ = [
    "ZERO1_AXIS",
    "Layout",
    "enabled",
    "mode_for",
    "spec_has_dp",
    "strip_spec",
    "partition_spec",
    "scatter_dim",
]


def spec_has_dp(spec) -> bool:
    """Whether any entry of a spec names the dp axis, i.e. the leaf
    carries a zero-1 layout."""
    return any(ZERO1_AXIS in sharding.entry_axes(e) for e in spec)


def enabled(train_config) -> bool:
    """Effective zero-1 setting: the ``DLROVER_TPU_ZERO1`` env flag when
    set (``0`` = off, anything else = on), else ``TrainConfig.zero1``."""
    if flags.ZERO1.present():
        return flags.ZERO1.get() != "0"
    return bool(getattr(train_config, "zero1", False))


def mode_for(mesh, train_config) -> str:
    """``"off"``, ``"scatter"`` or ``"gspmd"`` for a trainer on ``mesh``
    (a ``DeviceMesh``, a ``MeshConfig`` or ``{axis: size}``; None is a
    world of one). Off when zero-1 is not enabled or dp is 1; scatter on a
    pure-dp mesh; gspmd where fsdp, sp or tp are the other axes above 1,
    as the JAX package gives it on mixed meshes; a mesh with ep or pp
    above 1 raises (the MoE layers and the pipeline schedules are not
    ported)."""
    if not enabled(train_config) or mesh is None:
        return "off"
    sizes = axis_sizes(mesh)
    if sizes.get(ZERO1_AXIS, 1) <= 1:
        return "off"
    mixed = {a: s for a, s in sizes.items()
             if a not in (ZERO1_AXIS, FSDP, SP, TP) and s > 1}
    if mixed:
        raise ValueError(
            f"zero-1 on a mesh with {mixed} beside dp={sizes[ZERO1_AXIS]}: "
            "only pure dp (the JAX package's \"scatter\" mode) and dp with "
            "fsdp, sp or tp (\"gspmd\") are ported; ep and pp are not")
    if any(sizes.get(a, 1) > 1 for a in (FSDP, SP, TP)):
        return "gspmd"
    return "scatter"


def strip_spec(spec) -> Spec:
    """Remove ``dp`` from every entry of a spec: the inverse of
    ``partition_spec``, so a zero-1 spec round-trips to the params' base
    spec."""
    out: List[Any] = []
    for entry in spec:
        axes = tuple(a for a in sharding.entry_axes(entry)
                     if a != ZERO1_AXIS)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return sharding.canonical(out)


def partition_spec(spec, shape, axis_sizes: Dict[str, int]
                   ) -> Optional[Spec]:
    """The zero-1 spec for one state leaf: ``spec`` with ``dp`` appended
    to the leading dim whose per-shard extent divides by dp. None when no
    dim qualifies (the replicated fallback) or the leaf is a scalar.
    Idempotent: a spec already carrying dp is returned unchanged."""
    dp = axis_sizes.get(ZERO1_AXIS, 1)
    if dp <= 1 or not shape:
        return None
    spec = tuple(spec)
    if spec_has_dp(spec):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, entry in enumerate(entries):
        axes = sharding.entry_axes(entry)
        div = 1
        for a in axes:
            div *= axis_sizes.get(a, 1)
        # the per-shard extent shape[dim]/div must split dp ways exactly;
        # the >0 guard keeps zero-sized dims out (0 % n == 0)
        if shape[dim] > 0 and shape[dim] % (div * dp) == 0:
            new_axes = axes + (ZERO1_AXIS,)
            entries[dim] = new_axes if len(new_axes) > 1 else new_axes[0]
            return sharding.canonical(entries)
    return None


def scatter_dim(spec, shape, axis_sizes: Dict[str, int]) -> Optional[int]:
    """Which dim ``partition_spec`` puts ``dp`` on; None when the leaf
    falls back to replicated."""
    z = partition_spec(spec, shape, axis_sizes)
    if z is None:
        return None
    for dim, entry in enumerate(z):
        if ZERO1_AXIS in sharding.entry_axes(entry):
            return dim
    return None


@dataclasses.dataclass
class Layout:
    """The zero-1 layout of a param tree over the mesh's dp group: each
    leaf's scatter dim (None for the replicated fallback) and the
    collectives that move a leaf between this rank's params and its dp
    shard. A param is whole on a pure-dp mesh (``"scatter"``) and this
    rank's fsdp shard, a DTensor, beside fsdp (``"gspmd"``); either way
    the dp split runs on the tensor the rank holds. ``rank`` is this
    process's dp coordinate."""

    mesh: Any
    dp: int
    rank: int
    #: leaf path -> (scatter dim or None, zero-1 spec or None)
    leaves: Dict[str, Tuple[Optional[int], Optional[Spec]]]

    @classmethod
    def build(cls, mesh, named: List[Tuple[str, torch.Tensor]]) -> "Layout":
        sizes = axis_sizes(mesh)
        leaves = {}
        for path, p in named:
            shape = tuple(p.shape)
            spec = sharding.spec_of(p) if hasattr(p, "to_local") else ()
            leaves[path] = (scatter_dim(spec, shape, sizes),
                            partition_spec(spec, shape, sizes))
        return cls(mesh=mesh, dp=sizes[ZERO1_AXIS],
                   rank=mesh.get_local_rank(ZERO1_AXIS), leaves=leaves)

    @property
    def group(self):
        return self.mesh.get_group(ZERO1_AXIS)

    def dim(self, path: str) -> Optional[int]:
        return self.leaves[path][0]

    def shard(self, path: str, held: torch.Tensor) -> torch.Tensor:
        """This rank's dp shard of the tensor it holds of a leaf (the
        whole leaf, or its fsdp shard), as a view of it (the tensor
        itself for a fallback)."""
        d = self.dim(path)
        if d is None:
            return held
        k = held.shape[d] // self.dp
        return held.narrow(d, self.rank * k, k)

    def zeros(self, path: str, p: torch.Tensor):
        """A zero moment for param ``p``: a DTensor holding this rank's
        shard on the zero-1 spec, or, for a fallback, zeros laid out as
        ``p`` (a DTensor stays one)."""
        d, spec = self.leaves[path]
        if d is None:
            return torch.zeros_like(p)
        local = torch.zeros_like(self.shard(path, sharding.local_of(p)),
                                 memory_format=torch.contiguous_format)
        return sharding.from_local(local, self.mesh, spec)

    @torch.no_grad()
    def reduce_scatter(self, path: str, held: torch.Tensor) -> torch.Tensor:
        """The dp sum of a gradient leaf (the tensor this rank holds of
        it), this rank's shard of it (laid out as the moment's local
        shard); a fallback leaf is all-reduced whole."""
        import torch.distributed as dist

        d = self.dim(path)
        if d is None:
            dist.all_reduce(held, group=self.group)
            return held
        # the scatter runs over a contiguous leading dim: NCCL takes a dense
        # strided tensor (the gradient of an fsdp gather along dim 1, as
        # the embedding's) and cuts it in storage order
        src = held.movedim(d, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.dp,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=self.group)
        return out if d == 0 else out.movedim(0, d)

    @torch.no_grad()
    def all_gather_(self, path: str, param: torch.Tensor) -> None:
        """Gather every dp rank's updated shard into ``param`` (the tensor
        this rank holds of it, a DTensor's local shard), in place: on dim
        0 the input is a view of the output's own chunk; on another dim
        through a leading-dim buffer and back."""
        import torch.distributed as dist

        d = self.dim(path)
        if d is None:
            return
        param = sharding.local_of(param)
        if d == 0 and param.is_contiguous():
            dist.all_gather_into_tensor(param, self.shard(path, param),
                                        group=self.group)
            return
        moved = param.movedim(d, 0)
        k = moved.shape[0] // self.dp
        buf = torch.empty(moved.shape, dtype=param.dtype,
                          device=param.device)
        chunk = buf.narrow(0, self.rank * k, k)
        chunk.copy_(moved.narrow(0, self.rank * k, k))
        dist.all_gather_into_tensor(buf, chunk, group=self.group)
        moved.copy_(buf)
