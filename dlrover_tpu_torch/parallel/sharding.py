"""Sharding helpers: specs, placements and DTensors (port of
dlrover_tpu/parallel/sharding.py).

A spec is the JAX package's ``PartitionSpec`` as a plain tuple: one entry
per leading tensor dim, each ``None``, an axis name or a tuple of axis
names, with no trailing ``None`` (the canonical form), so ``tuple(P(...))``
of a JAX spec compares equal to the port's. On a ``DeviceMesh`` a spec
becomes one placement a mesh dim: ``Shard(d)`` where the spec puts that
axis on tensor dim ``d``, ``Replicate()`` elsewhere. The JAX
``named_shardings``, ``shard_pytree`` and ``with_constraints`` become
``named_placements``, ``shard_pytree`` (``distribute_tensor``) and
``with_constraints`` (``redistribute``) on nested-dict trees.

``shard_regions`` reads back, from a DTensor's own mesh and placements,
which ranks hold which region of the global tensor: what the checkpoint's
ownership plan and restore key on, as the JAX package keys them on a
``NamedSharding``'s ``devices_indices_map``. A dim tiled by two axes cuts
in the JAX order, major first (``placements_for``), and
``place_local`` cuts a whole tensor every rank holds into its DTensor
with no communication (fsdp params born sharded, weights from numpy).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.common.tree import map_tree
from dlrover_tpu_torch.parallel.mesh import BATCH_AXES, SP, axis_sizes

Spec = Tuple[Any, ...]
Ranges = Tuple[Tuple[int, int], ...]


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def canonical(entries: Sequence) -> Spec:
    """A spec without trailing ``None`` entries."""
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_spec(shard_sequence: bool = False) -> Spec:
    """The spec of a (batch, seq, ...) input batch: the batch dim over all
    data axes; the sequence dim over sp when sequence parallelism is on."""
    if shard_sequence:
        return (BATCH_AXES, SP)
    return (BATCH_AXES,)


def pad_batch_to(batch, multiple: int):
    """Pad the leading dim of every leaf (a tensor, or a tuple, list or
    dict of them) up to ``multiple``. Integer leaves (token ids) pad with
    -1, the loss-mask sentinel every model's loss ignores, so fake rows
    contribute no gradient; float leaves pad with 0."""
    if isinstance(batch, dict):
        return {k: pad_batch_to(v, multiple) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(pad_batch_to(b, multiple) for b in batch)
    rem = (-batch.shape[0]) % multiple
    if rem == 0:
        return batch
    fill = 0 if batch.is_floating_point() else -1
    pad = batch.new_full((rem,) + tuple(batch.shape[1:]), fill)
    return torch.cat([batch, pad])


def spec_for_resize(spec: Spec, mesh, shape: Sequence[int], *,
                    keep: Optional[set] = None) -> Spec:
    """Drop mesh axes from a spec that no longer divide the array shape:
    used when restoring a checkpoint onto a smaller or odd-shaped mesh."""
    sizes = axis_sizes(mesh)
    keep = keep or set(sizes)
    out: List[Any] = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(
            a for a in entry_axes(entry)
            if a in keep and shape[dim] % sizes[a] == 0
        )
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def _strided(dim: int, split_factor: int):
    """DTensor's right-to-left shard of tensor dim ``dim``, after
    ``split_factor`` shards of it by an inner mesh dim (torch's private
    ``_StridedShard``, the same constructor and ``split_factor`` in torch
    2.11 and 2.13; in neither is it a ``Shard``)."""
    from torch.distributed.tensor.placement_types import _StridedShard

    return _StridedShard(dim, split_factor=split_factor)


def _split_factor(pl) -> Optional[int]:
    """The split factor of a ``_StridedShard``; None for any other
    placement."""
    if type(pl).__name__ != "_StridedShard":
        return None
    return int(pl.split_factor)


def placements_for(spec: Spec, mesh) -> list:
    """One placement a mesh dim for ``spec`` on ``mesh``: ``Shard(d)``
    for an axis above size 1 that the spec puts on tensor dim ``d``,
    ``Replicate()`` for the others (an axis of size 1 carries no layout).

    A dim tiled by two axes above size 1 cuts in the spec's order, major
    first, as JAX tiles a ``PartitionSpec`` entry. In mesh order that is
    DTensor's default; in the other order (the zero-1 ``("fsdp", "dp")``
    of a leaf whose dim 0 already carries fsdp: block ``fsdp_idx * dp +
    dp_idx``) the outer mesh axis gets a ``_StridedShard`` whose split
    factor is the inner axis's size. A dim tiled by three axes above
    size 1 raises."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    order = list(sizes)
    out: Dict[str, Any] = {}
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a not in sizes:
                raise ValueError(f"spec {spec} names axis {a!r}, not on "
                                 f"the mesh {tuple(sizes)}")
        live = [a for a in entry_axes(entry) if sizes[a] > 1]
        if len(live) > 2:
            raise NotImplementedError(
                f"spec {spec}: dim {dim} tiled by {live}; at most two "
                "axes above size 1 tile one dim")
        if len(live) == 2 and order.index(live[0]) > order.index(live[1]):
            inner, outer = live
            out[inner] = Shard(dim)
            out[outer] = _strided(dim, sizes[inner])
            continue
        for a in live:
            out[a] = Shard(dim)
    return [out.get(a, Replicate()) for a in sizes]


def spec_of(dtensor) -> Spec:
    """The canonical spec of a DTensor's placements (the inverse of
    ``placements_for`` over the axes above size 1): each dim's axes in
    the order JAX tiles it, a ``_StridedShard``'s axis after the inner
    axis it splits."""
    mesh = dtensor.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    plain: List[List[str]] = [[] for _ in range(dtensor.dim())]
    strided: List[List[str]] = [[] for _ in range(dtensor.dim())]
    for name, pl in zip(names, dtensor.placements):
        sf = _split_factor(pl)
        if sf is not None:
            strided[pl.dim].append((name, sf))
        elif pl.is_shard() and sizes[name] > 1:
            plain[pl.dim].append(name)
    entries: List[Any] = []
    for d in range(dtensor.dim()):
        axes = list(plain[d])
        for name, sf in strided[d]:
            inner = math.prod(sizes[a] for a in axes)
            if sf != inner:
                raise NotImplementedError(
                    f"dim {d}: _StridedShard({name}, split_factor={sf}) "
                    f"after axes {axes} of {inner} shards")
            axes.append(name)
        entries.append(None if not axes else
                       axes[0] if len(axes) == 1 else tuple(axes))
    return canonical(entries)


def local_of(t: torch.Tensor) -> torch.Tensor:
    """What this rank holds of a tensor: a DTensor's local shard (a view,
    differentiable under autograd), any other tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def from_local(local: torch.Tensor, mesh, spec: Spec):
    """A DTensor whose shard on this rank is ``local``, placed per
    ``spec``, with no communication; the shards are even, so the global
    shape is ``local``'s times the mesh's size on each sharded dim."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements_for(spec, mesh),
                              run_check=False)


def named_placements(mesh, specs):
    """A tree of specs as a tree of placement lists on ``mesh``."""
    return map_tree(lambda s: placements_for(s, mesh), specs)


def shard_pytree(mesh, specs, tree):
    """Place every tensor of ``tree`` on ``mesh`` per ``specs``
    (``distribute_tensor``: each rank passes the whole tensor and keeps
    its shard)."""
    from torch.distributed.tensor import distribute_tensor

    def put(pair):
        t, s = pair
        return distribute_tensor(t, mesh, placements_for(s, mesh))

    return map_tree(put, _zip_trees(tree, specs))


def with_constraints(tree, specs):
    """``redistribute`` every DTensor of ``tree`` to its spec on its own
    mesh (a no-op where it already is)."""

    def put(pair):
        t, s = pair
        return t.redistribute(t.device_mesh,
                              placements_for(s, t.device_mesh))

    return map_tree(put, _zip_trees(tree, specs))


def _zip_trees(tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_trees(v, specs[k]) for k, v in tree.items()}
    return (tree, specs)


def _chunk(extent: int, k: int, i: int) -> Tuple[int, int]:
    """Chunk ``i`` of ``k`` of ``extent``: ceil-sized chunks, the tail
    short or empty, as JAX's ``devices_indices_map`` and ``torch.chunk``
    cut a dim."""
    size = -(-extent // k)
    start = min(i * size, extent)
    return start, min(start + size, extent)


def region_at(spec: Spec, shape: Sequence[int], sizes: Dict[str, int],
              coord: Dict[str, int]) -> Ranges:
    """The region of a tensor of ``shape`` that the mesh coordinate
    ``coord`` (``{axis: index}``) holds under ``spec``: on each dim the
    block whose index is the coordinate's mixed-radix number over that
    dim's axes, major first, as JAX's ``devices_indices_map`` cuts it."""
    region = []
    for dim, extent in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        block, n = 0, 1
        for a in entry_axes(entry):
            block = block * sizes[a] + coord[a]
            n *= sizes[a]
        region.append(_chunk(int(extent), n, block))
    return tuple(region)


def local_region(mesh, spec: Spec, shape: Sequence[int]) -> Ranges:
    """This rank's region of a tensor of ``shape`` placed per ``spec`` on
    ``mesh``."""
    sizes = axis_sizes(mesh)
    coord = {a: mesh.get_local_rank(a) for a in sizes}
    return region_at(spec, shape, sizes, coord)


def place_local(full: torch.Tensor, mesh, spec: Spec):
    """A DTensor placed per ``spec`` from a whole tensor every rank holds,
    with no communication: this rank keeps a contiguous copy of its
    region. Every sharded dim must divide evenly."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if full.shape[dim] % n:
            raise ValueError(
                f"spec {spec}: dim {dim} of {tuple(full.shape)} does not "
                f"split {n} ways evenly")
    index = tuple(slice(s, e) for s, e in local_region(mesh, spec,
                                                        full.shape))
    return from_local(full[index].contiguous(), mesh, spec)


def shard_regions(dtensor) -> Dict[Ranges, Tuple[int, ...]]:
    """``{region: ranks holding it}`` of a DTensor, from its mesh and
    placements (read back as a spec, ``spec_of``): each mesh coordinate's
    region, keyed by the ``(start, stop)`` ranges per tensor dim, with
    the global ranks at the coordinates that hold it."""
    mesh = dtensor.device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    spec = spec_of(dtensor)
    ranks = mesh.mesh.reshape(-1).tolist()
    shape = tuple(int(d) for d in dtensor.shape)
    out: Dict[Ranges, List[int]] = {}
    for rank, coord in zip(ranks, itertools.product(
            *(range(n) for n in mesh.shape))):
        region = region_at(spec, shape, sizes, dict(zip(names, coord)))
        out.setdefault(region, []).append(int(rank))
    return {r: tuple(sorted(v)) for r, v in out.items()}
