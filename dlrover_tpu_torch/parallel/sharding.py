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
``NamedSharding``'s ``devices_indices_map``.
"""

from __future__ import annotations

import itertools
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


def placements_for(spec: Spec, mesh) -> list:
    """One placement a mesh dim for ``spec`` on ``mesh``. A tensor dim
    tiled by two axes that are both above size 1 (the fsdp + dp tiling)
    has no placement here yet: it raises (ROADMAP Queue 1 item 1)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    dim_of: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        axes = [a for a in entry_axes(entry) if sizes.get(a, 1) > 1]
        if len(axes) > 1:
            raise NotImplementedError(
                f"spec {spec}: dim {dim} tiled by {axes}; nested shards "
                "come with the fsdp slice")
        for a in entry_axes(entry):
            if a not in sizes:
                raise ValueError(f"spec {spec} names axis {a!r}, not on "
                                 f"the mesh {tuple(sizes)}")
            dim_of[a] = dim
    return [Shard(dim_of[a]) if a in dim_of else Replicate()
            for a in sizes]


def spec_of(dtensor) -> Spec:
    """The canonical spec of a DTensor's placements (the inverse of
    ``placements_for``)."""
    names = dtensor.device_mesh.mesh_dim_names
    entries: List[Any] = [None] * dtensor.dim()
    for name, pl in zip(names, dtensor.placements):
        if pl.is_shard():
            d = pl.dim
            axes = entry_axes(entries[d]) + (name,)
            entries[d] = axes if len(axes) > 1 else axes[0]
    return canonical(entries)


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
    """Chunk ``i`` of ``k`` of ``extent`` as ``torch.chunk`` (and a
    ``Shard`` placement) cuts it: ceil-sized chunks, the tail short or
    empty."""
    size = -(-extent // k)
    start = min(i * size, extent)
    return start, min(start + size, extent)


def shard_regions(dtensor) -> Dict[Ranges, Tuple[int, ...]]:
    """``{region: ranks holding it}`` of a DTensor, from its mesh and
    placements: each mesh coordinate's region (``Shard`` placements cut
    in mesh-dim order), keyed by the ``(start, stop)`` ranges per tensor
    dim, with the global ranks at the coordinates that hold it."""
    mesh = dtensor.device_mesh
    ranks = mesh.mesh.tolist() if mesh.ndim else [mesh.mesh.item()]
    shape = tuple(int(d) for d in dtensor.shape)
    out: Dict[Ranges, List[int]] = {}
    for coord in itertools.product(*(range(n) for n in mesh.shape)):
        region = [(0, d) for d in shape]
        for mdim, pl in enumerate(dtensor.placements):
            if pl.is_shard():
                s, e = region[pl.dim]
                cs, ce = _chunk(e - s, mesh.shape[mdim], coord[mdim])
                region[pl.dim] = (s + cs, s + ce)
        rank = ranks
        for c in coord:
            rank = rank[c]
        out.setdefault(tuple(region), []).append(int(rank))
    return {r: tuple(sorted(v)) for r, v in out.items()}

