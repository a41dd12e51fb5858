"""Replica-deduplicated checkpoint ownership (port of the pure planning
functions of dlrover_tpu/checkpoint/ownership.py).

In a data-parallel group of ``world`` ranks every leaf is replicated, so
every rank used to stage and persist a full copy. Under deduplicated
staging each rank stages only the pieces it owns, and a restore reads the
union. The rules are the JAX package's, so both packages cut a leaf into
the same pieces with the same owners:

- a region held by one rank is owned by it;
- a region replicated over ``k`` ranks is split into ``k`` contiguous
  chunks along its largest dimension (ties: the first), one a rank; the
  chunk-to-rank pairing rotates by a counter per replica set, advanced in
  flatten order, so the first chunk's extra element does not always land
  on one rank;
- a region too small to split (every dimension under ``k``, a scalar) goes
  whole to the next rank of the same counter.

Every rank walks the leaves in the same order and computes the same full
assignment, with no communication, and keeps its own part of it.

The JAX package keys a leaf's regions on its ``NamedSharding``. The port
runs one process a card: a plain tensor (or a Python scalar) is replicated
over ``world``, the size of the data-parallel group, as the JAX package's
``assign_host_leaf`` and its ``assign_leaf`` for a leaf replicated on every
rank; a DTensor (zero-1's dp-sharded adam moments, train/zero1.py; fsdp's
params and moments, models/llama.py) has the regions its mesh and
placements give (``parallel.sharding.shard_regions``, the counterpart of
``devices_indices_map``, a dim tiled by two axes cut in the JAX order),
each held by the ranks at the mesh coordinates that hold it. A rank is a
process's global rank, so the JAX package's device-to-rank maps
(``virtual_proc_of``, ``real_proc_of``) have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Ranges = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class PieceAssignment:
    """One owned piece of one leaf. ``ranges`` is the piece itself;
    ``parent`` is the region it was cut from (equal to ``ranges`` for an
    unsplit piece)."""

    ranges: Ranges          # (start, stop) per dim, () for 0-d
    owner: int              # owning rank
    replicas: Tuple[int, ...]  # every rank holding parent
    parent: Optional[Ranges] = None

    @property
    def parent_ranges(self) -> Ranges:
        return self.ranges if self.parent is None else self.parent


class RoundRobin:
    """Per-replica-set round-robin counters. One instance per staging pass
    or plan; advancing it in flatten order on every rank gives the same
    assignment everywhere."""

    def __init__(self):
        self._counters: Dict[Tuple[int, ...], int] = {}

    def advance(self, replicas: Tuple[int, ...]) -> int:
        i = self._counters.get(replicas, 0)
        self._counters[replicas] = i + 1
        return i

    def next(self, replicas: Tuple[int, ...]) -> int:
        return replicas[self.advance(replicas) % len(replicas)]


def index_to_ranges(index, shape) -> Ranges:
    """A tuple of slices (an index into a leaf) as (start, stop) pairs:
    the hashable, sortable region form everything here keys on."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


def ranges_to_index(ranges: Ranges) -> Tuple[slice, ...]:
    """The inverse of ``index_to_ranges``: an index that selects a region."""
    return tuple(slice(s, e) for s, e in ranges)


def split_region(ranges: Ranges, k: int) -> Optional[List[Ranges]]:
    """Split a region into ``k`` contiguous chunks along its largest
    dimension (ties: the first). None when no dimension has extent >= k:
    callers fall back to whole-region round-robin."""
    if k <= 1 or not ranges:
        return None
    extents = [e - s for s, e in ranges]
    axis = max(range(len(extents)), key=lambda d: extents[d])
    n = extents[axis]
    if n < k:
        return None
    base, rem = divmod(n, k)
    out: List[Ranges] = []
    start = ranges[axis][0]
    for i in range(k):
        size = base + (1 if i < rem else 0)
        sub = list(ranges)
        sub[axis] = (start, start + size)
        out.append(tuple(sub))
        start += size
    return out


def _assign_replicated(
    region: Ranges, reps: Tuple[int, ...], rr: RoundRobin
) -> List[PieceAssignment]:
    """The dp-round-robin split of one replicated region: one chunk per
    replica, the chunk-to-replica pairing rotated by the replica set's
    counter; an unsplittable region goes whole to the next replica."""
    subs = split_region(region, len(reps))
    if subs is None:
        return [
            PieceAssignment(
                ranges=region, owner=rr.next(reps), replicas=reps,
                parent=region,
            )
        ]
    off = rr.advance(reps)
    return [
        PieceAssignment(
            ranges=sub, owner=reps[(i + off) % len(reps)], replicas=reps,
            parent=region,
        )
        for i, sub in enumerate(subs)
    ]


def assign_leaf(
    shape: Tuple[int, ...], world: int, rr: RoundRobin,
    regions: Optional[Dict[Ranges, Tuple[int, ...]]] = None,
) -> List[PieceAssignment]:
    """The pieces of a leaf with their owners: with ``regions`` (``{region:
    ranks holding it}``, a DTensor's), each region in sorted order, one
    held by a single rank owned by it (the counter does not advance), a
    replicated one split as below; without, a leaf replicated on every
    rank of a ``world``-rank group."""
    if regions is not None:
        out: List[PieceAssignment] = []
        for region in sorted(regions):
            reps = tuple(sorted(regions[region]))
            if len(reps) == 1:
                out.append(PieceAssignment(ranges=region, owner=reps[0],
                                           replicas=reps, parent=region))
            else:
                out.extend(_assign_replicated(region, reps, rr))
        return out
    reps = tuple(range(world))
    ranges = tuple((0, int(d)) for d in shape)
    if world == 1:
        return [
            PieceAssignment(
                ranges=ranges, owner=0, replicas=reps, parent=ranges
            )
        ]
    return _assign_replicated(ranges, reps, rr)


def leaf_layout(leaf) -> Tuple[Tuple[int, ...],
                                Optional[Dict[Ranges, Tuple[int, ...]]]]:
    """A leaf's global shape and, for a DTensor, its regions with the
    ranks holding each (None: replicated over the group). ``leaf``: a
    tensor, a numpy array, or a shape."""
    if hasattr(leaf, "device_mesh") and hasattr(leaf, "placements"):
        from dlrover_tpu_torch.parallel.sharding import shard_regions

        return tuple(int(d) for d in leaf.shape), shard_regions(leaf)
    shape = getattr(leaf, "shape", leaf)
    return tuple(int(d) for d in shape), None


def plan_for_state(leaves, world: int) -> Dict[str, List[PieceAssignment]]:
    """Full assignment keyed by leaf name, for ``(name, leaf)`` pairs in
    flatten order (``shm_handler.flatten_state`` gives them; a leaf is a
    tensor, a DTensor or a shape) over a ``world``-rank data-parallel
    group: what every rank's staging pass computes."""
    rr = RoundRobin()
    plan = {}
    for name, leaf in leaves:
        shape, regions = leaf_layout(leaf)
        plan[name] = assign_leaf(shape, world, rr, regions)
    return plan


def owned_bytes(
    plan: Dict[str, List[PieceAssignment]],
    sizes: Dict[str, Tuple[Tuple[int, ...], int]],
    rank: int,
) -> int:
    """Bytes of ``rank``'s owned pieces; ``sizes`` maps leaf path ->
    (global shape, itemsize)."""
    total = 0
    for path, assigns in plan.items():
        _, itemsize = sizes.get(path, ((), 0))
        for a in assigns:
            if a.owner != rank:
                continue
            vol = 1
            for s, e in a.ranges:
                vol *= max(0, e - s)
            total += vol * itemsize
    return total


def validate_plan(plan: Dict[str, List[PieceAssignment]]) -> None:
    """Every piece has exactly one owner, that owner is among its
    replicas, no piece is assigned twice, each piece lies inside its
    parent region, and the pieces cut from one parent tile it exactly."""
    for path, assigns in plan.items():
        by_parent: Dict[Ranges, List[PieceAssignment]] = {}
        for a in assigns:
            if a.owner not in a.replicas:
                raise AssertionError(
                    f"{path}: owner {a.owner} not a replica of {a.ranges} "
                    f"({a.replicas})"
                )
            for (s, e), (ps, pe) in zip(a.ranges, a.parent_ranges):
                if s < ps or e > pe:
                    raise AssertionError(
                        f"{path}: piece {a.ranges} outside parent "
                        f"{a.parent_ranges}"
                    )
            by_parent.setdefault(a.parent_ranges, []).append(a)
        seen = [a.ranges for a in assigns]
        if len(seen) != len(set(seen)):
            raise AssertionError(f"{path}: duplicate region assignment")

        def _vol(r: Ranges) -> int:
            v = 1
            for s, e in r:
                v *= max(0, e - s)
            return v

        for parent, group in by_parent.items():
            if parent == ():  # 0-d: one piece == the whole parent
                if len(group) != 1:
                    raise AssertionError(f"{path}: 0-d region split")
                continue
            vol = sum(_vol(a.ranges) for a in group)
            if vol != _vol(parent):
                raise AssertionError(
                    f"{path}: pieces of parent {parent} cover {vol} of "
                    f"{_vol(parent)} elements"
                )
