"""``WorldDescriptor``: the one checked vocabulary for "a world". The
port's own copy of dlrover_tpu/common/world.py.

A candidate world is **mesh axes x n_slices x zero1/hier program modes**,
validated at construction, with the contract-spec grammar
(``"dp4+2slice+zero1"``) as its canonical serialization. The goodput
planner (brain/planner.py) scores candidate worlds in this vocabulary and
publishes its speculation hint in it; the trainer's
``set_speculation_hint`` reads it back. The axis names are the JAX
package's (``CANONICAL_AXES``), so a spec means the same world in both
packages and the planner's ledger crosses between them.

Stdlib only: the master process scores candidate worlds without an
accelerator runtime.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

#: canonical mesh-axis order (the JAX package's ``parallel.mesh.AXIS_ORDER``;
#: master-side consumers stay free of any accelerator runtime)
CANONICAL_AXES = ("dp", "pp", "fsdp", "ep", "sp", "tp")

#: contract-spec suffix for the zero-1 weight-update-sharding program
#: variant (docs/design/zero1.md)
ZERO1_SUFFIX = "+zero1"

#: ``+overlap`` marks the latency-hiding bucketed schedule of the
#: hierarchical reduction (the DCN leg of microbatch N rides behind
#: the backward of microbatch N+1) — a genuinely different program
#: with its own census/overlap contract
OVERLAP_SUFFIX = "+overlap"

#: ``+Nslice`` marks the HIERARCHICAL multislice program variant
#: (docs/design/hier_collectives.md); a multislice mesh running the
#: flat path keys the plain spec — its program is the single-slice one
_SLICE_SUFFIX_RE = re.compile(r"\+([0-9]+)slice$")


@dataclasses.dataclass(frozen=True)
class WorldDescriptor:
    """One candidate world, fully described and validated.

    ``axes``: canonical-order ``(name, size)`` pairs — the resolved
    logical mesh shape. ``n_slices``: slices the world spans
    (slices are atomic resize units; ``dp`` is the only axis allowed to
    cross DCN). ``hier``: the ICI-first hierarchical gradient-reduction
    program variant is active (requires ``n_slices > 1``). ``zero1``:
    weight-update sharding over dp is active. The contract-spec string
    (``spec``) is the canonical serialization — also the wire form of
    the planner's speculation hint."""

    axes: Tuple[Tuple[str, int], ...]
    n_slices: int = 1
    zero1: bool = False
    hier: bool = False
    #: the hierarchical reduction runs the bucketed, overlap-scheduled
    #: pipeline (DCN exchange of microbatch N behind the backward of
    #: microbatch N+1) — requires ``hier``
    overlap: bool = False

    def __post_init__(self):
        if not self.axes:
            raise ValueError("WorldDescriptor needs at least one axis")
        seen = set()
        for name, size in self.axes:
            if name not in CANONICAL_AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r}; one of {CANONICAL_AXES}"
                )
            if name in seen:
                raise ValueError(f"duplicate mesh axis {name!r}")
            seen.add(name)
            if int(size) < 1:
                raise ValueError(f"axis {name} has size {size} < 1")
        order = [a for a, _ in self.axes]
        canon = [a for a in CANONICAL_AXES if a in seen]
        if order != canon:
            raise ValueError(
                f"axes {order} not in canonical order {canon}"
            )
        if self.n_slices < 1:
            raise ValueError(f"n_slices={self.n_slices} < 1")
        if self.n_slices > 1:
            sizes = self.axis_sizes()
            dp = sizes.get("dp", 1)
            pp = sizes.get("pp", 1)
            if dp % self.n_slices and pp % self.n_slices:
                raise ValueError(
                    f"neither dp={dp} nor pp={pp} decomposes over "
                    f"{self.n_slices} slices (dp and pp are the only "
                    "axes allowed to span DCN; dp spans when it can, "
                    "else whole pp stages are pinned per slice)"
                )
        if self.hier and self.n_slices <= 1:
            raise ValueError(
                "hier (ICI-first hierarchical reduction) needs "
                "n_slices > 1"
            )
        if self.overlap and not self.hier:
            raise ValueError(
                "overlap (latency-hiding DCN schedule) is a schedule "
                "OF the hierarchical reduction — it needs hier"
            )

    # -- derived shape ---------------------------------------------------

    @property
    def world_size(self) -> int:
        n = 1
        for _, size in self.axes:
            n *= size
        return n

    @property
    def dp(self) -> int:
        return self.axis_sizes().get("dp", 1)

    @property
    def dp_in(self) -> int:
        """In-slice dp width — the ICI half of the hierarchical
        decomposition (``dp = n_slices x dp_in``). When pp spans the
        slices instead, all of dp is in-slice."""
        if self.pp_spans_slices:
            return self.dp
        return self.dp // self.n_slices

    @property
    def per_slice(self) -> int:
        return self.world_size // self.n_slices

    def axis_sizes(self) -> Dict[str, int]:
        return dict(self.axes)

    # -- the stage map -----------------------------------------------------

    @property
    def pp(self) -> int:
        return self.axis_sizes().get("pp", 1)

    @property
    def pp_spans_slices(self) -> bool:
        """Whether the pp axis is the one crossing DCN: canonical rule
        is dp spans when it decomposes over the slices, else whole pp
        stages are pinned to slices — so every spec names exactly one
        placement and ``pp2+2slice`` is unambiguous."""
        return self.n_slices > 1 and self.dp % self.n_slices != 0

    @property
    def per_stage(self) -> int:
        """Devices holding one pipeline stage (the per-stage reshard
        unit live_reshard moves and warm_compile signs)."""
        return self.world_size // self.pp

    def stage_map(self) -> Tuple[Tuple[int, ...], ...]:
        """Stage placement over slices: entry ``s`` is the tuple of
        slice indices holding stage ``s``. dp-spanning (and single
        slice) worlds replicate every stage across all slices;
        pp-spanning worlds pin ``pp / n_slices`` contiguous stages per
        slice. Canonical (derived, never stored) so contract specs,
        transfer targets and AOT signatures can never disagree on it."""
        if self.pp_spans_slices:
            per = self.pp // self.n_slices
            return tuple((s // per,) for s in range(self.pp))
        all_slices = tuple(range(self.n_slices))
        return tuple(all_slices for _ in range(self.pp))

    # -- the contract-spec grammar ---------------------------------------

    @property
    def mesh_spec(self) -> str:
        """Mesh half of the spec: non-trivial axes in canonical order —
        ``dp2xsp2`` (so ``sp2xdp2`` and ``dp2xsp2`` share one contract
        file); an all-trivial mesh is ``dp1``."""
        parts = [f"{a}{s}" for a, s in self.axes if s > 1]
        return "x".join(parts) if parts else "dp1"

    @property
    def spec(self) -> str:
        """Canonical serialization: mesh spec + ``+Nslice`` for the
        hierarchical program variant + ``+zero1`` — the SC001 contract
        key, the planner's hint wire form, and the ledger label."""
        out = self.mesh_spec
        if self.hier and self.n_slices > 1:
            out += f"+{self.n_slices}slice"
        if self.overlap:
            out += OVERLAP_SUFFIX
        return out + (ZERO1_SUFFIX if self.zero1 else "")

    @classmethod
    def parse(cls, spec: str) -> "WorldDescriptor":
        """Inverse of ``spec``: ``"dp4+2slice+overlap+zero1"``
        round-trips (suffix order: ``+Nslice``, ``+overlap``,
        ``+zero1``)."""
        zero1 = spec.endswith(ZERO1_SUFFIX)
        if zero1:
            spec = spec[: -len(ZERO1_SUFFIX)]
        overlap = spec.endswith(OVERLAP_SUFFIX)
        if overlap:
            spec = spec[: -len(OVERLAP_SUFFIX)]
        n_slices = 1
        m = _SLICE_SUFFIX_RE.search(spec)
        if m:
            n_slices = int(m.group(1))
            if n_slices < 1:
                raise ValueError(f"bad slice count in spec {spec!r}")
            spec = spec[: m.start()]
        return cls.from_axis_sizes(
            parse_mesh_spec(spec),
            n_slices=n_slices,
            zero1=zero1,
            hier=n_slices > 1,
            overlap=overlap,
        )

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_axis_sizes(
        cls,
        axis_sizes: Dict[str, int],
        n_slices: int = 1,
        zero1: bool = False,
        hier: bool = False,
        overlap: bool = False,
    ) -> "WorldDescriptor":
        """From an ``{axis: size}`` mapping (a ``Mesh.shape``, a
        resolved ``MeshConfig.shape()``); trivial axes are kept only to
        preserve the world size when everything is size 1. A
        NON-TRIVIAL axis outside the canonical vocabulary raises —
        silently dropping it would shrink the described world and key
        the wrong contract file (the old ``mesh_spec_of`` appended
        unknown axes to the spec; nothing in the repo ever used one,
        and a checked type must fail loud, not guess)."""
        unknown = sorted(
            a for a, s in axis_sizes.items()
            if a not in CANONICAL_AXES and int(s) > 1
        )
        if unknown:
            raise ValueError(
                f"non-canonical mesh axes {unknown} (sizes "
                f"{ {a: axis_sizes[a] for a in unknown} }); the world "
                f"vocabulary knows {CANONICAL_AXES}"
            )
        axes = tuple(
            (a, int(axis_sizes[a]))
            for a in CANONICAL_AXES
            if axis_sizes.get(a, 1) > 1
        )
        if not axes:
            axes = (("dp", 1),)
        return cls(
            axes=axes, n_slices=n_slices, zero1=zero1, hier=hier,
            overlap=overlap,
        )

    @classmethod
    def from_mesh(
        cls, mesh, n_slices: int = 1, zero1: bool = False,
        hier: bool = False, overlap: bool = False,
    ) -> "WorldDescriptor":
        """From a mesh: a ``DeviceMesh`` (its ``mesh_dim_names`` beside
        its ``shape``, a tuple of ints), a ``MeshConfig``, or a mapping of
        axis names to sizes."""
        from dlrover_tpu_torch.parallel.mesh import axis_sizes

        return cls.from_axis_sizes(
            axis_sizes(mesh), n_slices=n_slices, zero1=zero1, hier=hier,
            overlap=overlap,
        )

    # -- checks -----------------------------------------------------------

    def check_mesh(self, mesh) -> None:
        """Assert a built mesh IS this world (size and every non-trivial
        axis) — the guard live-reshard transfer targets and AOT
        lowering run so the two can never disagree about the world they
        serve."""
        from dlrover_tpu_torch.parallel.mesh import axis_sizes

        shape = axis_sizes(mesh)
        size = math.prod(shape.values())
        if size != self.world_size:
            raise ValueError(
                f"mesh has {size} devices, descriptor "
                f"{self.spec} describes {self.world_size}"
            )
        for name, size in self.axes:
            if shape.get(name, 1) != size:
                raise ValueError(
                    f"mesh axis {name}={shape.get(name, 1)} != "
                    f"descriptor {self.spec}'s {name}={size}"
                )

    # -- wire form (speculation hint) -------------------------------------

    def to_wire(self) -> Dict:
        """The speculation-hint payload on the rendezvous world poll:
        plain JSON-able dict, skew-safe (old agents drop the unknown
        field; new agents tolerate missing keys)."""
        out = {
            "spec": self.spec,
            "world": self.world_size,
            "n_slices": self.n_slices,
        }
        if self.pp > 1:
            # pipelined worlds also publish the stage map, so agents
            # can pre-stage per-stage transfers without re-deriving it
            out["pp"] = self.pp
            out["stage_map"] = [list(s) for s in self.stage_map()]
        return out

    @classmethod
    def from_wire(cls, payload: Optional[Dict]) -> Optional["WorldDescriptor"]:
        """Parse a hint payload; None/malformed → None (a hint is an
        optimization, never worth an error on the poll path)."""
        if not payload:
            return None
        try:
            return cls.parse(str(payload["spec"]))
        except (KeyError, TypeError, ValueError):
            return None


def mesh_spec_of(axis_sizes: Dict[str, int]) -> str:
    """Canonical mesh-spec string for an ``{axis: size}`` shape."""
    return WorldDescriptor.from_axis_sizes(axis_sizes).mesh_spec


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp2xfsdp2"`` → ``{"dp": 2, "fsdp": 2}``. Raises on syntax the
    mesh cannot mean (unknown axis, non-integer size)."""
    out: Dict[str, int] = {}
    for token in spec.split("x"):
        m = re.match(r"^([a-z]+)([0-9]+)$", token.strip())
        if not m or m.group(1) not in CANONICAL_AXES:
            raise ValueError(
                f"bad mesh spec token {token!r} in {spec!r} (want e.g. "
                "dp4, dp2xfsdp2, sp2xdp2)"
            )
        out[m.group(1)] = int(m.group(2))
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def contract_spec_of(
    axis_sizes: Dict[str, int], zero1: bool = False, n_slices: int = 1,
    overlap: bool = False,
) -> str:
    """Canonical CONTRACT key for a program (compat face of
    :class:`WorldDescriptor.spec`): ``contract_spec_of({"dp": 4}, True,
    2)`` → ``"dp4+2slice+zero1"``. ``n_slices > 1`` means the
    hierarchical program variant (flat multislice keys the plain
    spec); ``overlap`` the latency-hiding schedule on top of it."""
    return WorldDescriptor.from_axis_sizes(
        axis_sizes,
        n_slices=n_slices,
        zero1=zero1,
        hier=n_slices > 1,
        overlap=overlap,
    ).spec


def parse_contract_spec(spec: str) -> Tuple[Dict[str, int], bool, int]:
    """``"dp4+2slice+zero1"`` → ``({"dp": 4}, True, 2)`` (compat face
    of :meth:`WorldDescriptor.parse`)."""
    wd = WorldDescriptor.parse(spec)
    return wd.axis_sizes(), wd.zero1, wd.n_slices
