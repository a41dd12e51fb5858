"""Train state <-> POSIX shared memory staging (port of
dlrover_tpu/checkpoint/shm_handler.py).

The segment layout is the JAX package's, byte for byte, so either package
reads a segment the other wrote::

    [8B header_len][header JSON][... leaf bytes from HEADER_SPACE on ...]

``header_len`` is written last: a reader sees either no checkpoint
(header_len 0, while a write is under way) or a complete one.

Leaves are named as ``jax.tree_util.keystr`` names the same leaf of the
JAX train state (``flatten_state``), so a manifest means the same thing to
both packages. The port writes ``treedef_hex = ""`` and never unpickles a
treedef: a restore goes by its target's leaf names, as the JAX engine's
restore by target does. Leaf bytes move as raw bytes, so a bfloat16 leaf
needs no numpy type of its own.

On the card the segment's mapping is registered with CUDA
(``cudaHostRegister``, ``pin``), so a copy between a device tensor and the
segment is a DMA with no host memcpy in between.
"""

from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass, field
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import logger

HEADER_SPACE = 4 << 20  # 4 MiB for metadata
_LEN_FMT = "<Q"
_LEN_SIZE = 8
# cudaHostRegisterPortable: the mapping is pinned for every CUDA context
_REGISTER_PORTABLE = 1

# dtype names as numpy (and ml_dtypes, for bfloat16) spell them in the JAX
# package's manifests
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {name!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as the JAX package's manifests spell it."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"unsupported checkpoint dtype {dtype}") from None


@dataclass
class TensorMeta:
    path: str
    dtype: str
    shape: Tuple[int, ...]
    offset: int
    nbytes: int
    # where this piece sits in the whole leaf
    global_shape: Tuple[int, ...] = ()
    index: Tuple[Tuple[int, int], ...] = ()  # (start, stop) per dim
    # zlib.crc32 of the persisted leaf file's bytes, filled at persist time
    # (0 = not computed: shm-only metas); disk and object restores verify it
    crc32: int = 0

    def to_dict(self) -> Dict:
        return {
            "path": self.path,
            "dtype": self.dtype,
            "shape": list(self.shape),
            "offset": self.offset,
            "nbytes": self.nbytes,
            "global_shape": list(self.global_shape),
            "index": [list(p) for p in self.index],
            "crc32": self.crc32,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TensorMeta":
        return cls(
            path=d["path"],
            dtype=d["dtype"],
            shape=tuple(d["shape"]),
            offset=d["offset"],
            nbytes=d["nbytes"],
            global_shape=tuple(d.get("global_shape", [])),
            index=tuple(tuple(p) for p in d.get("index", [])),
            crc32=int(d.get("crc32", 0)),
        )


@dataclass
class CheckpointMeta:
    step: int = -1
    leaves: List[TensorMeta] = field(default_factory=list)
    treedef_hex: str = ""
    timestamp: float = 0.0
    world_size: int = 1
    process_id: int = 0
    total_bytes: int = 0
    # the checkpoint directory the staged state belongs to: shm names key
    # on (job, node, process), so two checkpointers under one job name but
    # different directories would otherwise cross-restore
    ckpt_dir: str = ""
    # every leaf path of the saved state (no "#sK" suffix), in flatten
    # order; under deduplicated staging ``leaves`` holds only the owned
    # pieces, and restore tells a leaf the checkpoint never had from one
    # whose pieces are missing by this list
    leaf_paths: List[str] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(
            {
                "step": self.step,
                "leaves": [m.to_dict() for m in self.leaves],
                "treedef_hex": self.treedef_hex,
                "timestamp": self.timestamp,
                "world_size": self.world_size,
                "process_id": self.process_id,
                "total_bytes": self.total_bytes,
                "ckpt_dir": self.ckpt_dir,
                "leaf_paths": list(self.leaf_paths),
            }
        )

    @classmethod
    def from_json(cls, content: str) -> "CheckpointMeta":
        d = json.loads(content)
        return cls(
            step=d["step"],
            leaves=[TensorMeta.from_dict(m) for m in d["leaves"]],
            treedef_hex=d.get("treedef_hex", ""),
            timestamp=d.get("timestamp", 0.0),
            world_size=d.get("world_size", 1),
            process_id=d.get("process_id", 0),
            total_bytes=d.get("total_bytes", 0),
            ckpt_dir=d.get("ckpt_dir", ""),
            leaf_paths=list(d.get("leaf_paths", [])),
        )


@dataclass
class Leaf:
    """One leaf of a train state under its JAX name. ``value`` is the
    tensor itself, or a 0-d numpy array holding a Python scalar's value
    (int32 for an int, float32 for a float, as JAX keeps them);
    ``container[key]`` is where the leaf lives, for restoring a scalar."""

    name: str
    value: Any
    container: Any
    key: Any


def _leaf_value(value):
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return value
    if isinstance(value, bool):
        return np.asarray(value, np.bool_)
    if isinstance(value, int):
        return np.asarray(value, np.int32)
    if isinstance(value, float):
        return np.asarray(value, np.float32)
    raise TypeError(f"unsupported checkpoint leaf {type(value).__name__}")


def _walk(tree: dict, prefix: str, out: List[Leaf]):
    # sorted keys: the order in which jax flattens a dict
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}[{key!r}]"
        if isinstance(value, dict):
            _walk(value, name, out)
        else:
            out.append(Leaf(name, _leaf_value(value), tree, key))


# the JAX optimizer is optax.chain(clip_by_global_norm, adamw), and adamw is
# chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate): adam's
# (count, mu, nu) sit at opt[1][0] and the schedule's count at opt[1][2]
_ADAM = "['opt'][1][0]"
_SCHEDULE = "['opt'][1][2]"


def _is_adam(value) -> bool:
    return isinstance(value, dict) and set(value) == {"count", "mu", "nu"}


def flatten_state(state: dict) -> List[Leaf]:
    """The leaves of a nested-dict state in the order, and under the
    names, that ``jax.tree_util`` gives the same leaves of the JAX train
    state. The port's optimizer state ``{"count", "mu", "nu"}`` under
    ``"opt"`` takes optax's names, its count standing for both adam's and
    the schedule's (the two counts are equal in a JAX state)."""
    out: List[Leaf] = []
    for key in sorted(state):
        value = state[key]
        name = f"[{key!r}]"
        if key == "opt" and _is_adam(value):
            count = _leaf_value(value["count"])
            out.append(Leaf(f"{_ADAM}.count", count, value, "count"))
            _walk(value["mu"], f"{_ADAM}.mu", out)
            _walk(value["nu"], f"{_ADAM}.nu", out)
            out.append(Leaf(f"{_SCHEDULE}.count", count, value, "count"))
        elif isinstance(value, dict):
            _walk(value, name, out)
        else:
            out.append(Leaf(name, _leaf_value(value), state, key))
    return out


def as_bytes(value) -> torch.Tensor:
    """A tensor's (or a numpy array's) bytes as a flat uint8 tensor on its
    device; a view when the tensor is contiguous."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.contiguous().reshape(-1).view(torch.uint8)


def shm_name(job_name: str, node_id: int, process_id: int) -> str:
    safe_job = job_name.replace("/", "_")
    return f"{CheckpointConstant.SHM_PREFIX}_{safe_job}_{node_id}_{process_id}"


class SharedMemoryHandler:
    """One shm segment per training process, reused across steps."""

    def __init__(self, name: str, create: bool = False, size: int = 0):
        self.name = name
        self._create = create
        self._size = size
        self._shm: Optional[shared_memory.SharedMemory] = None
        # a uint8 tensor over the whole mapping, and its CUDA registration
        self._host: Optional[torch.Tensor] = None
        self._pinned_ptr = 0

    # -- lifecycle ----------------------------------------------------------

    def _ensure(self, needed_bytes: int = 0):
        total = HEADER_SPACE + needed_bytes
        if self._shm is not None and self._shm.size >= total:
            return
        if self._shm is not None:
            self._release_mapping()
            self._shm.close()
            if self._create:
                _unlink(self._shm)
            self._shm = None
        if self._create:
            size = max(total, self._size)
            try:
                self._shm = shared_memory.SharedMemory(
                    name=self.name, create=True, size=size
                )
                # zero the length word so readers see "empty"
                struct.pack_into(_LEN_FMT, self._shm.buf, 0, 0)
            except FileExistsError:
                # a previous (crashed) incarnation left the segment: reuse
                # it if large enough (its staged step is still restorable),
                # else replace it
                existing = shared_memory.SharedMemory(name=self.name)
                if existing.size >= total:
                    self._shm = existing
                else:
                    existing.close()
                    _unlink(existing)
                    self._shm = shared_memory.SharedMemory(
                        name=self.name, create=True, size=size
                    )
                    struct.pack_into(_LEN_FMT, self._shm.buf, 0, 0)
            # the segment must outlive this (possibly crashing) process:
            # keep python's resource tracker from unlinking it at exit
            _unregister_from_resource_tracker(self.name)
        else:
            self._shm = shared_memory.SharedMemory(name=self.name)
            _unregister_from_resource_tracker(self.name)

    def attach(self) -> bool:
        """Attach to an existing segment (reader side). False if absent."""
        if self._shm is not None:
            return True
        try:
            self._shm = shared_memory.SharedMemory(name=self.name)
            _unregister_from_resource_tracker(self.name)
            return True
        except FileNotFoundError:
            return False

    def _release_mapping(self):
        """Unregister the mapping from CUDA and drop the tensor over it
        (the mapping cannot close while a view of it is alive)."""
        if self._pinned_ptr:
            err = int(torch.cuda.cudart().cudaHostUnregister(self._pinned_ptr))
            if err:
                logger.warning("cudaHostUnregister of %s failed: cudaError %s",
                               self.name, err)
            self._pinned_ptr = 0
        self._host = None

    def close(self, unlink: bool = False):
        if self._shm is not None:
            self._release_mapping()
            self._shm.close()
            if unlink:
                _unlink(self._shm)
            self._shm = None

    @property
    def buf(self):
        return self._shm.buf if self._shm else None

    def host_view(self) -> torch.Tensor:
        """The whole mapping as a uint8 CPU tensor (no copy)."""
        if self._host is None:
            self._host = torch.frombuffer(self._shm.buf, dtype=torch.uint8)
        return self._host

    def pin(self) -> float:
        """Register the mapping with CUDA once (again after ``_ensure``
        replaced it), so device copies into and out of it are DMAs.
        Returns the seconds the registration took (0 when already
        registered); raises when CUDA refuses it. Pages the segment has
        not allocated yet are allocated inside the call (PERF.md, PR 7)."""
        if self._pinned_ptr:
            return 0.0
        view = self.host_view()
        t0 = time.perf_counter()
        err = int(torch.cuda.cudart().cudaHostRegister(
            view.data_ptr(), view.numel(), _REGISTER_PORTABLE))
        if err:
            raise RuntimeError(
                f"cudaHostRegister of shm segment {self.name} "
                f"({view.numel()} bytes) failed: cudaError {err}")
        self._pinned_ptr = view.data_ptr()
        return time.perf_counter() - t0

    # -- write --------------------------------------------------------------

    def reserve(self, nbytes: int):
        """Make room for ``nbytes`` of leaves (a larger segment replaces
        the mapping, which must then be registered again)."""
        self._ensure(nbytes)

    def begin_write(self, nbytes: int) -> torch.Tensor:
        """Make room for ``nbytes`` of leaves and mark the segment empty
        until ``publish``; returns the mapping as a uint8 tensor."""
        self._ensure(nbytes)
        struct.pack_into(_LEN_FMT, self._shm.buf, 0, 0)
        return self.host_view()

    def publish(self, meta: CheckpointMeta):
        """Write the header, then its length word: the write's commit."""
        header = meta.to_json().encode()
        if _LEN_SIZE + len(header) > HEADER_SPACE:
            raise ValueError(
                f"checkpoint meta too large: {len(header)} bytes "
                f"(> {HEADER_SPACE - _LEN_SIZE})"
            )
        buf = self._shm.buf
        buf[_LEN_SIZE:_LEN_SIZE + len(header)] = header
        struct.pack_into(_LEN_FMT, buf, 0, len(header))

    def restore_segment(self, data: bytes):
        """Write a segment received whole (a replica restore): ``data`` is
        a prefix of a valid segment, header and leaf bytes. Its length
        word goes last, so a reader never sees a torn header."""
        self._ensure(max(0, len(data) - HEADER_SPACE))
        buf = self._shm.buf
        struct.pack_into(_LEN_FMT, buf, 0, 0)
        buf[_LEN_SIZE:len(data)] = memoryview(data)[_LEN_SIZE:]
        struct.pack_into(_LEN_FMT, buf, 0,
                         struct.unpack_from(_LEN_FMT, data, 0)[0])

    def save_state(
        self,
        step: int,
        named_leaves: List[Tuple[str, Any]],
        shard_info: Optional[Dict[str, Tuple[Tuple[int, ...], Tuple]]] = None,
        world_size: int = 1,
        process_id: int = 0,
        ckpt_dir: str = "",
        leaf_paths: Optional[List[str]] = None,
    ):
        """Copy host leaves (CPU tensors or numpy arrays) into shm and
        publish the header."""
        metas = layout(named_leaves, shard_info)
        seg = self.begin_write(sum(m.nbytes for m in metas))
        for m, (_, value) in zip(metas, named_leaves):
            seg[m.offset:m.offset + m.nbytes].copy_(as_bytes(value))
        self.publish(CheckpointMeta(
            step=step, leaves=metas, timestamp=time.time(),
            world_size=world_size, process_id=process_id,
            total_bytes=sum(m.nbytes for m in metas), ckpt_dir=ckpt_dir,
            leaf_paths=list(leaf_paths or []),
        ))

    # -- read ---------------------------------------------------------------

    def read_meta(self) -> Optional[CheckpointMeta]:
        if self._shm is None and not self.attach():
            return None
        buf = self._shm.buf
        (hlen,) = struct.unpack_from(_LEN_FMT, buf, 0)
        if hlen == 0 or hlen > HEADER_SPACE - _LEN_SIZE:
            return None
        try:
            return CheckpointMeta.from_json(
                bytes(buf[_LEN_SIZE:_LEN_SIZE + hlen]).decode()
            )
        except (json.JSONDecodeError, KeyError) as e:
            logger.warning("corrupt shm checkpoint header: %s", e)
            return None

    def leaf_bytes(self, meta: TensorMeta) -> torch.Tensor:
        """A leaf's bytes as a uint8 view of the segment (no copy)."""
        return self.host_view()[meta.offset:meta.offset + meta.nbytes]

    def read_leaf(self, meta: TensorMeta) -> torch.Tensor:
        """A copy of one leaf as a CPU tensor of its dtype and shape."""
        return decode(self.leaf_bytes(meta).clone(), meta.dtype, meta.shape)


def layout(named_leaves, shard_info=None) -> List[TensorMeta]:
    """Metas of leaves packed one after the other from HEADER_SPACE on, in
    the given order, as the JAX package packs them."""
    metas: List[TensorMeta] = []
    offset = HEADER_SPACE
    for path, value in named_leaves:
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        dtype, shape = dtype_name(value.dtype), tuple(value.shape)
        n = value.numel() * value.element_size()
        gshape, index = (shard_info or {}).get(
            path, (tuple(shape), tuple((0, d) for d in shape)))
        metas.append(TensorMeta(
            path=path, dtype=dtype, shape=tuple(shape), offset=offset,
            nbytes=n, global_shape=tuple(gshape), index=tuple(index)))
        offset += n
    return metas


def decode(data: torch.Tensor, dtype: str, shape) -> torch.Tensor:
    """uint8 bytes (aligned: a fresh tensor) as a tensor of ``dtype`` and
    ``shape``."""
    return data.view(torch_dtype(dtype)).reshape(tuple(shape))


def _unlink(shm: shared_memory.SharedMemory):
    """Unlink a segment this process keeps untracked: ``unlink`` also
    unregisters it from the resource tracker, so register it first and
    the tracker's books balance."""
    try:
        resource_tracker.register(shm._name, "shared_memory")
        shm.unlink()
    except FileNotFoundError:
        pass


def _unregister_from_resource_tracker(name: str):
    """A process must not let the resource tracker unlink the segment at
    its exit: it outlives the process by design."""
    try:
        resource_tracker.unregister(f"/{name}", "shared_memory")
    except Exception:
        pass
