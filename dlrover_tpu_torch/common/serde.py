"""Safe dataclass serialization for the control plane: the port's own copy
of dlrover_tpu/common/serde.py, byte for byte the same wire format.

Every message class registers itself and is encoded as
``{"_t": <registered name>, ...fields}`` JSON, reconstructed recursively from
dataclass type hints. Only registered classes can be instantiated (no
pickle on a network port).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}


class UnknownMessageError(ValueError):
    """The wire carried a ``_t`` this process has no class for.

    This is the version-skew signature, not corruption: the peer runs a
    newer (or older) binary whose message vocabulary differs. Subclasses
    ``ValueError`` so pre-existing ``except ValueError`` sites keep
    working, but carries ``type_name`` so dispatch/decode paths can
    degrade deliberately (servers answer ``SimpleResponse``, clients
    raise the typed taxonomy error — see rpc/policy.py) instead of
    surfacing a raw parse error. Every ``deserialize`` call site outside
    this module handles it."""

    def __init__(self, type_name: str):
        self.type_name = str(type_name)
        super().__init__(
            f"unknown message type {self.type_name!r} (version skew: the "
            "peer's message vocabulary differs from this process's)"
        )


def message(cls=None):
    """Class decorator: make a dataclass wire-serializable."""

    def wrap(c):
        c = dataclasses.dataclass(c)
        _REGISTRY[c.__name__] = c
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def registered(name: str):
    return _REGISTRY.get(name)


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"_t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                # Banned: coercing via
                # str(k) would silently change the key type across one
                # round trip — {1: x} decodes as {"1": x} — so an int-
                # keyed dict is a bug at the SENDER, not a decode
                # surprise at every reader. Messages that need non-str
                # keys stringify explicitly (CommWorldResponse.world).
                raise TypeError(
                    f"non-string dict key {k!r} ({type(k).__name__}) in "
                    "control-plane message: JSON round-trips keys as "
                    "strings, which would silently change the key type "
                    "on the peer — stringify explicitly at the sender"
                )
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, bytes):
        return {"_t": "__bytes__", "hex": obj.hex()}
    raise TypeError(f"unserializable control-plane value: {type(obj)}")


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        t = obj.get("_t")
        if t == "__bytes__":
            return bytes.fromhex(obj["hex"])
        if t is not None:
            cls = _REGISTRY.get(t)
            if cls is None:
                raise UnknownMessageError(t)
            hints = typing.get_type_hints(cls)
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name in obj:
                    val = _decode(obj[f.name])
                    hint = hints.get(f.name)
                    # Tuples arrive as lists; coerce from the hint.
                    if (
                        hint is not None
                        and typing.get_origin(hint) is tuple
                        and isinstance(val, list)
                    ):
                        val = tuple(val)
                    kwargs[f.name] = val
            return cls(**kwargs)
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def serialize(msg: Any) -> bytes:
    return json.dumps(_encode(msg), separators=(",", ":")).encode()


def deserialize(data: bytes) -> Any:
    if not data:
        return None
    return _decode(json.loads(data.decode()))
