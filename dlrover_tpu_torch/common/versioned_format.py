"""Explicit versioning for durable JSON formats: the port's own copy of
dlrover_tpu/common/versioned_format.py.

A durable document stamps ``_format``/``_v`` flat beside its payload
(``{"_format": ..., "_v": ..., **payload}``), so a reader that predates the
stamp sees two unknown keys it ignores. :func:`register` declares a format
and its writer version; :meth:`VersionedFormat.wrap` stamps a payload at
write time; :meth:`VersionedFormat.parse` dispatches at read time: the
current version passes through, an older one runs its registered migration,
a version-less document (written before the stamp existed) runs the
``legacy`` adapter, and a NEWER version is read best-effort with a warning.
The names and versions are the JAX package's, so a document either package
writes parses in the other (the shard checkpoint,
``master/shard/dataset_manager.py``). The JAX registry's extraction into
its lint's wire schema waits for the lint slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.log import logger

FORMAT_KEY = "_format"
VERSION_KEY = "_v"

#: every registered durable format: name -> VersionedFormat
FORMATS: Dict[str, "VersionedFormat"] = {}


class FormatError(ValueError):
    """The document names a DIFFERENT format than the reader expected —
    a crossed wire (e.g. a nodes doc under the speed key), never a
    version question."""


@dataclasses.dataclass(frozen=True)
class VersionedFormat:
    name: str
    version: int

    def wrap(self, payload: Dict) -> Dict:
        """Stamp a payload for writing. Flat merge; the payload must
        not use the reserved envelope keys — enforced, because a
        payload that still carries an envelope (a loaded doc re-saved
        without parse()) would otherwise override the stamp with a
        stale version and no error anywhere."""
        for key in (FORMAT_KEY, VERSION_KEY):
            if key in payload:
                raise ValueError(
                    f"payload already carries the reserved envelope key "
                    f"{key!r} (value {payload[key]!r}) — wrap() stamps "
                    f"{self.name} v{self.version}; parse() the document "
                    "first instead of re-wrapping it"
                )
        return {FORMAT_KEY: self.name, VERSION_KEY: self.version, **payload}

    def parse(
        self,
        doc: Dict,
        legacy: Optional[Callable[[Dict], Dict]] = None,
        migrations: Optional[Dict[int, Callable[[Dict], Dict]]] = None,
    ) -> Dict:
        """Return the payload (envelope keys stripped), migrated to the
        current version.

        ``legacy`` adapts a version-less document (pre-versioning
        writer); default: taken as-is. ``migrations[v]`` migrates a
        version-``v`` payload one-or-more steps toward current (applied
        once for the doc's version; chain internally if needed). A doc
        from a NEWER writer logs a warning and passes through — the
        consumer's key-by-key reads drop what it cannot know."""
        if not isinstance(doc, dict):
            raise FormatError(
                f"{self.name}: document is {type(doc).__name__}, not a dict"
            )
        named = doc.get(FORMAT_KEY)
        if named is not None and named != self.name:
            raise FormatError(
                f"expected durable format {self.name!r}, document says "
                f"{named!r} — crossed state keys?"
            )
        payload = {
            k: v for k, v in doc.items()
            if k not in (FORMAT_KEY, VERSION_KEY)
        }
        if VERSION_KEY not in doc:
            return legacy(payload) if legacy is not None else payload
        v = int(doc[VERSION_KEY])
        if v == self.version:
            return payload
        if v > self.version:
            logger.warning(
                "durable format %s v%d written by a NEWER binary than "
                "this reader (knows v%d); reading best-effort — unknown "
                "content is ignored", self.name, v, self.version,
            )
            return payload
        fn = (migrations or {}).get(v)
        if fn is None:
            # an older version with no migration registered: the fields
            # this reader knows are read by name anyway; defaults fill
            # the rest (same posture as serde's unknown-field drop)
            logger.warning(
                "durable format %s v%d has no migration to v%d; reading "
                "field-by-field with defaults", self.name, v, self.version,
            )
            return payload
        return fn(payload)


def register(name: str, version: int) -> VersionedFormat:
    """Declare (or re-fetch) a durable format. Re-registration with a
    different version is a programming error — two writers of one
    format must agree on what they stamp."""
    fmt = FORMATS.get(name)
    if fmt is not None:
        if fmt.version != version:
            raise ValueError(
                f"durable format {name!r} already registered at "
                f"v{fmt.version}, cannot re-register at v{version}"
            )
        return fmt
    fmt = VersionedFormat(name=name, version=int(version))
    FORMATS[name] = fmt
    return fmt
