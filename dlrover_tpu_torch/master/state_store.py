"""Master state continuity across a master relaunch: the port's own copy of
dlrover_tpu/master/state_store.py.

The state that must outlive the master process (data-shard queues, the
goodput ledger, node relaunch budgets, the planner's decisions) is written
through to a durable backend, so a relaunched master resumes instead of
resetting:

- **file** backend: one JSON document per key under a directory (atomic
  tmp+rename). Suitable for a shared volume (NFS/PVC) or local runs.
- **configmap** backend: keys in a per-job ConfigMap, on a k8s client the
  caller injects (the port's k8s client comes with its k8s master,
  ROADMAP 5b.3).
- **memory** backend: process-local dict; the LocalJobMaster default.

Write policy: task/shard state is written through on every dispatch and
report (a master killed between a dispatch and its persist re-dispatches
that shard: at-least-once, never lost); the speed ledger and relaunch
budgets are snapshotted from the master's poll loop.

The keys, the key encoding and the four document families (names and
versions) are the JAX package's, so a state directory either package's
master wrote restores in the other. Without ``DLROVER_TPU_STATE_DIR`` the
file backend roots under the temporary directory (``$TMPDIR``), where the
JAX package's roots under ``/tmp``. The JAX package wraps the backends'
locks in its lint's lock tracker (``maybe_track``); that hook waits for
the lint slice (ROADMAP item 15).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import flags, versioned_format
from dlrover_tpu_torch.common.log import logger

STATE_BACKEND_ENV = flags.STATE_BACKEND.name
STATE_DIR_ENV = flags.STATE_DIR.name

# the four continuity-document families, versioned (common/
# versioned_format.py): v2 = first stamped version; a version-less
# document is a pre-stamp master's and reads as-is
SPEED_FORMAT = versioned_format.register("state_speed", 2)
NODES_FORMAT = versioned_format.register("state_nodes", 2)
PLANNER_FORMAT = versioned_format.register("state_planner", 2)
DATASET_FORMAT = versioned_format.register("state_dataset", 2)


class MasterStateBackend:
    """Minimal durable KV the master writes its continuity state into."""

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def set(self, key: str, value: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStateBackend(MasterStateBackend):
    """Process-local; state dies with the master (the local master's
    default and tests)."""

    def __init__(self):
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self, prefix: str = "") -> List[str]:
        with self._lock:
            return [k for k in self._data if k.startswith(prefix)]


def _encode_key(key: str, extra_safe: str = "") -> str:
    """Reversible filename/ConfigMap-safe encoding: any character outside
    [a-zA-Z0-9_-] (plus ``extra_safe``) becomes ``.XX`` hex, '.' itself
    included, so dataset names with '/', '.', or '__' round-trip exactly."""
    out = []
    for ch in key:
        if ch.isalnum() or ch in "_-" or ch in extra_safe:
            out.append(ch)
        else:
            out.append(f".{ord(ch):02X}")
    return "".join(out)


def _decode_key(enc: str) -> str:
    out = []
    i = 0
    while i < len(enc):
        if enc[i] == "." and i + 2 < len(enc):
            out.append(chr(int(enc[i + 1:i + 3], 16)))
            i += 3
        else:
            out.append(enc[i])
            i += 1
    return "".join(out)


class FileStateBackend(MasterStateBackend):
    """One file per key; writes are atomic (tmp + rename) so a master
    killed mid-write never leaves a torn document. A per-backend lock and
    per-thread tmp names keep concurrent persists of the same key from
    interleaving."""

    def __init__(self, root: str):
        self._root = root
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self._root, _encode_key(key) + ".json")

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def set(self, key: str, value: str) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with self._lock:
            with open(tmp, "w") as f:
                f.write(value)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self, prefix: str = "") -> List[str]:
        out = []
        for fn in os.listdir(self._root):
            if fn.endswith(".json"):
                key = _decode_key(fn[: -len(".json")])
                if key.startswith(prefix):
                    out.append(key)
        return out


class ConfigMapStateBackend(MasterStateBackend):
    """Keys in a per-job ConfigMap, durable across master pod relaunches
    without any volume. ``client`` exposes ``get_config_map(name)``,
    ``create_config_map(body)`` and ``patch_config_map(name, patch)``
    (the JAX package's k8s client). ConfigMap data values cap at ~1 MiB
    in all; the continuity state (shard ranges and counters) is a few KB."""

    def __init__(self, client, name: str):
        self._client = client
        self._name = name
        self._lock = threading.Lock()
        self._ensure()

    def _ensure(self):
        if self._client.get_config_map(self._name) is None:
            try:
                self._client.create_config_map(
                    {
                        "apiVersion": "v1",
                        "kind": "ConfigMap",
                        "metadata": {"name": self._name},
                        "data": {},
                    }
                )
            except Exception:
                logger.exception("state configmap %s creation failed",
                                 self._name)

    @staticmethod
    def _enc(key: str) -> str:
        # ConfigMap keys allow [-._a-zA-Z0-9]; '.' is the escape char of
        # the reversible encoding, so arbitrary dataset names round-trip
        return _encode_key(key)

    def get(self, key: str) -> Optional[str]:
        cm = self._client.get_config_map(self._name) or {}
        return (cm.get("data") or {}).get(self._enc(key))

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._client.patch_config_map(
                self._name, {"data": {self._enc(key): value}}
            )

    def delete(self, key: str) -> None:
        with self._lock:
            self._client.patch_config_map(
                self._name, {"data": {self._enc(key): None}}
            )

    def keys(self, prefix: str = "") -> List[str]:
        cm = self._client.get_config_map(self._name) or {}
        out = []
        for k in cm.get("data") or {}:
            key = _decode_key(k)
            if key.startswith(prefix):
                out.append(key)
        return out


def create_state_backend(
    job_name: str, k8s_client=None
) -> MasterStateBackend:
    """Backend from env: ``DLROVER_TPU_STATE_BACKEND`` in
    memory|file|configmap (default: configmap when a k8s client is given,
    else memory). ``DLROVER_TPU_STATE_DIR`` roots the file backend; its
    documents go under ``<root>/<job_name>``."""
    kind = flags.STATE_BACKEND.get().lower()
    if not kind:
        kind = "configmap" if k8s_client is not None else "memory"
    if kind == "file":
        root = flags.STATE_DIR.get() or os.path.join(
            tempfile.gettempdir(), f"dlrover_tpu_state_{job_name}"
        )
        return FileStateBackend(os.path.join(root, job_name))
    if kind == "configmap" and k8s_client is not None:
        return ConfigMapStateBackend(
            k8s_client, f"dlrover-state-{job_name}"
        )
    return MemoryStateBackend()


class MasterStateManager:
    """Facade the master components write through; owns the key layout.

    Every document records the job_uid it belongs to; loads drop documents
    of a DIFFERENT uid: a re-created same-named job must never resume a
    dead predecessor's mid-epoch state (the uid changes when the job is
    re-created, while a relaunched master of the SAME job keeps it)."""

    K_DATASET = "tasks"  # tasks/<dataset>
    K_SPEED = "speed"
    K_NODES = "nodes"
    K_PLANNER = "planner"

    def __init__(self, backend: MasterStateBackend, job_uid: str = ""):
        self._backend = backend
        self._job_uid = job_uid
        # last-written fingerprints: the run loop calls save_speed every
        # poll, but a ConfigMap backend turns each call into an API-server
        # PATCH, so an unchanged document is not written again
        self._last_written: Dict[str, str] = {}
        self._speed_written_at = 0.0
        self._nodes_written_at = 0.0

    @property
    def backend(self) -> MasterStateBackend:
        return self._backend

    def _same_job(self, doc: Dict) -> bool:
        their = doc.get("job_uid", "")
        return not their or not self._job_uid or their == self._job_uid

    # -- dataset / task state (write-through) ---------------------------

    def save_dataset(self, name: str, params: Dict, ckpt_json: str):
        doc = json.dumps(
            DATASET_FORMAT.wrap(
                {"params": params, "ckpt": json.loads(ckpt_json),
                 "time": time.time(), "job_uid": self._job_uid}
            )
        )
        try:
            self._backend.set(f"{self.K_DATASET}/{name}", doc)
        except Exception:
            logger.exception("dataset state persist failed for %s", name)

    def load_datasets(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        try:
            for key in self._backend.keys(f"{self.K_DATASET}/"):
                raw = self._backend.get(key)
                if not raw:
                    continue
                doc = json.loads(raw)
                if not self._same_job(doc):
                    logger.warning(
                        "dropping stale dataset state %s (job_uid %r != %r)",
                        key, doc.get("job_uid"), self._job_uid,
                    )
                    continue
                out[key.split("/", 1)[1]] = DATASET_FORMAT.parse(doc)
        except Exception:
            logger.exception("dataset state load failed")
        return out

    # -- speed / goodput ledger -----------------------------------------

    def save_speed(self, state: Dict):
        # snapshot_time moves every export; exclude it from the dirty
        # check so an otherwise-idle ledger is not rewritten each poll
        fp = json.dumps(
            {k: v for k, v in state.items() if k != "snapshot_time"},
            sort_keys=True,
        )
        now = time.time()
        # refresh snapshot_time at least each minute even when idle, so
        # the relaunch-downtime backdating stays accurate to ~1 min
        fresh = now - self._speed_written_at < 60.0
        if self._last_written.get(self.K_SPEED) == fp and fresh:
            return
        try:
            self._backend.set(
                self.K_SPEED,
                json.dumps(
                    SPEED_FORMAT.wrap(
                        {**state, "job_uid": self._job_uid}
                    )
                ),
            )
            self._last_written[self.K_SPEED] = fp
            self._speed_written_at = now
        except Exception:
            logger.exception("speed ledger persist failed")

    def load_speed(self) -> Optional[Dict]:
        raw = self._backend.get(self.K_SPEED)
        if not raw:
            return None
        doc = json.loads(raw)
        return SPEED_FORMAT.parse(doc) if self._same_job(doc) else None

    # -- goodput planner decision ledger ---------------------------------

    def save_planner(self, state: Dict):
        """The planner's decision ledger and cooldown state: a relaunched
        master must not re-execute a plan the dead one just paid for (the
        port's planner is ROADMAP 5b.2d; the document is the JAX one)."""
        fp = json.dumps(state, sort_keys=True, default=str)
        if self._last_written.get(self.K_PLANNER) == fp:
            return
        try:
            self._backend.set(
                self.K_PLANNER,
                json.dumps(
                    PLANNER_FORMAT.wrap(
                        {"planner": state, "job_uid": self._job_uid}
                    )
                ),
            )
            self._last_written[self.K_PLANNER] = fp
        except Exception:
            logger.exception("planner ledger persist failed")

    def load_planner(self) -> Optional[Dict]:
        raw = self._backend.get(self.K_PLANNER)
        if not raw:
            return None
        doc = json.loads(raw)
        if not self._same_job(doc):
            return None
        return PLANNER_FORMAT.parse(doc).get("planner") or None

    # -- node registry / relaunch budgets --------------------------------

    def save_nodes(self, state: Dict):
        fp = json.dumps(state, sort_keys=True, default=str)
        now = time.time()
        # periodic escape hatch: if the backend key was externally lost
        # (ConfigMap deleted/recreated), an unchanged registry must still
        # be re-persisted within a minute
        fresh = now - self._nodes_written_at < 60.0
        if self._last_written.get(self.K_NODES) == fp and fresh:
            return
        try:
            self._backend.set(
                self.K_NODES,
                json.dumps(
                    NODES_FORMAT.wrap(
                        {**state, "job_uid": self._job_uid}
                    )
                ),
            )
            self._last_written[self.K_NODES] = fp
            self._nodes_written_at = now
        except Exception:
            logger.exception("node registry persist failed")

    def load_nodes(self) -> Optional[Dict]:
        raw = self._backend.get(self.K_NODES)
        if not raw:
            return None
        doc = json.loads(raw)
        return NODES_FORMAT.parse(doc) if self._same_job(doc) else None

    def clear(self):
        """Job finished cleanly: drop the continuity state so a future
        same-named job starts fresh."""
        try:
            for key in self._backend.keys(""):
                self._backend.delete(key)
        except Exception:
            logger.exception("state clear failed")
