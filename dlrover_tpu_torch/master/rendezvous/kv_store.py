"""In-master KV store backing distributed barriers and small blobs: the
port's own copy of dlrover_tpu/master/rendezvous/kv_store.py.
"""

from __future__ import annotations

import threading
from typing import Dict, List


class KVStoreService:
    def __init__(self):
        self._store: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: bytes):
        with self._lock:
            self._store[key] = value

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def multi_set(self, kvs: Dict[str, bytes]):
        with self._lock:
            self._store.update(kvs)

    def multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        with self._lock:
            return {k: self._store.get(k, b"") for k in keys}

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic counter add; value stored as ascii int."""
        with self._lock:
            cur = int(self._store.get(key, b"0") or b"0")
            cur += amount
            self._store[key] = str(cur).encode()
            return cur
