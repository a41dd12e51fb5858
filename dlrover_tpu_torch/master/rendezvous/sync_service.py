"""Named barriers across workers: the port's own copy of
dlrover_tpu/master/rendezvous/sync_service.py.
"""

from __future__ import annotations

import threading
from typing import Dict, Set


class SyncService:
    def __init__(self, job_context=None):
        self._sync_objs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._lock = threading.Lock()
        self._job_context = job_context

    def _required_ranks(self) -> Set[int]:
        if self._job_context is None:
            return set()
        return {n.rank_index for n in self._job_context.running_nodes()}

    def join_sync(self, sync_name: str, node_rank: int) -> bool:
        with self._lock:
            joined = self._sync_objs.setdefault(sync_name, set())
            joined.add(node_rank)
            required = self._required_ranks()
            if required and required.issubset(joined):
                self._finished.add(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def barrier(self, sync_name: str) -> bool:
        """Force-finish a barrier (owner-driven)."""
        with self._lock:
            self._finished.add(sync_name)
            return True
