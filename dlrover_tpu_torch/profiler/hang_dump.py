"""Hang dump: all-rank Python stacks + pending device programs. The port's
own copy of dlrover_tpu/profiler/hang_dump.py.

On a detected hang the agent collects two artifacts:

- the **pending device executions** (name + age) from each local rank's
  device timer (``/pending`` endpoint, ``timer_manager.cc PendingJson``):
  the NCCL collectives and step scopes whose end event never passed;
- the **Python stacks of every local worker process**, captured by
  signal-driven ``faulthandler`` (stdlib, no gdb/py-spy dependency): each
  worker registers a SIGUSR2 handler at bootstrap that appends all-thread
  stacks to a per-process file; the agent signals the workers and collects
  the files. The handler is C-level, so a worker whose main thread is
  blocked in a CUDA synchronise still dumps.

The bundle lands in the master's diagnosis pipeline as a
``HangDumpRecord`` (``DiagnosisAgent.report_once``).
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger

#: worker-side dump file pattern, one per process
STACK_FILE_TMPL = "hang_stacks-{pid}.txt"
DUMP_SIGNAL = signal.SIGUSR2


def install_stack_dump_handler(stack_dir: str) -> str:
    """Worker-side: register a SIGUSR2 handler that appends all-thread
    Python stacks to ``stack_dir/hang_stacks-<pid>.txt``. Cheap (stdlib
    faulthandler, async-signal-safe) and callable exactly once per
    process. Returns the dump file path."""
    import faulthandler

    os.makedirs(stack_dir, exist_ok=True)
    path = os.path.join(stack_dir, STACK_FILE_TMPL.format(pid=os.getpid()))
    # line-buffered append handle kept open for the process lifetime:
    # faulthandler writes to the fd directly from the signal handler
    f = open(path, "a")
    faulthandler.register(DUMP_SIGNAL, file=f, all_threads=True, chain=False)
    # fatal-signal capture (reference signal_handler.cc:1-134): SIGSEGV/
    # SIGFPE/SIGABRT/SIGBUS tracebacks land in the same per-process file,
    # so a crashed worker leaves its last stack for the diagnosis report
    faulthandler.enable(file=f, all_threads=True)
    return path


class HangDumper:
    """Agent-side: collect the hang bundle for all local workers."""

    def __init__(
        self,
        stack_dir: str,
        worker_pids: Optional[List[int]] = None,
        metrics_ports: Optional[List[int]] = None,
        settle_secs: float = 1.5,
        cooldown_secs: float = 600.0,
    ):
        self._stack_dir = stack_dir
        self._pids = list(worker_pids or [])
        self._ports = list(metrics_ports or [])
        self._settle = settle_secs
        self._cooldown = cooldown_secs
        self._last_dump = 0.0

    def set_workers(self, pids: List[int]):
        self._pids = list(pids)

    def set_metrics_ports(self, ports: List[int]):
        self._ports = list(ports)

    def should_dump(self) -> bool:
        return time.time() - self._last_dump >= self._cooldown

    def dump(self, reason: str = "hang") -> Dict:
        """Signal every worker, wait for the stacks to land, fetch each
        rank's pending-program list, return the bundle."""
        self._last_dump = time.time()
        marks: Dict[int, int] = {}
        for pid in self._pids:
            path = self._stack_path(pid)
            marks[pid] = os.path.getsize(path) if os.path.exists(path) else 0
            try:
                os.kill(pid, DUMP_SIGNAL)
            except (ProcessLookupError, PermissionError) as e:
                logger.warning("hang dump: cannot signal pid %s: %s", pid, e)
        if self._pids:
            time.sleep(self._settle)

        stacks: Dict[str, str] = {}
        for pid in self._pids:
            path = self._stack_path(pid)
            try:
                with open(path) as f:
                    f.seek(marks.get(pid, 0))
                    stacks[str(pid)] = f.read()
            except OSError as e:
                stacks[str(pid)] = f"<no dump: {e}>"

        pending: Dict[str, Dict] = {}
        for port in self._ports:
            pending[str(port)] = self._fetch_pending(port)

        bundle = {
            "reason": reason,
            "time": time.time(),
            "stacks": stacks,
            "pending": pending,
        }
        logger.warning(
            "hang dump collected: %d worker stacks, %d rank pending lists",
            sum(1 for s in stacks.values() if "Thread" in s or "File" in s),
            len(pending),
        )
        return bundle

    def _stack_path(self, pid: int) -> str:
        return os.path.join(self._stack_dir, STACK_FILE_TMPL.format(pid=pid))

    @staticmethod
    def _fetch_pending(port: int) -> Dict:
        # shared bounded-timeout + retry-with-warning scrape helper
        # (profiler/tpu_timer.py): a wedged timer degrades this
        # bundle to an error entry instead of hanging the dumper
        from dlrover_tpu_torch.profiler.tpu_timer import _http_get

        try:
            return json.loads(_http_get(port, "/pending", timeout=2.0))
        except (OSError, ValueError) as e:
            return {"error": str(e)}
