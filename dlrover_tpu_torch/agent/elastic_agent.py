"""Per-host elastic agent: spawn, monitor and restart the worker processes.
The port's own copy of dlrover_tpu/agent/elastic_agent.py.

The agent joins the master's rendezvous, derives each worker's environment
from the completed world (the coordinator address its process group forms
at, its process id, the number of processes), starts the workers, and
watches them. It hosts the node's flash-checkpoint saver
(``checkpoint/saver.py::AsyncCheckpointSaver``): staged state survives a
worker's death in shm, and the agent persists it at the breakpoint before
it restarts the workers, in the JAX package's order. A failed worker is
reported to the master, its log tail classified (``diagnosis_agent``), and
the workers restarted in place while the restart budget lasts.

The JAX agent's device timer, comm metrics, metric endpoints, parallel
config tuner, diagnosis observe loop and replica peer sync wait for their
modules (ROADMAP.md).
"""

from __future__ import annotations

import enum
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.diagnosis_agent import (
    WorkerAction,
    WorkerFailure,
    diagnose_training_failure,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import (
    CommWorld,
    MasterRendezvousHandler,
    RendezvousTimeoutError,
)
from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    NodeEnv,
    RendezvousName,
    TrainingExceptionLevel,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.utils.net import find_free_port, local_ip


class RunResult(enum.Enum):
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    MEMBERSHIP_CHANGED = "membership_changed"
    AGENT_STOPPED = "agent_stopped"


@dataclass
class WorkerProc:
    local_rank: int
    process_id: int
    proc: subprocess.Popen
    log_path: str


def agent_log_dir(job_name: str, node_id: int) -> str:
    """Where an agent writes its workers' logs: the JAX package's
    ``/tmp/dlrover_tpu_logs/<job>/node-<id>``, under ``$TMPDIR`` when that
    is set. A killed agent leaves the directory behind."""
    return os.path.join(tempfile.gettempdir(), "dlrover_tpu_logs", job_name,
                        f"node-{node_id}")


class ElasticAgent:
    def __init__(
        self,
        config: ElasticLaunchConfig,
        client: MasterClient,
        log_dir: str = "",
    ):
        self._config = config
        self._client = client
        self._log_dir = log_dir or agent_log_dir(config.job_name,
                                                 config.node_id)
        os.makedirs(self._log_dir, exist_ok=True)
        self._node_ip = local_ip()
        self._workers: List[WorkerProc] = []
        self._restart_count = 0
        self._stop_evt = threading.Event()
        self._restart_requested = threading.Event()
        self._relaunch_requested = False
        self._status_reporter = None
        self._rdzv_handler: Optional[MasterRendezvousHandler] = None
        self._ckpt_saver = None

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> int:
        self._client.report_node_address(self._node_ip)
        self._start_ckpt_saver()
        self._start_heartbeats()
        self._install_signal_handlers()
        try:
            return self._invoke_run()
        finally:
            self._stop_evt.set()
            if self._status_reporter is not None:
                self._status_reporter.stop()
            self._stop_workers()
            if self._ckpt_saver is not None:
                self._ckpt_saver.stop()

    def _start_ckpt_saver(self):
        """Host the flash-checkpoint saver so staged state survives worker
        crashes. A saver that fails to start is logged and the agent goes
        on without it, as the JAX agent does."""
        from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver

        try:
            self._ckpt_saver = AsyncCheckpointSaver(
                job_name=self._config.job_name,
                node_id=self._config.node_id,
            )
            self._ckpt_saver.start()
        except Exception:
            logger.exception("checkpoint saver failed to start; continuing")
            self._ckpt_saver = None

    def _invoke_run(self) -> int:
        while not self._stop_evt.is_set():
            try:
                world = self._rendezvous()
            except RendezvousTimeoutError as e:
                logger.error("rendezvous timed out: %s", e)
                self._client.report_failure(str(e), self._restart_count)
                return 1
            self._start_workers(world)
            result, exit_code, err = self._monitor_workers()
            if result == RunResult.SUCCEEDED:
                logger.info("node %s: workers succeeded", self._config.node_id)
                self._client.report_succeeded()
                if self._ckpt_saver is not None:
                    # the job's last queued persist commits before its
                    # segment goes
                    self._ckpt_saver.drain()
                    self._ckpt_saver.cleanup_shm()
                return 0
            if result == RunResult.AGENT_STOPPED:
                # stopped by a master action (relaunch) or a signal: exit
                # nonzero so the platform replaces this node
                self._save_checkpoint_at_breakpoint()
                self._stop_workers()
                return 143 if self._relaunch_requested else 0
            if result == RunResult.MEMBERSHIP_CHANGED:
                logger.info(
                    "node %s: membership changed; restarting workers, "
                    "seen at %.3f", self._config.node_id, time.time(),
                )
                self._save_checkpoint_at_breakpoint()
                self._stop_workers()
                logger.info("node %s: workers stopped at %.3f",
                            self._config.node_id, time.time())
                continue
            # FAILED: persist what is staged, then the diagnosis decides
            # restart-in-place vs handing the node back to the platform
            logger.warning(
                "node %s: worker failed (exit %s), seen at %.3f",
                self._config.node_id, exit_code, time.time(),
            )
            self._save_checkpoint_at_breakpoint()
            self._stop_workers()
            self._client.report_failure(
                err, self._restart_count, TrainingExceptionLevel.ERROR,
                exit_code,
            )
            action = diagnose_training_failure(
                WorkerFailure(
                    node_id=self._config.node_id,
                    restart_count=self._restart_count,
                    max_restarts=self._config.max_restarts,
                    exit_code=exit_code,
                    log_tail=err,
                )
            )
            if action == WorkerAction.RESTART_WORKER:
                self._restart_count += 1
                logger.warning(
                    "node %s: worker failed (exit=%s); restart %s/%s",
                    self._config.node_id,
                    exit_code,
                    self._restart_count,
                    self._config.max_restarts,
                )
                continue
            logger.error(
                "node %s: diagnosis says relaunch (exit=%s); exiting",
                self._config.node_id,
                exit_code,
            )
            return exit_code or 1
        return 0

    # -- rendezvous ---------------------------------------------------------

    def _rendezvous(self) -> CommWorld:
        # a fresh round gets a fresh coordinator port: the last world's
        # store may still hold the old one
        coord_port = find_free_port()
        handler = MasterRendezvousHandler(
            self._client,
            RendezvousName.TRAINING,
            local_world_size=self._config.nproc_per_node,
            node_ip=self._node_ip,
            node_port=coord_port,
        )
        t0 = time.perf_counter()
        world = handler.next_rendezvous(node_rank_hint=self._config.node_id)
        logger.info("node %s: rendezvous round %s in %.3fs",
                    self._config.node_id, world.rdzv_round,
                    time.perf_counter() - t0)
        self._rdzv_handler = handler
        if self._ckpt_saver is not None:
            self._ckpt_saver.update_topology(
                node_rank=world.node_rank,
                num_nodes=world.world_size,
                process_ids=[
                    world.process_id_base + i
                    for i in range(self._config.nproc_per_node)
                ],
            )
        return world

    # -- workers ------------------------------------------------------------

    def _worker_env(self, world: CommWorld, local_rank: int) -> Dict[str, str]:
        """The JAX agent's worker environment, key for key; the
        accelerator is ``cuda`` or ``cpu``."""
        env = dict(os.environ)
        process_id = world.process_id_base + local_rank
        env.update(
            {
                NodeEnv.JOB_NAME: self._config.job_name,
                NodeEnv.MASTER_ADDR: self._client.master_addr,
                NodeEnv.NODE_ID: str(self._config.node_id),
                NodeEnv.NODE_RANK: str(world.node_rank),
                NodeEnv.NODE_NUM: str(world.world_size),
                NodeEnv.COORDINATOR_ADDR: world.coordinator_addr,
                NodeEnv.PROCESS_ID: str(process_id),
                NodeEnv.NUM_PROCESSES: str(world.num_processes),
                NodeEnv.RESTART_COUNT: str(self._restart_count),
                "DLROVER_TPU_ACCELERATOR": self._config.accelerator,
                "DLROVER_TPU_LOCAL_RANK": str(local_rank),
                "DLROVER_TPU_NUM_SLICES": str(world.n_slices),
                # where the workers' stack dumps go (the dumper waits for
                # the profiler slice; the path is the JAX agent's)
                "DLROVER_TPU_STACK_DIR": os.path.join(self._log_dir, "hang"),
            }
        )
        return env

    def _start_workers(self, world: CommWorld):
        self._workers = []
        for local_rank in range(self._config.nproc_per_node):
            process_id = world.process_id_base + local_rank
            log_path = os.path.join(
                self._log_dir,
                f"worker-{process_id}-restart{self._restart_count}.log",
            )
            log_file = open(log_path, "ab")
            cmd = [sys.executable, self._config.entrypoint] + list(
                self._config.entrypoint_args
            )
            try:
                proc = subprocess.Popen(
                    cmd,
                    env=self._worker_env(world, local_rank),
                    stdout=log_file,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            finally:
                log_file.close()
            self._workers.append(
                WorkerProc(local_rank, process_id, proc, log_path))
            logger.info(
                "node %s: started worker process_id=%s pid=%s at %.3f log=%s",
                self._config.node_id,
                process_id,
                proc.pid,
                time.time(),
                log_path,
            )

    def _stop_workers(self, grace: float = 10.0):
        """SIGTERM each worker's process group, SIGKILL it after
        ``grace``, and reap it."""
        for w in self._workers:
            if w.proc.poll() is None:
                try:
                    os.killpg(w.proc.pid, signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        deadline = time.time() + grace
        for w in self._workers:
            timeout = max(0.1, deadline - time.time())
            try:
                w.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(w.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                w.proc.wait()
        self._workers = []

    def _tail_log(self, path: str, max_bytes: int = 4096) -> str:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    # -- monitoring ---------------------------------------------------------

    def _membership_changed(self) -> bool:
        """A node is waiting to (re)join -> the world must re-form."""
        try:
            return self._rdzv_handler.num_nodes_waiting() > 0
        except Exception:
            return False

    def _monitor_workers(self):
        """Returns (RunResult, exit_code, error_text)."""
        while not self._stop_evt.is_set():
            time.sleep(self._config.monitor_interval)
            states = [(w, w.proc.poll()) for w in self._workers]
            failed = next((s for s in states if s[1] not in (None, 0)), None)
            if failed is not None:
                err = self._tail_log(failed[0].log_path)
                return RunResult.FAILED, failed[1] or 1, err
            if all(code == 0 for _, code in states):
                return RunResult.SUCCEEDED, 0, ""
            if self._restart_requested.is_set():
                self._restart_requested.clear()
                return RunResult.MEMBERSHIP_CHANGED, 0, ""
            if self._membership_changed():
                return RunResult.MEMBERSHIP_CHANGED, 0, ""
        return RunResult.AGENT_STOPPED, 0, ""

    # -- heartbeats / signals ----------------------------------------------

    def _start_heartbeats(self):
        """The folded status report: heartbeat + resource usage in one
        periodic RPC (agent/reporter.py); diagnosis actions arrive on the
        ack."""
        from dlrover_tpu_torch.agent.reporter import StatusReporter

        self._status_reporter = StatusReporter(
            self._client,
            interval_s=DefaultValues.SEC_AGENT_HEARTBEAT_INTERVAL,
            on_actions=lambda actions: [
                self._handle_action(a) for a in actions
            ],
        )
        self._status_reporter.start()

    def _handle_action(self, action):
        cls = getattr(action, "action_cls", "")
        if cls == "RestartWorker":
            self._restart_requested.set()
        elif cls == "RelaunchWorker":
            logger.warning("master requested node relaunch; stopping agent")
            self._relaunch_requested = True
            self._stop_evt.set()

    def _install_signal_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            return

        def handle(signum, frame):
            # save-on-signal: the preemption grace window is the only time
            # to persist the staged checkpoint
            logger.warning("agent got signal %s; saving + stopping", signum)
            self._save_checkpoint_at_breakpoint()
            self._stop_evt.set()
            self._stop_workers(grace=5)
            raise SystemExit(143 if signum == signal.SIGTERM else 130)

        signal.signal(signal.SIGTERM, handle)

    # -- checkpoint hook ----------------------------------------------------

    def _save_checkpoint_at_breakpoint(self):
        if self._ckpt_saver is None:
            return
        t0 = time.perf_counter()
        try:
            ok = self._ckpt_saver.save_shm_to_storage()
        except Exception:
            logger.exception("breakpoint checkpoint persist failed")
            return
        logger.info("node %s: breakpoint persist %s in %.3fs",
                    self._config.node_id, ok, time.perf_counter() - t0)
