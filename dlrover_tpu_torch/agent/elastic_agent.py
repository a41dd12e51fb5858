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
the workers restarted in place while the restart budget lasts. It runs the
parallel-config tuner (agent/paral_config_tuner.py), which writes the
master's pushed config to a file whose path the workers get in
``DLROVER_TPU_PARAL_CONFIG_PATH``.

Its diagnosis agent (agent/diagnosis_agent.py) ships the workers' log
tails to the master every ``DLROVER_TPU_DIAG_INTERVAL`` seconds. With
``tpu_timer`` the workers run under the device timer
(profiler/tpu_timer.py: ``LD_PRELOAD`` of ``csrc/cuda_hook.cc``, local
rank r serving on ``tpu_timer_port + r``); the diagnosis agent ships its
scrape too and, on a hang it flags or the master's ``CollectHangDump``,
the workers' stacks and pending programs (profiler/hang_dump.py; each
worker's SIGUSR2 dumps land under ``<log dir>/hang``). A timer that fails
to build or to load stops the agent: the JAX agent logs it and runs on
untimed (ROADMAP.md's known differences).

The JAX agent's comm metrics, metric endpoints and replica peer sync wait
for their modules (ROADMAP.md).
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
    DiagnosisAgent,
    WorkerAction,
    WorkerFailure,
)
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import (
    CommWorld,
    MasterRendezvousHandler,
    RendezvousTimeoutError,
)
from dlrover_tpu_torch.common import flags
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
        self._paral_tuner = None
        self._diagnosis = DiagnosisAgent(
            client=self._client, node_id=config.node_id,
            interval_secs=max(float(flags.DIAG_INTERVAL.get()), 1.0),
        )
        self._diagnosis.set_log_source(self._last_worker_log_tail)
        self._tpu_timer_env: Dict[str, str] = {}
        self._hang_dumper = None
        if config.tpu_timer:
            self._setup_tpu_timer()

    def _setup_tpu_timer(self):
        """Build the device timer, check that it loads, and scrape each
        local rank's metrics (port base + local rank) into diagnosis.
        Raises ``RuntimeError`` when the build or the load check fails:
        a job asked to run timed never runs untimed."""
        from dlrover_tpu_torch.profiler.hang_dump import HangDumper
        from dlrover_tpu_torch.profiler.tpu_timer import (
            TpuTimerMetricsSource,
            interposer_env,
            verify_interposer,
        )

        try:
            self._tpu_timer_env = interposer_env(
                port=self._config.tpu_timer_port)
        except subprocess.CalledProcessError as e:
            out = e.output.decode(errors="replace") if isinstance(
                e.output, bytes) else str(e.output or "")
            raise RuntimeError(
                f"tpu_timer native build failed:\n{out[-2000:]}") from e
        verify_interposer(self._tpu_timer_env["LD_PRELOAD"],
                          self._config.accelerator)
        ports = [self._config.tpu_timer_port + i
                 for i in range(self._config.nproc_per_node)]
        self._diagnosis.set_metrics_source(TpuTimerMetricsSource(ports))
        self._hang_dumper = HangDumper(
            stack_dir=os.path.join(self._log_dir, "hang"),
            metrics_ports=ports,
        )
        self._diagnosis.set_hang_dumper(self._hang_dumper)
        logger.info("node %s: tpu_timer on ports %s (%s)",
                    self._config.node_id, ports,
                    self._tpu_timer_env["LD_PRELOAD"])

    # -- lifecycle ----------------------------------------------------------

    def run(self) -> int:
        self._client.report_node_address(self._node_ip)
        self._start_ckpt_saver()
        self._start_heartbeats()
        self._install_signal_handlers()
        self._diagnosis.start()
        self._start_paral_config_tuner()
        try:
            return self._invoke_run()
        finally:
            self._stop_evt.set()
            if self._status_reporter is not None:
                self._status_reporter.stop()
            self._diagnosis.stop()
            if self._paral_tuner is not None:
                self._paral_tuner.stop()
            self._stop_workers()
            if self._ckpt_saver is not None:
                self._ckpt_saver.stop()

    def _start_paral_config_tuner(self):
        from dlrover_tpu_torch.agent.paral_config_tuner import (
            ParalConfigTuner,
        )

        try:
            self._paral_tuner = ParalConfigTuner(
                self._client,
                job_name=self._config.job_name,
                node_id=self._config.node_id,
            )
            self._paral_tuner.start()
        except Exception:
            logger.exception("paral config tuner failed to start")
            self._paral_tuner = None

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
            action = self._diagnosis.diagnose_training_failure(
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
                # workers install a SIGUSR2 faulthandler writing here; the
                # agent's HangDumper signals + collects on a hang
                "DLROVER_TPU_STACK_DIR": os.path.join(self._log_dir, "hang"),
            }
        )
        if self._tpu_timer_env:
            preload = env.get("LD_PRELOAD")
            env.update(self._tpu_timer_env)
            if preload:  # the hook first, the caller's libraries kept
                env["LD_PRELOAD"] += ":" + preload
            # one metrics server per local rank
            env["DLROVER_TPU_TIMER_PORT"] = str(
                self._config.tpu_timer_port + local_rank)
        if self._paral_tuner is not None:
            from dlrover_tpu_torch.agent.paral_config_tuner import (
                PARAL_CONFIG_PATH_ENV,
            )

            env[PARAL_CONFIG_PATH_ENV] = self._paral_tuner.path
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
        if self._hang_dumper is not None:
            self._hang_dumper.set_workers(
                [w.proc.pid for w in self._workers])

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

    def _last_worker_log_tail(self, max_bytes: int = 4096) -> str:
        """Concatenated log tails across all local workers (any process on
        this host may carry the failure signature)."""
        workers = list(self._workers)
        if not workers:
            return ""
        per = max(512, max_bytes // len(workers))
        return "\n".join(
            t for t in (self._tail_log(w.log_path, per) for w in workers) if t
        )

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
            logger.warning("node %s: master requested a restart (%s), "
                           "seen at %.3f", self._config.node_id,
                           action.action_content, time.time())
            self._restart_requested.set()
        elif cls == "RelaunchWorker":
            logger.warning("master requested node relaunch; stopping agent")
            self._relaunch_requested = True
            self._stop_evt.set()
        elif cls == "CollectHangDump":
            logger.warning("node %s: master requested a hang dump (%s), "
                           "seen at %.3f", self._config.node_id,
                           action.action_content, time.time())
            # synchronized cross-node dump: off the heartbeat thread (the
            # dump settles ~1.5s waiting for SIGUSR2 stacks to land)
            threading.Thread(
                target=self._diagnosis.collect_and_ship_dump,
                kwargs={"reason": action.action_content or "master_request"},
                name="collect-dump",
                daemon=True,
            ).start()

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
