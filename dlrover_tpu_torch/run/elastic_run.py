"""The elastic launcher CLI: the port's own copy of
dlrover_tpu/run/elastic_run.py.

``--standalone`` spawns a local master (``python -m
dlrover_tpu_torch.master.main``), then runs this host's elastic agent,
which rendezvouses and supervises the worker processes::

    PYTHONPATH=<repo> python -m dlrover_tpu_torch.run.elastic_run \\
        --standalone --nnodes=1 --nproc_per_node=1 train.py -- --lr 3e-4
    python -m dlrover_tpu_torch.run.elastic_run --master_addr=10.0.0.1:5555 \\
        --nnodes=2:4 --node_id=1 train.py

The agent runs ``[python, <script>] + <args>``: a script of this package
run by its path needs the repo on ``PYTHONPATH``, as for the JAX launcher.
The workers run on the card (``--accelerator cuda``, the default) or, in
the test mode, on the CPU (``--accelerator cpu``). ``--tpu-timer`` runs
them under the device timer (profiler/tpu_timer.py; local rank r serves
its metrics on ``--tpu-timer-port`` + r); a timer that fails to build or
load ends the launcher with exit code 1. The JAX launcher's network check,
comm-metrics, compile-cache and replica options wait for their modules
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.agent.config import ACCELERATORS, ElasticLaunchConfig
from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import TpuTimerConsts
from dlrover_tpu_torch.common.log import logger

#: seconds the launcher waits for a spawned master to report its port
MASTER_START_TIMEOUT_S = 60


def parse_nnodes(value: str) -> Tuple[int, int]:
    if ":" in value:
        lo, hi = value.split(":", 1)
        return int(lo), int(hi)
    n = int(value)
    return n, n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "dlrover_tpu_torch.run.elastic_run",
        description="elastic launcher for PyTorch workers",
    )
    p.add_argument("--standalone", action="store_true",
                   help="spawn a local job master for single-node runs")
    p.add_argument("--master_addr", default=flags.MASTER_ADDR.get(),
                   help="host:port of the job master")
    p.add_argument("--nnodes", default="1", help="N or MIN:MAX nodes")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes per host")
    p.add_argument("--node_id", type=int, default=int(flags.NODE_ID.get()))
    p.add_argument("--job_name", default="dlrover-tpu-job")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--accelerator", default="cuda", choices=ACCELERATORS)
    p.add_argument("--monitor_interval", type=float, default=2.0)
    p.add_argument("--tpu-timer", action="store_true", dest="tpu_timer",
                   help="time the workers' NCCL collectives and steps on "
                        "the card (the device timer)")
    p.add_argument("--tpu-timer-port", type=int,
                   default=TpuTimerConsts.DEFAULT_PORT, dest="tpu_timer_port")
    p.add_argument("training_script", help="path to the training script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def _launch_local_master(node_num: int) -> Tuple[subprocess.Popen, str]:
    """Spawn ``python -m dlrover_tpu_torch.master.main`` and wait for its
    port."""
    fd, port_file = tempfile.mkstemp(prefix="dlrover_tpu_master_port_")
    os.close(fd)
    os.unlink(port_file)  # the master writes it whole once serving
    proc = subprocess.Popen(
        [
            sys.executable,
            "-m",
            "dlrover_tpu_torch.master.main",
            "--platform",
            "local",
            "--node_num",
            str(node_num),
            "--port_file",
            port_file,
        ],
        start_new_session=True,
    )
    deadline = time.time() + MASTER_START_TIMEOUT_S
    while time.time() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                content = f.read().strip()
            os.unlink(port_file)
            return proc, f"127.0.0.1:{content}"
        if proc.poll() is not None:
            raise RuntimeError("local master exited during startup")
        time.sleep(0.2)
    proc.kill()
    raise RuntimeError(
        f"local master did not report its port in {MASTER_START_TIMEOUT_S}s")


def _strip_leading_separator(script_args: List[str]) -> List[str]:
    """Drop only a single leading ``--`` (launcher/script separator); any
    later ``--`` belongs to the user's script."""
    if script_args and script_args[0] == "--":
        return list(script_args[1:])
    return list(script_args)


def config_from_args(args) -> ElasticLaunchConfig:
    min_nodes, max_nodes = parse_nnodes(args.nnodes)
    config = ElasticLaunchConfig(
        min_nodes=min_nodes,
        max_nodes=max_nodes,
        nproc_per_node=args.nproc_per_node,
        node_id=args.node_id,
        job_name=args.job_name,
        master_addr=args.master_addr,
        max_restarts=args.max_restarts,
        accelerator=args.accelerator,
        monitor_interval=args.monitor_interval,
        tpu_timer=args.tpu_timer,
        tpu_timer_port=args.tpu_timer_port,
        entrypoint=args.training_script,
        entrypoint_args=_strip_leading_separator(args.training_script_args),
    )
    return config.auto_configure()


def _stop_master(proc: subprocess.Popen, timeout: float = 30.0):
    """Let a master that saw the job end exit on its own (it logs the
    exit reason), else terminate it."""
    try:
        proc.wait(timeout=timeout)
        return
    except subprocess.TimeoutExpired:
        proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def run(args) -> int:
    master_proc: Optional[subprocess.Popen] = None
    _, max_nodes = parse_nnodes(args.nnodes)
    rc = 1
    try:
        if args.standalone and not args.master_addr:
            master_proc, args.master_addr = _launch_local_master(max_nodes)
            logger.info("standalone master at %s", args.master_addr)
        if not args.master_addr:
            logger.error("--master_addr required (or use --standalone)")
            rc = 2
            return rc
        config = config_from_args(args)
        client = MasterClient(args.master_addr, config.node_id)
        if not client.available(timeout=30):
            logger.error("master %s not reachable", args.master_addr)
            rc = 3
            return rc
        try:
            agent = ElasticAgent(config, client)
        except RuntimeError as e:
            logger.error("agent setup failed: %s", e)
            rc = 1
            return rc
        rc = agent.run()
        return rc
    finally:
        if master_proc is not None:
            # after a clean run the master is concluding the job; any
            # other exit leaves it waiting for workers that will not come
            _stop_master(master_proc, timeout=30.0 if rc == 0 else 0.0)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
