"""Worker-process bootstrap: the in-training-process face of the control
plane. The port's own copy of dlrover_tpu/train/bootstrap.py.

A script the agent starts calls::

    from dlrover_tpu_torch.train import bootstrap
    ctx = bootstrap.init()   # process group up, master client connected

which (a) reads the environment the elastic agent injected, (b) forms the
process group where the JAX package calls ``jax.distributed.initialize``:
``torch.distributed.init_process_group`` at ``tcp://<coordinator_addr>``,
NCCL on the local rank's card for ``cuda`` and gloo for ``cpu``, only when
the world has more than one process and a coordinator, and (c) connects the
master client for the step and checkpoint reports. A step report drains a
window of the caller's step-time digest (observability/digest.py) with the
seconds the steps waited for input since the last report. Known
difference: the JAX worker reads that wait from its trace ring's
``input_wait`` spans; the port has no trace ring, so the caller adds its
measured waits (``add_input_wait``: ``run/llama_pretrain.py``'s wait for
each batch on the prefetch). ``poll_speculation_hint`` reads the goodput
planner's intended next world from the membership poll and arms the
trainer with it (brain/planner.py). With ``DLROVER_TPU_STACK_DIR`` set
(the agent sets it) ``init`` registers the SIGUSR2 all-thread stack dumper
the agent's hang dumper triggers (profiler/hang_dump.py). The JAX
bootstrap's tracer, stack sampler and compile cache wait for the profiler
slice (ROADMAP.md).
"""

from __future__ import annotations

import atexit
import datetime
import os
import time
from dataclasses import dataclass
from typing import List, Optional

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import digest as digest_mod


@dataclass
class WorkerEnv:
    job_name: str = "local"
    master_addr: str = ""
    node_id: int = 0
    node_rank: int = 0
    node_num: int = 1
    coordinator_addr: str = ""
    process_id: int = 0
    num_processes: int = 1
    restart_count: int = 0
    accelerator: str = "cuda"
    local_rank: int = 0
    num_slices: int = 1

    @classmethod
    def from_env(cls) -> "WorkerEnv":
        e = os.environ
        return cls(
            job_name=e.get(NodeEnv.JOB_NAME, "local"),
            master_addr=e.get(NodeEnv.MASTER_ADDR, ""),
            node_id=int(e.get(NodeEnv.NODE_ID, "0")),
            node_rank=int(e.get(NodeEnv.NODE_RANK, "0")),
            node_num=int(e.get(NodeEnv.NODE_NUM, "1")),
            coordinator_addr=e.get(NodeEnv.COORDINATOR_ADDR, ""),
            process_id=int(e.get(NodeEnv.PROCESS_ID, "0")),
            num_processes=int(e.get(NodeEnv.NUM_PROCESSES, "1")),
            restart_count=int(e.get(NodeEnv.RESTART_COUNT, "0")),
            accelerator=e.get("DLROVER_TPU_ACCELERATOR", "cuda"),
            local_rank=int(e.get("DLROVER_TPU_LOCAL_RANK", "0")),
            num_slices=int(e.get("DLROVER_TPU_NUM_SLICES", "1") or 1),
        )


class WorkerContext:
    """What a training process holds after ``init()``."""

    def __init__(self, env: WorkerEnv, client=None):
        self.env = env
        self.client = client
        self._last_report_ts = 0.0
        self.step_report_interval = 15.0
        #: seconds the steps waited for input since the last drained
        #: window (add_input_wait)
        self._input_wait_s = 0.0
        #: a drained window whose report failed, sent with the next one
        self._unreported_digest = None

    @property
    def process_id(self) -> int:
        return self.env.process_id

    @property
    def num_processes(self) -> int:
        return self.env.num_processes

    @property
    def local_rank(self) -> int:
        return self.env.local_rank

    @property
    def processes_per_node(self) -> int:
        """Worker processes (one a card) each node of the world runs, from
        the environment the agent set: the world's processes over its
        nodes."""
        return max(1, self.env.num_processes // max(1, self.env.node_num))

    def poll_speculation_hint(self, trainer) -> Optional[dict]:
        """Fetch the goodput planner's intended-next-world hint from the
        membership poll and arm the trainer with it (brain/planner.py).
        The master plans in nodes; the hint scales by the processes a node
        runs (``processes_per_node``, from the agent's environment: the
        port runs one process a card, where the JAX worker multiplies by
        ``jax.local_device_count()``), so the trainer records the process
        world the planner-directed resize will seat. A missing or empty
        hint arms nothing and returns None: a master without a planner,
        or with no executed intent, is harmless."""
        if self.client is None:
            return None
        try:
            hint = self.client.speculation_hint()
        except Exception as e:
            logger.debug("speculation-hint poll failed: %s", e)
            return None
        if not hint:
            return None
        world_nodes = int(hint.get("world", 0) or 0)
        if world_nodes <= 0:
            return None
        trainer.set_speculation_hint(
            world_nodes * self.processes_per_node,
            n_slices=int(hint.get("n_slices", 0) or 0) or None,
        )
        return hint

    def add_input_wait(self, seconds: float):
        """Add a step's wait for its input (the digest's ``input_wait_s``
        is the sum since the last report)."""
        self._input_wait_s += max(0.0, float(seconds))

    def report_step(self, step: int, force: bool = False, digest=None):
        """Throttled global-step report feeding the master's speed monitor
        (one every ``step_report_interval`` seconds, or now with
        ``force``).

        ``digest``: a :class:`~dlrover_tpu_torch.observability.digest.
        StepTimeDigest` the caller folds per-step wall times into; the
        report drains one window from it (count/mean/p50/p95/max) and
        attaches the input-wait seconds since the last report. A window
        whose report failed rides the next report (``merge_windows``)."""
        if self.client is None:
            return
        now = time.time()
        if not force and now - self._last_report_ts < self.step_report_interval:
            return
        payload = digest.snapshot_and_reset() if digest is not None else None
        if payload:
            payload["input_wait_s"] = round(self._input_wait_s, 6)
            self._input_wait_s = 0.0
            digest_mod.set_last_window(payload)
        if self._unreported_digest:
            payload = digest_mod.merge_windows(self._unreported_digest,
                                               payload)
            self._unreported_digest = None
        try:
            self.client.report_global_step(step, digest=payload)
            self._last_report_ts = now
        except Exception as e:
            self._unreported_digest = payload
            logger.warning("step report failed: %s", e)


_context: Optional[WorkerContext] = None


def init() -> WorkerContext:
    """Bootstrap this training process; idempotent."""
    global _context
    if _context is not None:
        return _context
    env = WorkerEnv.from_env()
    # hang diagnosis: register the SIGUSR2 all-thread stack dumper the
    # agent's HangDumper triggers (profiler/hang_dump.py)
    stack_dir = flags.STACK_DIR.get()
    if stack_dir:
        try:
            from dlrover_tpu_torch.profiler.hang_dump import (
                install_stack_dump_handler,
            )

            install_stack_dump_handler(stack_dir)
        except Exception:
            logger.exception("stack-dump handler install failed; continuing")
    if env.num_processes > 1 and env.coordinator_addr:
        import torch
        import torch.distributed as dist

        if env.accelerator == "cpu":
            backend, device_id = "gloo", None
        else:
            backend = "nccl"
            device_id = torch.device("cuda", env.local_rank)
            torch.cuda.set_device(device_id)
        logger.info(
            "process %s/%s: init_process_group(%s, tcp://%s)",
            env.process_id, env.num_processes, backend, env.coordinator_addr,
        )
        dist.init_process_group(
            backend=backend,
            init_method=f"tcp://{env.coordinator_addr}",
            world_size=env.num_processes,
            rank=env.process_id,
            timeout=datetime.timedelta(
                seconds=int(flags.DIST_INIT_TIMEOUT.get())),
            device_id=device_id,
        )
    client = None
    if env.master_addr:
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient(env.master_addr, env.node_id)
    _context = WorkerContext(env, client)
    atexit.register(_shutdown)
    return _context


def get_context() -> Optional[WorkerContext]:
    return _context


def process_count() -> int:
    """The default process group's world size; 1 without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default process group; 0 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def worker_mesh(device_type: str = "cuda", config=None):
    """The worker's ``DeviceMesh`` over the default process group:
    ``config`` (a ``parallel.MeshConfig``; dp -1 absorbs the world, so
    ``MeshConfig(fsdp=2)`` on four processes is dp2 x fsdp2) resolved on
    the group's world size, pure dp when None, built by
    ``parallel.mesh_for`` (``device_type`` "cuda", or "cpu" for gloo);
    None in a world of one, which has no group."""
    n = process_count()
    if n == 1:
        return None
    from dlrover_tpu_torch.common.world import WorldDescriptor
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, mesh_for

    sizes = (config or MeshConfig()).resolve(n).shape()
    return mesh_for(WorldDescriptor.from_axis_sizes(sizes), device_type)


def collective_device():
    """The device the default group's collectives take their tensors on:
    the current card for NCCL, the CPU for gloo. A NCCL collective handed a
    CPU tensor raises; nothing is routed to another backend."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(value: int) -> List[int]:
    """Every process's ``value``, in rank order (``[value]`` without a
    group): the counterpart of ``multihost_utils.process_allgather`` for
    one integer."""
    if process_count() == 1:
        return [int(value)]
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [int(x.item()) for x in out]


def _shutdown():
    global _context
    _context = None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
