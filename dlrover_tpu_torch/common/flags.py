"""Typed ``DLROVER_TPU_*`` environment flags: the port's own copy of the
part of dlrover_tpu/common/flags.py it reads.

The names and defaults are the JAX package's, so one exported variable
flips both packages. Semantics are kept: the environment is re-read on
every ``get()``; an empty string is unset; a bool flag is ``raw != "0"``;
a value that fails to parse logs one warning and gives the default. A
flag's type is its default's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import logger


@dataclasses.dataclass(frozen=True)
class EnvFlag:
    """One environment flag of the type of its default (bool, int, float
    or str)."""

    name: str
    default: Any
    help: str = ""

    def get(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        kind = type(self.default)
        if kind is bool:
            return raw != "0"
        if kind is str:
            return raw
        try:
            return kind(raw)
        except ValueError:
            logger.warning("%s=%r is not a valid %s; using default %r",
                           self.name, raw, kind.__name__, self.default)
            return self.default

    def present(self) -> bool:
        """The variable is set to a non-empty value."""
        return os.environ.get(self.name, "") != ""


CHUNKED_CE = EnvFlag(
    "DLROVER_TPU_CHUNKED_CE", True,
    "Chunked fused cross-entropy kill-switch: 0 restores the dense "
    "[B,T,V] logits path (ops/chunked_ce.py). Read at every loss call.",
)

FUSED_CE = EnvFlag(
    "DLROVER_TPU_FUSED_CE", True,
    "Fused lm-head cross-entropy kernels (ops/fused_ce.py): 0 takes the "
    "chunked cross-entropy instead. Read at every loss call.",
)

# -- flash checkpoint (checkpoint/engine.py, checkpoint/saver.py)

ASYNC_STAGING = EnvFlag(
    "DLROVER_TPU_ASYNC_STAGING", True,
    "Checkpoint staging kill-switch: 0 stages shm copies synchronously "
    "on the training thread (checkpoint/engine.py).",
)
DEVICE_SNAPSHOT = EnvFlag(
    "DLROVER_TPU_DEVICE_SNAPSHOT", True,
    "0 disables the on-device state snapshot before async staging "
    "(falls back to blocking for the device-to-host copy).",
)
DRAIN_TIMEOUT = EnvFlag(
    "DLROVER_TPU_DRAIN_TIMEOUT", 20.0,
    "Seconds to wait for in-flight checkpoint staging at teardown; "
    "pair with the pod's terminationGracePeriodSeconds.",
)
CKPT_DEDUP = EnvFlag(
    "DLROVER_TPU_CKPT_DEDUP", True,
    "Replica-deduplicated checkpoint staging kill-switch "
    "(checkpoint/ownership.py): 0 stages one full copy per process.",
)
CKPT_LOCAL_DIR = EnvFlag(
    "DLROVER_TPU_CKPT_LOCAL_DIR", "",
    "Root of the node-local disk checkpoint tier (tier 1; a node-local "
    "SSD). Empty: <ckpt_dir>/_local. Each node writes under "
    "<root>/node-<id>.",
)
CKPT_PERSIST_WORKERS = EnvFlag(
    "DLROVER_TPU_CKPT_PERSIST_WORKERS", 4,
    "Concurrent leaf-file writers in the persist pool (local-tier "
    "writes and object-tier fanout run this many files in parallel).",
)
CKPT_REPLICA = EnvFlag(
    "DLROVER_TPU_CKPT_REPLICA", "",
    "Agent-set replica mode: exactly '1' streams staged checkpoints "
    "to the backup peer (checkpoint/replica.py).",
)
REPLICA_MAX_BYTES = EnvFlag(
    "DLROVER_TPU_REPLICA_MAX_BYTES", 64 << 30,
    "Replica server per-payload size bound (memory-DoS refusal).",
)

# -- agent wiring (NodeEnv names; injected by the agent/launcher)

NODE_ID = EnvFlag(
    NodeEnv.NODE_ID, 0,
    "This worker's node id (agent-injected).",
)
PROCESS_ID = EnvFlag(
    NodeEnv.PROCESS_ID, 0,
    "This worker's process index within its node (agent-injected).",
)
JOB_NAME = EnvFlag(
    NodeEnv.JOB_NAME, "local",
    "Job name: keys the shm segments.",
)
MASTER_ADDR = EnvFlag(
    NodeEnv.MASTER_ADDR, "",
    "host:port of the job master's endpoint (agent-injected).",
)
NODE_IP = EnvFlag(
    "DLROVER_TPU_NODE_IP", "",
    "This node's advertised IP (utils/net.py); empty: loopback.",
)
DIST_INIT_TIMEOUT = EnvFlag(
    "DLROVER_TPU_DIST_INIT_TIMEOUT", 120,
    "Seconds train/bootstrap.py's init_process_group waits for the world.",
)

# -- the data plane (master/shard/, train/data.py)

SHARD_LEASE_TTL_S = EnvFlag(
    "DLROVER_TPU_SHARD_LEASE_TTL_S", 120.0,
    "Seconds a batch shard lease stays valid without renewal; every "
    "folded WorkerReport renews it (zero extra RPCs), and expiry "
    "re-enqueues the undone shards at-least-once with the fence "
    "bumped so the zombie's late reports cannot double-count.",
)
SHARD_LEASE_COUNT = EnvFlag(
    "DLROVER_TPU_SHARD_LEASE_COUNT", 16,
    "Shards per lease_shards batch the worker's ShardingClient "
    "prefetches (completions of the previous batch ride the same "
    "RPC). 0 restores the one-task-per-get_task legacy protocol.",
)
PARAL_CONFIG_PATH = EnvFlag(
    "DLROVER_TPU_PARAL_CONFIG_PATH", "",
    "Path of the master-pushed runtime parallel-config JSON file.",
)

# -- the master's monitors (master/monitor/, master/metrics.py)

STRAGGLER_RATIO = EnvFlag(
    "DLROVER_TPU_STRAGGLER_RATIO", 1.5,
    "Straggler policy (master/monitor/straggler.py): a rank is slow "
    "when its windowed step-time p50 exceeds ratio x the fleet median.",
)
STRAGGLER_WINDOWS = EnvFlag(
    "DLROVER_TPU_STRAGGLER_WINDOWS", 3,
    "Consecutive slow digest windows before a rank is flagged as a "
    "straggler (and a StragglerRecord enters the diagnosis pipeline).",
)
MASTER_METRICS_PORT = EnvFlag(
    "DLROVER_TPU_MASTER_METRICS_PORT", 0,
    "Master /metrics port (goodput, RPC queue depth + shed counters, "
    "straggler count; 0 = ephemeral port; unset = disabled).",
)

# -- master relaunch continuity (master/state_store.py)

STATE_BACKEND = EnvFlag(
    "DLROVER_TPU_STATE_BACKEND", "",
    "Master state backend kind (memory | file | configmap); empty "
    "picks the platform default.",
)
STATE_DIR = EnvFlag(
    "DLROVER_TPU_STATE_DIR", "",
    "Root directory of the file state backend (master relaunch state).",
)

# -- the collective-hang watchdog (master/monitor/hang_watchdog.py)

HANG_WATCHDOG = EnvFlag(
    "DLROVER_TPU_HANG_WATCHDOG", True,
    "Master-side collective-hang watchdog "
    "(master/monitor/hang_watchdog.py): 0 disables the sweep thread. "
    "A round where every live worker is seated but step reports "
    "stopped fleet-wide for the window is declared a collective hang: "
    "downtime bracket opened, attributed to `collective_hang`, and "
    "the seated cohort re-rendezvoused without its silent members.",
)
HANG_WATCHDOG_WINDOW_S = EnvFlag(
    "DLROVER_TPU_HANG_WATCHDOG_WINDOW_S", 300.0,
    "Fleet-wide no-progress window before a seated round is declared "
    "a collective hang. Must comfortably exceed the step-report "
    "cadence and the longest legitimate pause (checkpoint save, "
    "eval); one slow RANK never trips it (that is the straggler "
    "detector's job).",
)

# -- the goodput planner (brain/planner.py)

PLANNER = EnvFlag(
    "DLROVER_TPU_PLANNER", False,
    "Arm the goodput planner (brain/planner.py): scale decisions are "
    "driven by the measured goodput ledger (digest p50s, the resize "
    "downtime, straggler flags) with payback-amortized scoring, "
    "hysteresis and cooldown, and scale-out waits for its executed plan "
    "(the rendezvous growth gate). Off by default.",
)
PLANNER_COOLDOWN_S = EnvFlag(
    "DLROVER_TPU_PLANNER_COOLDOWN_S", 300.0,
    "Seconds after an executed plan during which every decision is "
    "HOLD: at most one executed plan per cooldown window.",
)
PLANNER_HORIZON_S = EnvFlag(
    "DLROVER_TPU_PLANNER_HORIZON_S", 1800.0,
    "Payback horizon: a resize is accepted only if its predicted "
    "throughput gain amortizes the measured resize downtime within "
    "this many seconds.",
)
PLANNER_HYSTERESIS = EnvFlag(
    "DLROVER_TPU_PLANNER_HYSTERESIS", 2,
    "Consecutive decisions the same winning candidate must survive "
    "before it becomes a plan; instability (stragglers, open downtime) "
    "resets the streak.",
)
PLANNER_INTERVAL_S = EnvFlag(
    "DLROVER_TPU_PLANNER_INTERVAL_S", 30.0,
    "Decision cadence: planner.sweep() no-ops until this many seconds "
    "passed since the last decision.",
)
PLANNER_HBM_GB = EnvFlag(
    "DLROVER_TPU_PLANNER_HBM_GB", 0.0,
    "Per-device memory capacity (GB) for the planner's shrink-feasibility "
    "gate: with it set, a candidate whose projected occupancy (reported "
    "used x world/world') lands inside the headroom reserve is rejected. "
    "0 (default) = unknown, the gate is off.",
)
PLANNER_DCN_GBPS = EnvFlag(
    "DLROVER_TPU_PLANNER_DCN_GBPS", 25.0,
    "Assumed bandwidth (GB/s) of the slow link between slices, for "
    "converting measured per-step dcn bytes into predicted step seconds "
    "at candidate worlds.",
)

# -- diagnosis and the device timer (diagnosis/, profiler/tpu_timer.py)

DIAG_INTERVAL = EnvFlag(
    "DLROVER_TPU_DIAG_INTERVAL", 60.0,
    "Seconds between agent diagnosis collections.",
)
PEAK_TFLOPS = EnvFlag(
    "DLROVER_TPU_PEAK_TFLOPS", 0.0,
    "Override for the accelerator's peak TFLOPs in MFU accounting "
    "(0 = use the built-in per-chip table).",
)
TIMER_HANG_SECS = EnvFlag(
    "DLROVER_TPU_TIMER_HANG_SECS", 300,
    "Seconds a device execution may stay pending before the device "
    "timer flags a hang (read by the timer in each worker; the agent "
    "passes it on).",
)
STACK_DIR = EnvFlag(
    "DLROVER_TPU_STACK_DIR", "",
    "Directory a worker's SIGUSR2 stack dumps go to (the agent sets it; "
    "train/bootstrap.py installs the handler when it is set).",
)
