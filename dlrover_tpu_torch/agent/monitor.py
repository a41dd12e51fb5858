"""Per-node resource readings for the agent's status report: the port's own
copy of dlrover_tpu/agent/monitor.py.

Host CPU and memory come from ``psutil``, which stays optional as in the
JAX package (0.0 without it). The device reading is the GPU's memory in
use, summed over the node's cards as ``nvidia-smi`` reports it (0.0 where
there is none); the agent never opens a CUDA context of its own, which
would take memory on the card its workers train on. It travels in the JAX
wire's ``tpu_hbm_used_mb`` field; the duty cycle is not read yet (0.0).
"""

from __future__ import annotations

import shutil
import subprocess

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


def get_process_cpu_percent() -> float:
    if psutil is None:
        return 0.0
    try:
        return psutil.cpu_percent(interval=None) / 100.0
    except Exception:
        return 0.0


def get_used_memory_mb() -> float:
    if psutil is None:
        return 0.0
    try:
        mem = psutil.virtual_memory()
        return float(mem.used) / (1024 * 1024)
    except Exception:
        return 0.0


def get_device_metrics() -> dict:
    """``{"duty_cycle", "hbm_used_mb"}`` of this node's cards: the GPU
    memory in use (MiB, summed over cards); zeros without a card."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {"duty_cycle": 0.0, "hbm_used_mb": 0.0}
    try:
        out = subprocess.run(
            [smi, "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout
        used = sum(float(x) for x in out.split() if x.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        used = 0.0
    return {"duty_cycle": 0.0, "hbm_used_mb": used}
