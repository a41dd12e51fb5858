"""Agent-side diagnosis: restart in place or hand the node back. The port's
own copy of ``WorkerAction``, ``WorkerFailure`` and
``diagnose_training_failure`` of dlrover_tpu/agent/diagnosis_agent.py.

The decision lives in the agent because it is the one place that knows the
restart budget and sees the worker log before the master does. The JAX
agent's periodic observe loop ships metric sources the port does not have
yet (the device timer, the comm ledger, hang dumps) and waits for them.
"""

from __future__ import annotations

from dataclasses import dataclass

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.operators import classify_log


class WorkerAction:
    RESTART_WORKER = "restart"  # respawn processes on this host
    RELAUNCH_WORKER = "relaunch"  # exit; platform replaces this host


@dataclass
class WorkerFailure:
    node_id: int
    restart_count: int
    max_restarts: int
    exit_code: int = 1
    log_tail: str = ""


def diagnose_training_failure(failure: WorkerFailure) -> str:
    """Hardware or preemption signatures relaunch the node; any other
    failure (retryable, fatal or unclassified) restarts in place while the
    budget lasts, then relaunches. Logs the log tail's class."""
    kind = classify_log(failure.log_tail)
    budget_left = failure.restart_count < failure.max_restarts
    if kind == "hardware":
        action = WorkerAction.RELAUNCH_WORKER
    elif budget_left:
        action = WorkerAction.RESTART_WORKER
    else:
        action = WorkerAction.RELAUNCH_WORKER
    logger.warning(
        "node %s: worker failure (exit %s) classified %s -> %s "
        "(restarts %s/%s)", failure.node_id, failure.exit_code, kind,
        action, failure.restart_count, failure.max_restarts,
    )
    return action
