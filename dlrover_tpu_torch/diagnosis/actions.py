"""Diagnosis actions: what the system decides to do about a problem. The
port's own copy of dlrover_tpu/diagnosis/actions.py (NoAction,
EventAction and the node actions, with the JAX expiry). The wire form is the
``messages.DiagnosisAction`` dataclass; this module gives the typed
vocabulary + constructors so master code never hand-writes action strings.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from dlrover_tpu_torch.common.messages import DiagnosisAction


class ActionCls:
    NO_ACTION = "NoAction"
    EVENT = "EventAction"
    RESTART_WORKER = "RestartWorker"  # in-place process restart by the agent
    RELAUNCH_WORKER = "RelaunchWorker"  # node replaced by the platform
    MASTER_STOP_JOB = "StopJob"
    #: master-orchestrated synchronized debug dump: every agent captures
    #: its workers' stacks + pending programs NOW and ships them back
    #: (reference manager.cc:454-464 all-rank gdb/py-spy dump)
    COLLECT_DUMP = "CollectHangDump"


DEFAULT_ACTION_EXPIRY_SECS = 120.0


def no_action() -> DiagnosisAction:
    return DiagnosisAction(action_cls=ActionCls.NO_ACTION)


def event_action(
    reason: str, msg: str = "", instance: int = -1, expiry: float = DEFAULT_ACTION_EXPIRY_SECS
) -> DiagnosisAction:
    return DiagnosisAction(
        action_cls=ActionCls.EVENT,
        action_content=json.dumps({"reason": reason, "msg": msg}),
        instance=instance,
        expired_ts=time.time() + expiry,
    )


def restart_worker(
    node_id: int, reason: str = "", expiry: float = DEFAULT_ACTION_EXPIRY_SECS
) -> DiagnosisAction:
    return DiagnosisAction(
        action_cls=ActionCls.RESTART_WORKER,
        action_content=reason,
        instance=node_id,
        expired_ts=time.time() + expiry,
    )


def relaunch_worker(
    node_id: int, reason: str = "", expiry: float = DEFAULT_ACTION_EXPIRY_SECS
) -> DiagnosisAction:
    return DiagnosisAction(
        action_cls=ActionCls.RELAUNCH_WORKER,
        action_content=reason,
        instance=node_id,
        expired_ts=time.time() + expiry,
    )


def collect_dump(
    node_id: int, reason: str = "hang",
    expiry: float = DEFAULT_ACTION_EXPIRY_SECS,
) -> DiagnosisAction:
    return DiagnosisAction(
        action_cls=ActionCls.COLLECT_DUMP,
        action_content=reason,
        instance=node_id,
        expired_ts=time.time() + expiry,
    )


def stop_job(reason: str) -> DiagnosisAction:
    return DiagnosisAction(
        action_cls=ActionCls.MASTER_STOP_JOB, action_content=reason, instance=-1
    )


def is_actionable(action: Optional[DiagnosisAction]) -> bool:
    return action is not None and action.action_cls not in ("", ActionCls.NO_ACTION)
