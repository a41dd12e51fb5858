"""The diagnosis chain's operators and the worker-log classifier: the
port's own copy of dlrover_tpu/diagnosis/operators.py.

``CheckTrainingHangOperator`` confirms a hang when every node's latest
device-timer record says hang and the fleet's step reports have been
silent for ``seconds_hang_threshold``; ``CheckFailureNodeOperator`` scans
the shipped log tails with ``classify_log``; ``ResolveTrainingHangOperator``
first asks every agent for a hang dump, then restarts all workers with the
dumps' dominant frame (``stuck_at``), their pending device programs and the
MFU ranking; ``ResolveFailureNodeOperator`` restarts or relaunches the
failed node.

Every JAX pattern of ``classify_log`` is kept, so a log either package's
worker writes is classified alike. Each tuple adds the torch/CUDA
counterparts of its class, and only those: a peer's death seen through a
``ProcessGroupNCCL`` or gloo connection closed by the peer, or an aborted
communicator; and the card's hardware faults, an uncorrectable ECC error,
an ``Xid`` and a GPU fallen off the bus.
"""

from __future__ import annotations

import re
import time
from typing import List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.data import (
    DiagnosisDataManager,
    DiagnosisDataType,
    HangDumpRecord,
    TpuMetricsRecord,
)
from dlrover_tpu_torch.diagnosis.inference import (
    Inference,
    InferenceAttribute,
    InferenceDescription,
    InferenceName,
    InferenceOperator,
)

#: the "is the training hanging?" problem the master periodically poses
HANG_PROBLEM = Inference(
    InferenceName.TRAINING, InferenceAttribute.ISORNOT, InferenceDescription.HANG
)
#: the "did a node fail?" problem
FAILURE_PROBLEM = Inference(
    InferenceName.NODE, InferenceAttribute.ISORNOT, InferenceDescription.FAILURE
)

# Failure signatures scanned from worker logs.
FATAL_PATTERNS = (
    r"Traceback \(most recent call last\)",
    r"FATAL|Fatal Python error",
    r"XlaRuntimeError",
)
# A *peer* died and the collective runtime tore this process down. The
# local host is healthy: restart and re-rendezvous. These are checked
# before HARDWARE_PATTERNS because JAX's generic peer-death message
# contains the words "preempted/died/restarted", which would otherwise read
# as a local preemption and make every surviving node exit.
PEER_FAILURE_PATTERNS = (
    r"JAX distributed service detected fatal errors",
    r"another task died",
    r"leader task was preempted",
    r"Failed to send RPC to coordination service",
    # torch.distributed: gloo's and ProcessGroupNCCL's view of a dead peer
    r"Connection closed by peer",
    r"communicator was aborted|aborted communicator",
)
RETRYABLE_PATTERNS = (
    r"RESOURCE_EXHAUSTED|out of memory|OOM",
    r"UNAVAILABLE|DEADLINE_EXCEEDED",
    r"coordination service|heartbeat",
)
HARDWARE_PATTERNS = (
    r"preempt|SIGTERM",
    r"ici link|chip failure|DATA_LOSS|hbm (ecc|parity|uncorrectable)",
    # the card's faults as the CUDA runtime and NVRM (Xid) report them
    r"uncorrectable ECC error|\bXid\b|GPU has fallen off the bus",
)


def classify_log(text: str) -> Optional[str]:
    """'hardware' | 'retryable' | 'fatal' | None from a worker log tail.

    Peer-death signatures win (the local host is fine: restart in place),
    then hardware/preemption (the node must be replaced), then transient
    retryables, then generic fatal tracebacks.
    """
    if not text:
        return None
    for pat in PEER_FAILURE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "retryable"
    for pat in HARDWARE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "hardware"
    for pat in RETRYABLE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "retryable"
    for pat in FATAL_PATTERNS:
        if re.search(pat, text):
            return "fatal"
    return None


class CheckTrainingHangOperator(InferenceOperator):
    """Hang iff every reporting node's latest tpu_timer metrics say hang,
    and the fleet has been silent for `silence_secs` of step reports."""

    def __init__(self, data_manager: DiagnosisDataManager, speed_monitor=None,
                 silence_secs=None, config=None):
        super().__init__(data_manager)
        self._speed_monitor = speed_monitor
        # None → runtime-tunable per-job config value at check time
        self._silence_secs_override = silence_secs
        self._config = config

    @property
    def _silence_secs(self) -> float:
        if self._silence_secs_override is not None:
            return self._silence_secs_override
        if self._config is None:
            from dlrover_tpu_torch.common.global_context import (
                MasterConfigContext,
            )

            self._config = MasterConfigContext()
        return self._config.seconds_hang_threshold

    def is_compatible(self, inference: Inference) -> bool:
        return inference == HANG_PROBLEM

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        latest = self._data_manager.latest_per_node(DiagnosisDataType.TPU_METRICS)
        records = [
            r for r in latest.values() if isinstance(r, TpuMetricsRecord)
        ]
        hang = bool(records) and all(r.hang for r in records)
        if hang and self._speed_monitor is not None:
            # corroborate with step-report silence
            sm = self._speed_monitor
            last_sample = getattr(sm, "_samples", None)
            if sm.completed_global_step > 0 and last_sample:
                silent = time.time() - last_sample[-1].timestamp
                hang = silent >= self._silence_secs
        attr = InferenceAttribute.IS if hang else InferenceAttribute.NOT
        return [Inference(InferenceName.TRAINING, attr, InferenceDescription.HANG)]


class CheckFailureNodeOperator(InferenceOperator):
    """Scan reported training logs for failure signatures per node."""

    def is_compatible(self, inference: Inference) -> bool:
        return inference == FAILURE_PROBLEM

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        out: List[Inference] = []
        for node_id, rec in self._data_manager.latest_per_node(
            DiagnosisDataType.TRAINING_LOG
        ).items():
            kind = classify_log(rec.data_content)
            if kind is None:
                continue
            out.append(
                Inference(
                    InferenceName.NODE,
                    InferenceAttribute.IS,
                    InferenceDescription.FAILURE,
                ).with_config(node_id=node_id, kind=kind)
            )
        if not out:
            out.append(
                Inference(
                    InferenceName.NODE,
                    InferenceAttribute.NOT,
                    InferenceDescription.FAILURE,
                )
            )
        return out


class ResolveTrainingHangOperator(InferenceOperator):
    """Confirmed hang -> orchestrated all-rank dump, THEN restart.

    Two-phase (reference ``manager.cc:454-464``: on hang the daemon runs
    gdb/py-spy against every rank before recovery):

    1. first cycle with a confirmed hang: emit ``collect_dumps`` — the
       master broadcasts a CollectHangDump action to every agent, which
       captures its workers' stacks + pending programs and ships them
       back;
    2. once every metrics-reporting node's dump arrived (or the wait
       budget lapsed): emit ``restart_all`` with the summarized dominant
       stack, pending program names, and the mfu straggler ranking — the
       restart event names WHERE the fleet is stuck and WHO is slow.
    """

    def __init__(self, data_manager, dump_wait_secs: float = 45.0):
        super().__init__(data_manager)
        self._dump_wait = dump_wait_secs
        self._dump_requested_at = 0.0
        self._last_hang_seen = 0.0

    def is_compatible(self, inference: Inference) -> bool:
        return inference == Inference(
            InferenceName.TRAINING, InferenceAttribute.IS, InferenceDescription.HANG
        )

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        now = time.time()
        # episode boundary: this resolver only runs while a hang is
        # confirmed, so a long gap since the last confirmation means the
        # previous episode cleared without a restart — start fresh rather
        # than summarizing its stale dumps into the NEW wedge's restart
        if (
            self._last_hang_seen
            and now - self._last_hang_seen > 2 * self._dump_wait + 60.0
        ):
            self._dump_requested_at = 0.0
        self._last_hang_seen = now
        if self._dump_requested_at == 0.0:
            self._dump_requested_at = now
            return [
                Inference(
                    InferenceName.ACTION, InferenceAttribute.IS,
                    "collect_dumps",
                ).with_config(reason="training_hang")
            ]
        if now - self._dump_requested_at < self._dump_wait:
            fresh = self._fresh_dump_nodes()
            reporting = self._data_manager.latest_per_node(
                DiagnosisDataType.TPU_METRICS
            )
            if reporting and not set(reporting).issubset(fresh):
                return []  # dumps still in flight; hold the restart
        cfg = {"reason": "training_hang"}
        try:
            # agent-shipped JSON; malformed shapes must never block the
            # restart_all action that breaks the actual hang. Only this
            # episode's dumps are summarized — agents may have auto-dumped
            # locally shortly BEFORE the master's request (same episode),
            # hence the grace window; it stays below the episode gap so a
            # cleared hang's dumps can never leak into a new one.
            cfg.update(self._summarize_dumps(
                min_ts=self._dump_requested_at - 2 * self._dump_wait
            ))
        except Exception as e:
            logger.warning("hang-dump summarization failed: %s", e)
        self._dump_requested_at = 0.0
        return [
            Inference(
                InferenceName.ACTION, InferenceAttribute.IS, "restart_all"
            ).with_config(**cfg)
        ]

    def _fresh_dump_nodes(self) -> set:
        return {
            node_id
            for node_id, rec in self._data_manager.latest_per_node(
                DiagnosisDataType.HANG_DUMP
            ).items()
            if isinstance(rec, HangDumpRecord)
            and rec.timestamp >= self._dump_requested_at
        }

    def _summarize_dumps(self, min_ts: float = 0.0) -> dict:
        from dlrover_tpu_torch.profiler.analysis import StackTrie

        dumps = [
            r
            for r in self._data_manager.latest_per_node(
                DiagnosisDataType.HANG_DUMP
            ).values()
            if isinstance(r, HangDumpRecord) and r.timestamp >= min_ts
        ]
        if not dumps:
            return {}
        trie = StackTrie()
        pending_names = set()
        for rec in dumps:
            for text in rec.stacks.values():
                # main_only: each worker carries several identical idle
                # helper threads; weighting only the "Current thread"
                # section keeps stuck_at pointing at the hung collective
                # rather than a parked pool worker.
                trie.add_dump(text, main_only=True)
            for rank in rec.pending.values():
                for prog in rank.get("pending", []):
                    name = prog.get("name") if isinstance(prog, dict) else prog
                    if name:
                        pending_names.add(str(name))
        out: dict = {"hang_dump_hosts": len(dumps)}
        hot = trie.hot_path()
        if hot:
            out["stuck_at"] = hot[-1]
        if pending_names:
            # config values travel as strings; keep the list greppable
            out["pending_programs"] = ",".join(sorted(pending_names)[:8])
        ranking = rank_stragglers_by_mfu(self._data_manager)
        if ranking:
            out["mfu_ranking"] = ",".join(
                f"{nid}:{mfu:.3f}" for nid, mfu in ranking[:8]
            )
            out["slowest_node"] = str(ranking[0][0])
        return out


def rank_stragglers_by_mfu(data_manager) -> List:
    """[(node_id, mfu)] slowest-first from the interposer's live MFU gauge
    (per-program cost attribution / peak) — the diagnosis straggler
    ranking the reference derives from per-kernel throughput buckets
    (``common/bvar_prometheus.cc``)."""
    latest = data_manager.latest_per_node(DiagnosisDataType.TPU_METRICS)
    ranked = [
        (node_id, float(rec.mfu))
        for node_id, rec in latest.items()
        if isinstance(rec, TpuMetricsRecord) and rec.mfu > 0
    ]
    ranked.sort(key=lambda kv: kv[1])
    return ranked


class ResolveFailureNodeOperator(InferenceOperator):
    """Confirmed node failure -> restart (retryable) or relaunch (fatal on
    repeated restarts is decided by the agent's restart budget; hardware or
    preemption kinds relaunch immediately)."""

    def is_compatible(self, inference: Inference) -> bool:
        return (
            inference.name == InferenceName.NODE
            and inference.attribution == InferenceAttribute.IS
            and inference.description == InferenceDescription.FAILURE
        )

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        out = []
        for inf in inferences:
            cfg = inf.config()
            # hardware/preemption: the host is suspect -> replace it;
            # everything else restarts in place (agent budget governs)
            action = "relaunch" if cfg.get("kind") == "hardware" else "restart"
            out.append(
                Inference(
                    InferenceName.ACTION, InferenceAttribute.IS, action
                ).with_config(**cfg)
            )
        return out
