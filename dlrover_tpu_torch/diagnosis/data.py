"""Diagnosis data: what the master and the agent reason over. The port's
own copy of dlrover_tpu/diagnosis/data.py: the record classes, their
``data_cls`` names on the wire, ``parse_report`` and the sliding-window
``DiagnosisDataManager``. A ``TpuMetricsRecord`` keeps its JAX name; on the
card its numbers come from the device timer (profiler/tpu_timer.py: NCCL
collectives and the trainer's step timed by CUDA events).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Type


class DiagnosisDataType:
    GENERIC = "generic"
    TRAINING_LOG = "training_log"
    TPU_METRICS = "tpu_metrics"
    ACCEL_METRICS = "accel_metrics"  # external exporter scrape tier
    RESOURCE_USAGE = "resource_usage"
    HANG_DUMP = "hang_dump"  # all-rank stacks + pending device programs
    COMM_METRICS = "comm_metrics"  # per-collective attribution rollup
    STRAGGLER = "straggler"  # runtime step-digest straggler flags


class DiagnosisData:
    """One observation shipped agent->master (or collected in-master)."""

    def __init__(
        self,
        data_type: str = DiagnosisDataType.GENERIC,
        data_content: str = "",
        node_id: int = -1,
        node_type: str = "",
        node_rank: int = -1,
        timestamp: float = 0.0,
    ):
        self.data_type = data_type
        self.data_content = data_content
        self.node_id = node_id
        self.node_type = node_type
        self.node_rank = node_rank
        self.timestamp = timestamp or time.time()

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @classmethod
    def from_json(cls, text: str) -> "DiagnosisData":
        data = cls()
        try:
            data.__dict__.update(json.loads(text))
        except (ValueError, TypeError):
            data.data_content = text
        return data


class TrainingLogRecord(DiagnosisData):
    """Tail of a worker's log, scanned for failure signatures."""

    def __init__(self, logs: Optional[List[str]] = None, **kw):
        kw.setdefault("data_type", DiagnosisDataType.TRAINING_LOG)
        super().__init__(**kw)
        if logs is not None:
            self.data_content = "\n".join(logs)

    @property
    def logs(self) -> List[str]:
        return self.data_content.splitlines()


class TpuMetricsRecord(DiagnosisData):
    """Metrics scraped from the native tpu_timer profiler on one host.

    ``hang`` means the profiler saw no program completion within its
    timeout window (reference analogue: xpu_timer hang flag).
    """

    def __init__(
        self,
        hang: bool = False,
        step_latency_ms: float = 0.0,
        device_duty_cycle: float = 0.0,
        mfu: float = 0.0,
        **kw,
    ):
        kw.setdefault("data_type", DiagnosisDataType.TPU_METRICS)
        super().__init__(**kw)
        self.hang = hang
        self.step_latency_ms = step_latency_ms
        self.device_duty_cycle = device_duty_cycle
        #: live MFU from the interposer's per-program cost attribution
        #: (0 when the profiler has no peak configured) — the straggler
        #: ranking signal
        self.mfu = mfu
        if not self.data_content:
            self.data_content = json.dumps(
                {
                    "hang": hang,
                    "step_latency_ms": step_latency_ms,
                    "device_duty_cycle": device_duty_cycle,
                    "mfu": mfu,
                }
            )

    @classmethod
    def from_json(cls, text: str) -> "TpuMetricsRecord":
        rec = cls()
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return rec
        if isinstance(payload, dict):
            for k, v in payload.items():
                setattr(rec, k, v)
            content = payload.get("data_content")
            if isinstance(content, str) and content:
                try:
                    inner = json.loads(content)
                    rec.hang = bool(inner.get("hang", rec.hang))
                    rec.step_latency_ms = inner.get(
                        "step_latency_ms", rec.step_latency_ms
                    )
                    rec.device_duty_cycle = inner.get(
                        "device_duty_cycle", rec.device_duty_cycle
                    )
                    rec.mfu = inner.get("mfu", rec.mfu)
                except (ValueError, TypeError):
                    pass
        return rec


class CommMetricsRecord(DiagnosisData):
    """Per-axis communication rollup for one host: the agent's
    ``CommMetricsSource`` scrape of the workers' per-collective ledgers
    (profiler/comm.py). ``axes`` maps mesh axis -> {link, bytes_per_step,
    est_seconds_per_step} — the fleet-level ICI/DCN signal the
    reference's per-collective bus-bandwidth metrics feed (xpu_timer
    NCCL classification)."""

    def __init__(self, axes: Optional[Dict] = None, workers: int = 0,
                 **kw):
        kw.setdefault("data_type", DiagnosisDataType.COMM_METRICS)
        super().__init__(**kw)
        self.axes = axes or {}
        self.workers = workers
        if not self.data_content:
            self.data_content = json.dumps(
                {"workers": workers, "axes": self.axes}
            )

    @classmethod
    def from_json(cls, text: str) -> "CommMetricsRecord":
        rec = cls()
        rec.data_content = text
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return rec
        if isinstance(payload, dict):
            rec.axes = payload.get("axes", {}) or {}
            rec.workers = int(payload.get("workers", 0) or 0)
        return rec


class AcceleratorMetricsRecord(DiagnosisData):
    """Condensed accelerator-exporter gauges for one host (the scraper
    tier, ``common/metric/monitor.py`` — reference GpuMetricMonitor's
    DCGM gauges re-cast as TPU duty cycle / tensorcore / HBM)."""

    def __init__(
        self,
        duty_cycle: float = 0.0,
        tensorcore_util: float = 0.0,
        hbm_used_bytes: float = 0.0,
        hbm_total_bytes: float = 0.0,
        **kw,
    ):
        kw.setdefault("data_type", DiagnosisDataType.ACCEL_METRICS)
        super().__init__(**kw)
        self.duty_cycle = duty_cycle
        self.tensorcore_util = tensorcore_util
        self.hbm_used_bytes = hbm_used_bytes
        self.hbm_total_bytes = hbm_total_bytes

    @classmethod
    def from_json(cls, text: str) -> "AcceleratorMetricsRecord":
        rec = cls()
        rec.data_content = text  # keep the raw payload for debugging
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return rec
        if isinstance(payload, dict):
            for k, v in payload.items():
                if k != "series_count":
                    setattr(rec, k, v)
        return rec


class HangDumpRecord(DiagnosisData):
    """One host's hang bundle (``profiler.hang_dump.HangDumper.dump``):
    per-worker faulthandler stacks + per-rank pending device programs.
    Reference parity: the gdb/py-spy all-rank dump the xpu_timer daemon
    takes on ``doHang`` (``manager.cc:454-464``)."""

    def __init__(self, stacks: Optional[Dict] = None,
                 pending: Optional[Dict] = None, reason: str = "", **kw):
        kw.setdefault("data_type", DiagnosisDataType.HANG_DUMP)
        super().__init__(**kw)
        self.stacks = stacks or {}
        self.pending = pending or {}
        self.reason = reason

    @classmethod
    def from_json(cls, text: str) -> "HangDumpRecord":
        rec = cls()
        rec.data_content = text
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return rec
        if isinstance(payload, dict):
            rec.stacks = payload.get("stacks", {}) or {}
            rec.pending = payload.get("pending", {}) or {}
            rec.reason = payload.get("reason", "")
        return rec


class StragglerRecordData(DiagnosisData):
    """A runtime straggler flagged by the step-digest detector
    (``master/monitor/straggler.py``): the rank's windowed step-time
    p50 vs the fleet median, plus the policy that flagged it. Fed by
    the servicer when a digest observation newly crosses the policy."""

    def __init__(self, p50_s: float = 0.0, fleet_median_s: float = 0.0,
                 ratio: float = 0.0, windows: int = 0, **kw):
        kw.setdefault("data_type", DiagnosisDataType.STRAGGLER)
        super().__init__(**kw)
        self.p50_s = p50_s
        self.fleet_median_s = fleet_median_s
        self.ratio = ratio
        self.windows = windows

    @classmethod
    def from_json(cls, text: str) -> "StragglerRecordData":
        rec = cls()
        rec.data_content = text
        try:
            payload = json.loads(text)
        except (ValueError, TypeError):
            return rec
        if isinstance(payload, dict):
            rec.p50_s = float(payload.get("p50_s", 0.0) or 0.0)
            rec.fleet_median_s = float(
                payload.get("fleet_median_s", 0.0) or 0.0
            )
            rec.ratio = float(payload.get("ratio", 0.0) or 0.0)
            rec.windows = int(payload.get("windows", 0) or 0)
            if payload.get("node_id") is not None:
                rec.node_id = int(payload["node_id"])
        return rec


_DATA_CLASSES: Dict[str, Type[DiagnosisData]] = {
    "DiagnosisData": DiagnosisData,
    "TrainingLogRecord": TrainingLogRecord,
    "TpuMetricsRecord": TpuMetricsRecord,
    "CommMetricsRecord": CommMetricsRecord,
    "AcceleratorMetricsRecord": AcceleratorMetricsRecord,
    "HangDumpRecord": HangDumpRecord,
    "StragglerRecordData": StragglerRecordData,
}


def parse_report(data_cls: str, content: str, **kw) -> DiagnosisData:
    """Decode a DiagnosisReportData message into a typed record."""
    cls = _DATA_CLASSES.get(data_cls, DiagnosisData)
    rec = cls.from_json(content)
    for key, value in kw.items():
        if value not in ("", -1, None):
            setattr(rec, key, value)
    return rec


class DiagnosisDataManager:
    """Sliding-window store of observations (reference: DiagnosisDataManager)."""

    def __init__(self, expire_time_secs: float = 600.0, max_records: int = 512):
        self._expire = expire_time_secs
        self._max_records = max_records
        self._data: Dict[str, List[DiagnosisData]] = {}
        self._lock = threading.Lock()

    def store_data(self, record: DiagnosisData):
        with self._lock:
            q = self._data.setdefault(record.data_type, [])
            q.append(record)
            cutoff = time.time() - self._expire
            while q and (q[0].timestamp < cutoff or len(q) > self._max_records):
                q.pop(0)

    def get_data(self, data_type: str) -> List[DiagnosisData]:
        cutoff = time.time() - self._expire
        with self._lock:
            return [r for r in self._data.get(data_type, []) if r.timestamp >= cutoff]

    def latest_per_node(self, data_type: str) -> Dict[int, DiagnosisData]:
        out: Dict[int, DiagnosisData] = {}
        for rec in self.get_data(data_type):
            cur = out.get(rec.node_id)
            if cur is None or rec.timestamp >= cur.timestamp:
                out[rec.node_id] = rec
        return out
