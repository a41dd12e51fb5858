"""Master-side straggler detection over per-rank step-time digests: the
port's own copy of dlrover_tpu/master/monitor/straggler.py (the master
relaunch's ``export_state``/``import_state`` wait for the state store,
ROADMAP.md).

Policy (the JAX package's docs/design/observability.md): each worker's
throttled step report carries a windowed step-time digest
(observability/digest.py). A rank whose window p50 exceeds ``ratio`` x
the fleet median (lower median of the latest p50 per rank) for
``windows`` CONSECUTIVE windows is flagged; one recovered window unflags
it. Flagged ranks surface three ways:

- a :class:`StragglerRecord` enters the diagnosis pipeline
  (``servicer._report_global_step`` -> DiagnosisDataManager), where the
  resolve chain can decide to exclude/relaunch (the port's master has no
  diagnosis manager yet, ROADMAP 5b.2c: the record is logged);
- the ``StragglersRequest`` RPC answers with the union of the
  network-check stragglers and these runtime ones;
- the goodput report's ``attribution.straggler_wait`` accumulates the
  fleet's lost seconds: ``(p50 - fleet_median) * steps`` per slow
  window — synchronous training makes every rank wait for the slowest,
  so one slow rank's excess is job-wide lost time.

Consecutive-window hysteresis is the false-positive guard: one GC
pause or checkpoint-heavy window shapes like a straggler; ``windows``
of them in a row (minutes, at the ~15 s report cadence) do not.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger


@dataclasses.dataclass
class StragglerRecord:
    """One rank crossing the straggler policy."""

    node_id: int
    p50_s: float
    fleet_median_s: float
    ratio: float
    windows: int
    ts: float = 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class StragglerDetector:
    def __init__(
        self,
        ratio: Optional[float] = None,
        windows: Optional[int] = None,
    ):
        self.ratio = (
            float(ratio) if ratio is not None
            else max(1.01, float(flags.STRAGGLER_RATIO.get()))
        )
        self.windows = (
            int(windows) if windows is not None
            else max(1, int(flags.STRAGGLER_WINDOWS.get()))
        )
        # the JAX package wraps it in its lint's lock tracker (ROADMAP
        # item 14)
        self._lock = threading.Lock()
        self._latest_p50: Dict[int, float] = {}
        self._strikes: Dict[int, int] = {}
        self._flagged: Dict[int, StragglerRecord] = {}
        self._new: List[StragglerRecord] = []
        self._lost_s = 0.0

    @staticmethod
    def _median(values: List[float]) -> float:
        """Lower median: with an even fleet the faster middle rank is
        the baseline, so a single slow rank in a 2-rank fleet compares
        against its healthy peer instead of diluting the median."""
        s = sorted(values)
        return s[(len(s) - 1) // 2] if s else 0.0

    def observe(
        self,
        node_id: int,
        p50_s: float,
        count: int = 0,
        ts: Optional[float] = None,
    ) -> Optional[StragglerRecord]:
        """Fold one rank's window; returns the StragglerRecord iff this
        observation NEWLY flags the rank (the diagnosis feed)."""
        node = int(node_id)
        p50 = float(p50_s)
        if p50 <= 0:
            return None
        with self._lock:
            self._latest_p50[node] = p50
            if len(self._latest_p50) < 2:
                return None  # a fleet of one has no one to straggle
            med = self._median(list(self._latest_p50.values()))
            if med <= 0:
                return None
            if p50 <= self.ratio * med:
                if self._strikes.pop(node, None) and node in self._flagged:
                    logger.info(
                        "straggler recovered: rank %s p50=%.4fs vs fleet "
                        "median %.4fs", node, p50, med,
                    )
                self._flagged.pop(node, None)
                return None
            # slow window: bill the fleet's wait and count the strike
            if count > 0:
                self._lost_s += max(0.0, p50 - med) * int(count)
            strikes = self._strikes.get(node, 0) + 1
            self._strikes[node] = strikes
            if strikes < self.windows or node in self._flagged:
                return None
            rec = StragglerRecord(
                node_id=node,
                p50_s=round(p50, 6),
                fleet_median_s=round(med, 6),
                ratio=self.ratio,
                windows=strikes,
                ts=ts or time.time(),
            )
            self._flagged[node] = rec
            self._new.append(rec)
        logger.warning(
            "straggler flagged: rank %s p50=%.4fs > %.2fx fleet median "
            "%.4fs for %d consecutive windows",
            node, p50, self.ratio, med, strikes,
        )
        return rec

    def forget(self, node_id: int) -> None:
        """Evict a departed rank: its last p50 must stop skewing the
        fleet median, its strikes must not pre-flag a replacement node
        reusing the id, and a flagged-but-gone rank must leave the
        straggler list (elastic shrink / relaunch)."""
        node = int(node_id)
        with self._lock:
            self._latest_p50.pop(node, None)
            self._strikes.pop(node, None)
            self._flagged.pop(node, None)

    # -- consumers -----------------------------------------------------

    def stragglers(self) -> List[int]:
        with self._lock:
            return sorted(self._flagged)

    def records(self) -> List[StragglerRecord]:
        with self._lock:
            return list(self._flagged.values())

    def drain_new(self) -> List[StragglerRecord]:
        """Records flagged since the last drain (diagnosis feed)."""
        with self._lock:
            out, self._new = self._new, []
            return out

    def lost_seconds(self) -> float:
        """Cumulative fleet wait attributed to stragglers."""
        with self._lock:
            return self._lost_s

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "ratio": self.ratio,
                "windows": self.windows,
                "flagged": sorted(self._flagged),
                "strikes": dict(self._strikes),
                "lost_s": round(self._lost_s, 6),
            }
