"""Windowed per-rank step-time digests: the port's own copy of
dlrover_tpu/observability/digest.py.

Workers fold each step's wall seconds into a digest, and the throttled
step report drains one window (count/mean/p50/p95/max plus the window's
input-wait seconds), so the master's straggler detector and lost-time
attribution get per-rank distributions with no extra RPC.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank (round-half-down) percentile of an UNSORTED sample
    list; the p50 of a 2-sample window is the LOWER one, so one slow
    window never inflates its own comparison baseline."""
    if not samples:
        return 0.0
    s = sorted(float(x) for x in samples)
    pos = q * (len(s) - 1)
    idx = int(pos) if (pos - int(pos)) <= 0.5 else int(pos) + 1
    return s[min(len(s) - 1, max(0, idx))]


def digest_of(samples: Sequence[float]) -> Optional[Dict]:
    """{count, mean_s, p50_s, p95_s, max_s} of a sample list."""
    if not samples:
        return None
    vals = [float(x) for x in samples]
    return {
        "count": len(vals),
        "mean_s": round(sum(vals) / len(vals), 6),
        "p50_s": round(percentile(vals, 0.5), 6),
        "p95_s": round(percentile(vals, 0.95), 6),
        "max_s": round(max(vals), 6),
    }


class StepTimeDigest:
    """Fold per-step wall seconds; drain one window per report.

    Bounded: percentiles come from the first ``max_samples`` of a
    window (windows drain every ~15 s, so the cap only matters for
    sub-millisecond toy steps); count/mean/max fold every sample.
    Thread-safe — the step path adds, the report path drains.
    """

    def __init__(self, max_samples: int = 1024):
        self._lock = threading.Lock()
        self._max_samples = max_samples
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def add(self, dur_s: float) -> None:
        dur = max(0.0, float(dur_s))
        with self._lock:
            self._count += 1
            self._sum += dur
            if dur > self._max:
                self._max = dur
            if len(self._samples) < self._max_samples:
                self._samples.append(dur)

    def snapshot_and_reset(self) -> Optional[Dict]:
        """The window's digest (None when no steps ran), resetting the
        window for the next report period."""
        with self._lock:
            if self._count == 0:
                return None
            d = digest_of(self._samples) or {}
            d["count"] = self._count
            d["mean_s"] = round(self._sum / self._count, 6)
            d["max_s"] = round(self._max, 6)
            self._samples = []
            self._count = 0
            self._sum = 0.0
            self._max = 0.0
            return d


def merge_windows(a: Optional[Dict], b: Optional[Dict]) -> Optional[Dict]:
    """Combine two drained windows into one report payload — the retry
    path for a window whose report RPC failed (a master-relaunch gap
    must not erase its productive/input-wait seconds from the
    attribution). count/mean fold exactly; the order statistics take
    the max of the two windows (conservative toward straggler
    detection); input-wait deltas sum."""
    if not a:
        return dict(b) if b else None
    if not b:
        return dict(a)
    ca, cb = int(a.get("count", 0)), int(b.get("count", 0))
    total = ca + cb
    if total <= 0:
        return None
    out = {
        "count": total,
        "mean_s": round(
            (ca * float(a.get("mean_s", 0.0))
             + cb * float(b.get("mean_s", 0.0))) / total, 6,
        ),
    }
    for key in ("p50_s", "p95_s", "max_s"):
        out[key] = round(
            max(float(a.get(key, 0.0)), float(b.get(key, 0.0))), 6
        )
    out["input_wait_s"] = round(
        float(a.get("input_wait_s", 0.0)) + float(b.get("input_wait_s", 0.0)),
        6,
    )
    return out


# -- last drained window (worker /metrics export) -----------------------

_last_lock = threading.Lock()
_last_window: Optional[Dict] = None


def set_last_window(d: Dict) -> None:
    global _last_window
    with _last_lock:
        _last_window = dict(d)


def last_window() -> Optional[Dict]:
    with _last_lock:
        return dict(_last_window) if _last_window else None
