"""Throughput + goodput accounting from worker step reports: the port's
own copy of dlrover_tpu/master/monitor/speed_monitor.py.

Global-step samples give the running speed; a goodput ledger tracks the
time training stood still (downtime brackets from a failure report to the
next step report) and decomposes the wall since the first step into
productive seconds (from the workers' step-time digests) and the lost
categories (rendezvous, compile, state transfer, checkpoint, input stall,
straggler wait, collective hang).

``export_state`` / ``import_state`` (with the rank ledger's ``export`` /
``import_``) carry the ledger across a master relaunch through the state
store (master/state_store.py); their document is the JAX one, so either
package's master restores the other's. The port's local master logs
``trace_events`` (the downtime brackets) at its exit, where the JAX master
dumps them into its job timeline.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.master.monitor.straggler import (
    StragglerDetector,
    StragglerRecord,
)


@dataclass
class GlobalStepRecord:
    step: int
    timestamp: float


class _StripedRankLedger:
    """Per-rank accumulators sharded by rank-id stripe (ROADMAP item 5:
    one lock + dicts used to serve the whole fleet — 1k concurrent
    ``WorkerReport`` handlers folding digests serialized on the
    SpeedMonitor's single lock, so servicer latency degraded with fleet
    size). A digest fold now touches only its rank's stripe; fleet-wide
    aggregations (attribution maxes, the goodput report) walk the
    stripes sequentially — they run once per report/sweep, not once per
    RPC."""

    STRIPES = 16

    def __init__(self):
        # the JAX package wraps each in its lint's lock tracker (ROADMAP
        # item 14); stripes are never nested
        self._locks = [threading.Lock() for _ in range(self.STRIPES)]
        self._stripes = [
            {
                "digest": {},        # node -> last window
                "productive": {},    # node -> cumulative seconds
                "input_wait": {},    # node -> cumulative seconds
                "ckpt_blocking": {},  # node -> cumulative seconds
            }
            for _ in range(self.STRIPES)
        ]

    def _slot(self, node: int):
        i = int(node) % self.STRIPES
        return self._locks[i], self._stripes[i]

    def fold_digest(
        self, node: int, digest: Dict, productive_add: float,
        input_wait_add: float,
    ):
        lock, s = self._slot(node)
        with lock:
            s["digest"][node] = dict(digest)
            s["productive"][node] = (
                s["productive"].get(node, 0.0) + productive_add
            )
            s["input_wait"][node] = (
                s["input_wait"].get(node, 0.0) + input_wait_add
            )

    def add_ckpt_blocking(self, node: int, seconds: float):
        lock, s = self._slot(node)
        with lock:
            s["ckpt_blocking"][node] = (
                s["ckpt_blocking"].get(node, 0.0) + seconds
            )

    def pop_digest(self, node: int):
        lock, s = self._slot(node)
        with lock:
            s["digest"].pop(int(node), None)

    def digests(self) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        for lock, s in zip(self._locks, self._stripes):
            with lock:
                out.update({k: dict(v) for k, v in s["digest"].items()})
        return out

    def _max(self, key: str) -> Optional[float]:
        best: Optional[float] = None
        for lock, s in zip(self._locks, self._stripes):
            with lock:
                for v in s[key].values():
                    if best is None or v > best:
                        best = v
        return best

    def max_productive(self) -> Optional[float]:
        return self._max("productive")

    def max_input_wait(self) -> float:
        return self._max("input_wait") or 0.0

    def max_ckpt_blocking(self) -> float:
        return self._max("ckpt_blocking") or 0.0

    def export(self) -> Dict[str, Dict]:
        out = {"digest": {}, "productive": {}, "input_wait": {},
               "ckpt_blocking": {}}
        for lock, s in zip(self._locks, self._stripes):
            with lock:
                for key in out:
                    out[key].update(s[key])
        return out

    def import_(
        self,
        digest: Dict[int, Dict],
        productive: Dict[int, float],
        input_wait: Dict[int, float],
        ckpt_blocking: Dict[int, float],
    ):
        for lock, s in zip(self._locks, self._stripes):
            with lock:
                for key in ("digest", "productive", "input_wait",
                            "ckpt_blocking"):
                    s[key].clear()
        for node, v in digest.items():
            lock, s = self._slot(node)
            with lock:
                s["digest"][node] = dict(v)
        for key, src in (
            ("productive", productive),
            ("input_wait", input_wait),
            ("ckpt_blocking", ckpt_blocking),
        ):
            for node, v in src.items():
                lock, s = self._slot(node)
                with lock:
                    s[key][node] = float(v)


class SpeedMonitor:
    def __init__(
        self,
        sample_window: int = DefaultValues.SPEED_SAMPLE_WINDOW,
        clock=None,
    ):
        # injectable clock (defaults to wall time): every internal "now"
        # reads it, so the fleet harness can drive the whole goodput
        # ledger — brackets, attribution, relaunch snapshots — on a
        # virtual clock through the real wire and get a deterministic
        # verdict
        self._clock = clock or time.time
        self._lock = threading.Lock()
        self._samples: List[GlobalStepRecord] = []
        self._sample_window = sample_window
        self._start_training_time: float = 0.0
        self._global_step = 0
        self._target_worker_num = 0
        self._workers: Set[Tuple[str, int]] = set()
        self._init_time = self._clock()
        # goodput ledger
        self._downtime_start: float = 0.0
        self._total_downtime: float = 0.0
        self._downtime_events: int = 0
        # per-phase attribution of the downtime brackets: what resizes
        # actually spend their seconds on (worker-reported via
        # ResizeBreakdownReport — train/live_reshard.py)
        self._breakdown_totals: Dict[str, float] = {
            "rendezvous": 0.0, "compile": 0.0, "state_transfer": 0.0,
        }
        self._breakdown_last: Dict[str, float] = {}
        self._breakdown_events: int = 0
        # which tier ended each downtime: "live" (device-to-device
        # reshard — no restore at all) vs the checkpoint ladder's
        # shm/disk/object rungs. Tier-0 (live/shm) restarts are the
        # warm-path SLO; disk/object counts rising means nodes are
        # actually being LOST, not just restarted.
        self._restore_tiers: Dict[str, int] = {}
        self._last_restore_tier: str = ""
        # -- lost-time attribution ledger (the goodput observatory) --
        # per-rank step-time digests ride the (throttled) step RPC
        # (observability/digest.py): productive seconds fold from them,
        # the straggler detector reads their p50s, and input-stall
        # seconds ride along from the worker trace spine. Striped by
        # rank id so report handlers don't serialize on this lock.
        self._ranks = _StripedRankLedger()
        # checkpoint seconds: save blocking (CheckpointStepReport) plus
        # the state_transfer half of any resize whose restore_tier says
        # the state came back through the checkpoint ladder (the live
        # device-to-device moves stay in state_transfer)
        self._ckpt_restore_s: float = 0.0
        # collective-hang ledger (master/monitor/hang_watchdog.py): a
        # seated-but-stalled round's seconds land here, not in
        # `unattributed`. _last_progress_ts is the watchdog's stall
        # signal: the newest step report or step-carrying digest.
        self._hang_s: float = 0.0
        self._last_progress_ts: float = 0.0
        self._progress_lock = threading.Lock()
        self.straggler_detector = StragglerDetector()
        # per-link-class comm bytes/step, per rank (last report wins:
        # every rank of one program reports the same analytic split —
        # GlobalStepReport.comm_links, profiler/comm.py). The goodput
        # report's ici/dcn section reads the max across ranks, so the
        # brain/tuner has a real slow-link signal instead of step-time
        # guesswork.
        self._comm_links: Dict[int, Dict[str, int]] = {}
        # per-rank DCN overlap ratio (shardcheck SC006 semantics:
        # overlapped / total trip-weighted DCN bytes). −1.0 sentinel =
        # not measured (single-slice or pre-overlap worker) — kept out
        # of _comm_links because that dict int-coerces its values
        self._overlap_ratio: Dict[int, float] = {}
        # master-side span buffer for the job timeline: closed downtime
        # brackets as (start, end) epoch pairs (bounded)
        self._downtime_spans: List[Tuple[float, float]] = []
        # the seated world's parallel layout as a contract spec
        # ("dp4xpp2"); "" = unreported. The planner's candidate
        # generator reads it (stage-preserving resize targets).
        self._layout_spec: str = ""

    # -- step samples -------------------------------------------------------

    def collect_global_step(self, step: int, timestamp: Optional[float] = None):
        ts = timestamp or self._clock()
        with self._lock:
            if self._start_training_time == 0.0:
                self._start_training_time = ts
            if step <= self._global_step:
                return
            self._global_step = step
            self._samples.append(GlobalStepRecord(step, ts))
            if len(self._samples) > self._sample_window:
                self._samples.pop(0)
        self._note_progress(ts)

    def _note_progress(self, ts: float):
        with self._progress_lock:
            if ts > self._last_progress_ts:
                self._last_progress_ts = ts

    def last_progress_ts(self) -> float:
        """Epoch seconds of the newest fleet progress signal (a step
        report or a step-carrying digest; heartbeats never count) — the
        hang watchdog's stall clock. 0 = training never started."""
        with self._progress_lock:
            return self._last_progress_ts

    @property
    def completed_global_step(self) -> int:
        return self._global_step

    @property
    def start_training_time(self) -> float:
        return self._start_training_time

    def running_speed(self) -> float:
        """Steps/sec over the sample window."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            first, last = self._samples[0], self._samples[-1]
            dt = last.timestamp - first.timestamp
            if dt <= 0:
                return 0.0
            return (last.step - first.step) / dt

    def secs_per_step(self) -> float:
        speed = self.running_speed()
        return 1.0 / speed if speed > 0 else 0.0

    # -- worker membership ----------------------------------------------------

    def set_target_worker_num(self, num: int):
        self._target_worker_num = num

    def add_running_worker(self, node_type: str, node_id: int):
        with self._lock:
            self._workers.add((node_type, node_id))

    def remove_running_worker(self, node_type: str, node_id: int):
        with self._lock:
            self._workers.discard((node_type, node_id))
        # a departed rank leaves the straggler fleet too: stale p50s
        # skew the median and a flagged-but-gone id would be reported
        # forever (detector has its own lock — kept out of ours)
        self.straggler_detector.forget(node_id)

    def evict_worker(self, node_type: str, node_id: int):
        """Heartbeat eviction: beyond ``remove_running_worker``, drop
        the rank's last digest window so the straggler report and
        /metrics stop advertising a dead rank's numbers. Cumulative
        productive/input-wait seconds stay — that history happened and
        the attribution must keep accounting for it. A returning worker
        re-seeds everything with its first fresh digest."""
        self.remove_running_worker(node_type, node_id)
        self._ranks.pop_digest(int(node_id))
        self.evict_comm_links(node_id)

    def all_worker_joined(self) -> bool:
        with self._lock:
            return 0 < self._target_worker_num <= len(self._workers)

    @property
    def running_workers(self) -> Set[Tuple[str, int]]:
        with self._lock:
            return set(self._workers)

    # -- goodput ledger --------------------------------------------------------

    def mark_downtime_start(self, ts: Optional[float] = None):
        with self._lock:
            if self._downtime_start == 0.0:
                self._downtime_start = ts or self._clock()

    def mark_downtime_end(self, ts: Optional[float] = None):
        with self._lock:
            if self._downtime_start > 0.0:
                end = ts or self._clock()
                # clamp: downtime_start may come from the OLD master pod's
                # clock (relaunch backdating); skew must never subtract
                self._total_downtime += max(0.0, end - self._downtime_start)
                self._downtime_spans.append((self._downtime_start, end))
                del self._downtime_spans[:-256]
                self._downtime_start = 0.0
                self._downtime_events += 1

    def downtime_in_progress(self) -> bool:
        """A downtime bracket is open (failure reported, round
        re-forming) — the planner's instability gate."""
        with self._lock:
            return self._downtime_start > 0.0

    def record_downtime_breakdown(
        self,
        rendezvous_s: float = 0.0,
        compile_s: float = 0.0,
        state_transfer_s: float = 0.0,
        restore_tier: str = "",
    ):
        """Attribute one resize's downtime to its phases. Complements
        the bracket timers: ``total_downtime`` says how long training
        stood still, this says on WHAT (and so which half — executable
        or state — still needs warming). ``restore_tier`` attributes
        where the state came from (live | shm | disk | object)."""
        with self._lock:
            last = {
                "rendezvous": max(0.0, float(rendezvous_s)),
                "compile": max(0.0, float(compile_s)),
                "state_transfer": max(0.0, float(state_transfer_s)),
            }
            for phase, secs in last.items():
                self._breakdown_totals[phase] += secs
            self._breakdown_last = last
            self._breakdown_events += 1
            if restore_tier in ("shm", "disk", "object"):
                # the transfer half of this resize was a checkpoint
                # restore, not a live device-to-device move: the
                # attribution bills it to "checkpoint" (breakdown
                # totals keep the raw phase split unchanged)
                self._ckpt_restore_s += last["state_transfer"]
            if restore_tier:
                self._restore_tiers[restore_tier] = (
                    self._restore_tiers.get(restore_tier, 0) + 1
                )
                self._last_restore_tier = restore_tier

    def downtime_breakdown(self) -> Dict:
        """{"totals": per-phase seconds, "last": the latest resize's
        phases, "events": how many resizes reported, "restore_tiers":
        restore count per tier (tier-0 live/shm vs tier-1/2
        disk/object), "last_restore_tier": the latest one}."""
        with self._lock:
            return {
                "totals": dict(self._breakdown_totals),
                "last": dict(self._breakdown_last),
                "events": self._breakdown_events,
                "restore_tiers": dict(self._restore_tiers),
                "last_restore_tier": self._last_restore_tier,
            }

    # -- per-rank digests -> straggler detection + attribution ------------

    def collect_step_digest(
        self,
        node_id: int,
        digest: Dict,
        ts: Optional[float] = None,
    ) -> Optional[StragglerRecord]:
        """Fold one rank's windowed step-time digest
        ({count, mean_s, p50_s, p95_s, max_s[, input_wait_s]}).
        Returns the StragglerRecord iff this window NEWLY flags the
        rank (the servicer forwards it into the diagnosis pipeline)."""
        if not digest:
            return None
        try:
            count = int(digest.get("count", 0))
            mean_s = float(digest.get("mean_s", 0.0))
            p50_s = float(digest.get("p50_s", 0.0))
        except (TypeError, ValueError):
            return None
        if count <= 0:
            return None
        node = int(node_id)
        # stripe fold only — no SpeedMonitor-wide lock on the report
        # hot path (the shard_storm_1k harness measures servicer p99
        # under combined report+lease load at 1k nodes)
        self._ranks.fold_digest(
            node,
            digest,
            count * max(0.0, mean_s),
            max(0.0, float(digest.get("input_wait_s", 0.0) or 0.0)),
        )
        self._note_progress(ts or self._clock())
        # detector has its own lock; keep it out of ours
        return self.straggler_detector.observe(
            node, p50_s, count=count, ts=ts
        )

    def record_comm_links(
        self, node_id: int, links: Dict, overlap_ratio: float = -1.0
    ):
        """One rank's per-link analytic comm bytes/step
        (``{"ici": N, "dcn": M}`` — GlobalStepReport.comm_links) plus
        its DCN ``overlap_ratio`` (−1.0 = not measured). Last report
        wins per rank; bad payloads are dropped, not raised (the
        report hot path must never fail on a malformed split)."""
        try:
            ratio = float(overlap_ratio)
        except (TypeError, ValueError):
            ratio = -1.0
        if not links:
            if ratio >= 0.0:
                with self._lock:
                    self._overlap_ratio[int(node_id)] = ratio
            return
        clean: Dict[str, int] = {}
        try:
            for k, v in dict(links).items():
                clean[str(k)] = int(v)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._comm_links[int(node_id)] = clean
            if ratio >= 0.0:
                self._overlap_ratio[int(node_id)] = ratio
            else:
                # a real split with no measured ratio (slice loss /
                # downgraded schedule): drop the rank's stale one
                self._overlap_ratio.pop(int(node_id), None)

    def evict_comm_links(self, node_id: int):
        with self._lock:
            self._comm_links.pop(int(node_id), None)
            self._overlap_ratio.pop(int(node_id), None)

    def comm_link_report(self) -> Dict:
        """The goodput report's ici/dcn section: per-link bytes/step
        (max across ranks — every rank of one program reports the same
        analytic split; max is robust to a straggling stale report),
        the dcn share of all comm, and how many ranks reported."""
        with self._lock:
            per_rank = {k: dict(v) for k, v in self._comm_links.items()}
            ratios = [r for r in self._overlap_ratio.values() if r >= 0.0]
        links: Dict[str, int] = {}
        for row in per_rank.values():
            for link, b in row.items():
                links[link] = max(links.get(link, 0), int(b))
        total = sum(links.values())
        return {
            "per_step_bytes": links,
            "dcn_share": (
                round(links.get("dcn", 0) / total, 4) if total else 0.0
            ),
            # min across ranks: every rank of one program carries the
            # same analytic ratio, so min is robust to a stale (higher)
            # report surviving a schedule regression. −1.0 = unmeasured.
            "overlap_ratio": round(min(ratios), 4) if ratios else -1.0,
            "ranks_reporting": len(per_rank),
        }

    def report_layout(self, spec: str):
        """The seated world's parallel layout, as a contract spec
        (``"dp4xpp2"``): seeded by whoever launches the job and
        re-reported whenever the seated mesh changes (re-form, executed
        plan). The goodput planner reads it to generate layout- and
        stage-preserving candidates — a pp fleet's resize targets keep
        the pipeline axis instead of collapsing to pure dp."""
        with self._lock:
            self._layout_spec = str(spec or "")

    def layout_spec(self) -> str:
        """The last reported seated layout spec ("" = never reported —
        the planner treats that as the pure-dp default)."""
        with self._lock:
            return self._layout_spec

    def record_ckpt_blocking(self, seconds: float, node_id: int = -1):
        """Training seconds a checkpoint save blocked the step loop for
        (CheckpointStepReport.blocking_s) — the save half of the
        attribution's ``checkpoint`` category. Accumulated PER RANK:
        every process reports the same job-wide pause, so the
        attribution reads the max across ranks (one save = one pause),
        never the sum (which would overcount world_size times)."""
        self._ranks.add_ckpt_blocking(
            int(node_id), max(0.0, float(seconds))
        )

    def record_hang(self, seconds: float):
        """Collective-hang seconds (hang watchdog): a round where every
        live worker was seated but step reports stopped fleet-wide —
        lost time with its own attribution category, so a stalled
        collective reads as `collective_hang`, not `unattributed`."""
        with self._lock:
            self._hang_s += max(0.0, float(seconds))

    def stragglers(self) -> List[int]:
        return self.straggler_detector.stragglers()

    def straggler_report(self) -> Dict:
        """Detector snapshot + the last digest per rank (goodput report
        and /metrics consumers)."""
        snap = self.straggler_detector.snapshot()
        snap["rank_digests"] = {
            str(k): dict(v) for k, v in self._ranks.digests().items()
        }
        return snap

    # -- lost-time attribution --------------------------------------------

    def attribution(self, now: Optional[float] = None) -> Dict:
        """Decompose wall time since the first step into
        productive / compile / rendezvous / state_transfer / checkpoint
        / input_stall / straggler_wait / unattributed — categories sum
        to ``elapsed_wall_s`` by construction (``unattributed`` is the
        residual; when measured categories overflow the wall —
        clock skew, double-reported windows — productive absorbs the
        overage first)."""
        now = now or self._clock()
        straggler_wait = self.straggler_detector.lost_seconds()
        rank_productive = self._ranks.max_productive()
        rank_input_wait = self._ranks.max_input_wait()
        rank_ckpt_blocking = self._ranks.max_ckpt_blocking()
        with self._lock:
            start = self._start_training_time
            wall = max(0.0, now - start) if start > 0.0 else 0.0
            bt = dict(self._breakdown_totals)
            ckpt_restore = min(self._ckpt_restore_s, bt["state_transfer"])
            lost = {
                "compile": bt["compile"],
                "rendezvous": bt["rendezvous"],
                "state_transfer": bt["state_transfer"] - ckpt_restore,
                "checkpoint": rank_ckpt_blocking + ckpt_restore,
                "input_stall": rank_input_wait,
                "straggler_wait": straggler_wait,
                "collective_hang": self._hang_s,
            }
            lost_sum = sum(lost.values())
            if lost_sum > wall:
                # measured lost seconds can overflow the wall (catch-up
                # digest reports compressing many windows into a young
                # job, clock skew): scale them down proportionally so
                # the category sum NEVER exceeds elapsed — the report's
                # one hard invariant
                scale = (wall / lost_sum) if lost_sum > 0 else 0.0
                lost = {k: v * scale for k, v in lost.items()}
                lost_sum = sum(lost.values())
            budget = max(0.0, wall - lost_sum)
            productive = rank_productive
            if productive is None:
                # no digest-reporting workers (version skew / toy
                # scripts): productive is the wall minus downtime and
                # the lost categories; unattributed keeps the downtime
                # seconds no breakdown explained
                resid_downtime = max(
                    0.0,
                    self._total_downtime
                    - (bt["compile"] + bt["rendezvous"]
                       + bt["state_transfer"]),
                )
                productive = max(0.0, budget - resid_downtime)
                source = "residual"
            else:
                productive = min(productive, budget)
                source = "digest"
        categories = dict(lost)
        categories["productive"] = productive
        categories["unattributed"] = max(
            0.0, wall - productive - lost_sum
        )
        return {
            "elapsed_wall_s": round(wall, 6),
            "categories": {
                k: round(v, 6) for k, v in categories.items()
            },
            "productive_source": source,
            "stragglers": self.straggler_detector.stragglers(),
        }

    # -- master-side spans for the job timeline ---------------------------

    def trace_events(self) -> List[Dict]:
        """The master's view as chrome-trace events (epoch-us clock):
        closed downtime brackets plus each resize's reported phase
        breakdown laid back-to-back before its report time."""
        events: List[Dict] = []
        with self._lock:
            spans = list(self._downtime_spans)
            if self._downtime_start > 0.0:
                spans.append((self._downtime_start, self._clock()))
        for s, e in spans:
            events.append({
                "name": "job.downtime", "cat": "downtime", "ph": "X",
                "ts": int(s * 1e6), "dur": int(max(0.0, e - s) * 1e6),
                "pid": 0, "tid": 1, "args": {"kind": "downtime"},
            })
        return events

    def avg_downtime(self) -> float:
        """Mean seconds per completed downtime bracket — what one
        restart/membership change actually costs this job (feeds the
        brain's goodput-aware growth gate)."""
        with self._lock:
            if self._downtime_events == 0:
                return 0.0
            return self._total_downtime / self._downtime_events

    def goodput(self, now: Optional[float] = None) -> float:
        """Fraction of wall time (since first step) spent training."""
        with self._lock:
            if self._start_training_time == 0.0:
                return 0.0
            now = now or self._clock()
            wall = now - self._start_training_time
            if wall <= 0:
                return 0.0
            down = self._total_downtime
            if self._downtime_start > 0.0:
                down += max(0.0, now - self._downtime_start)
            return max(0.0, min(1.0, (wall - down) / wall))

    def total_downtime(self, now: Optional[float] = None) -> float:
        with self._lock:
            down = self._total_downtime
            if self._downtime_start > 0.0:
                down += max(
                    0.0, (now or self._clock()) - self._downtime_start
                )
            return down

    def reset_running_speed(self):
        with self._lock:
            self._samples.clear()

    # -- master-relaunch continuity -------------------------------------

    def export_state(self) -> Dict:
        """Durable ledger snapshot: global step, training-start epoch and
        downtime totals survive a master relaunch, so goodput keeps its
        true denominator instead of restarting from the relaunch time."""
        ranks = self._ranks.export()
        with self._lock:
            return {
                "global_step": self._global_step,
                "start_training_time": self._start_training_time,
                "total_downtime": self._total_downtime,
                "downtime_events": self._downtime_events,
                "downtime_start": self._downtime_start,
                "breakdown_totals": dict(self._breakdown_totals),
                "breakdown_events": self._breakdown_events,
                "restore_tiers": dict(self._restore_tiers),
                "last_restore_tier": self._last_restore_tier,
                # attribution ledger: per-rank productive/input-wait
                # accumulators, checkpoint seconds and the straggler
                # detector — master relaunch must not lose accounting
                "productive_s": {
                    str(k): v for k, v in ranks["productive"].items()
                },
                "input_wait_s": {
                    str(k): v for k, v in ranks["input_wait"].items()
                },
                "digest_last": {
                    str(k): dict(v) for k, v in ranks["digest"].items()
                },
                "ckpt_blocking_s": {
                    str(k): v for k, v in ranks["ckpt_blocking"].items()
                },
                "ckpt_restore_s": self._ckpt_restore_s,
                "hang_s": self._hang_s,
                "comm_links": {
                    str(k): dict(v) for k, v in self._comm_links.items()
                },
                "overlap_ratio": {
                    str(k): v for k, v in self._overlap_ratio.items()
                },
                "last_progress_ts": self._last_progress_ts,
                "layout_spec": self._layout_spec,
                "straggler": self.straggler_detector.export_state(),
                # when the old master dies with no open bracket, the
                # restore path backdates the relaunch gap to this stamp
                "snapshot_time": self._clock(),
            }

    def import_state(self, state: Dict):
        with self._lock:
            self._global_step = max(
                self._global_step, int(state.get("global_step", 0))
            )
            start = float(state.get("start_training_time", 0.0))
            if start > 0.0:
                self._start_training_time = start
            self._total_downtime = float(state.get("total_downtime", 0.0))
            self._downtime_events = int(state.get("downtime_events", 0))
            # a downtime bracket that was open when the old master died
            # stays open — the relaunch gap itself is downtime
            self._downtime_start = float(state.get("downtime_start", 0.0))
            totals = state.get("breakdown_totals") or {}
            for phase in self._breakdown_totals:
                self._breakdown_totals[phase] = float(
                    totals.get(phase, 0.0)
                )
            self._breakdown_events = int(state.get("breakdown_events", 0))
            self._restore_tiers = {
                str(k): int(v)
                for k, v in (state.get("restore_tiers") or {}).items()
            }
            self._last_restore_tier = str(
                state.get("last_restore_tier", "")
            )
            self._ckpt_restore_s = float(state.get("ckpt_restore_s", 0.0))
            self._hang_s = float(state.get("hang_s", 0.0))
            self._comm_links = {
                int(k): {str(a): int(b) for a, b in dict(v).items()}
                for k, v in (state.get("comm_links") or {}).items()
            }
            self._overlap_ratio = {
                int(k): float(v)
                for k, v in (state.get("overlap_ratio") or {}).items()
            }
            # a relaunched master must keep planning stage-preserving
            # targets — an empty restore (old snapshot) keeps ""
            self._layout_spec = str(state.get("layout_spec", ""))
        raw_blocking = state.get("ckpt_blocking_s") or {}
        if not isinstance(raw_blocking, dict):
            # pre-per-rank snapshot: one untagged total
            raw_blocking = {-1: float(raw_blocking)}
        self._ranks.import_(
            digest={
                int(k): dict(v)
                for k, v in (state.get("digest_last") or {}).items()
            },
            productive={
                int(k): float(v)
                for k, v in (state.get("productive_s") or {}).items()
            },
            input_wait={
                int(k): float(v)
                for k, v in (state.get("input_wait_s") or {}).items()
            },
            ckpt_blocking={
                int(k): float(v) for k, v in raw_blocking.items()
            },
        )
        self._note_progress(float(state.get("last_progress_ts", 0.0)))
        self.straggler_detector.import_state(state.get("straggler") or {})
