"""Collective-hang watchdog, seated-but-stalled rounds: the port's own
copy of dlrover_tpu/master/monitor/hang_watchdog.py.

The failure mode: synchronous training forms a round, every member is
*seated*, and then one member partitions, wedges in a dead collective, or
deadlocks. The collective never completes, so every rank stalls; but every
rank is also "alive" (heartbeats keep flowing from the reachable agents),
so the heartbeat evictor sees nothing wrong and the straggler detector
sees no digests at all. Without intervention the round stalls until a
human notices.

The watchdog's declaration rule is deliberately narrow:

- **fleet-wide**: the newest progress signal (a step report or any
  step-carrying digest; heartbeats never count) is older than the window.
  One slow rank is the *straggler detector's* job; this fires only when
  everyone stopped.
- **seated**: the latest completed rendezvous round's world is exactly
  the live (RUNNING) worker set. A mismatch means a membership change is
  already in flight; the rendezvous/evictor path owns recovery.

On declaration the watchdog (1) opens a downtime bracket backdated to the
last progress stamp, (2) bills the stall to the ``collective_hang``
category of :meth:`SpeedMonitor.attribution` (so a hang reads as what it
is, not ``unattributed``), (3) identifies the *silent* members, seated
workers whose agents stopped heartbeating when the fleet stalled (the
partitioned/hung subset), and releases their shard leases, and (4)
triggers re-rendezvous of the seated cohort via
:meth:`RendezvousManager.request_re_rendezvous`: the reachable agents see
a virtual waiter on their next membership poll, stop their workers and
re-form the world without the silent ones. If the hang persists (recovery
failed), it re-fires one window later and keeps billing the time.

Round-formation guard: a freshly completed round gets a full window from
its formation before it can be declared hung, so a relaunched master,
whose restored progress stamp predates the relaunch, never bills the gap
to ``collective_hang``.

Config: ``DLROVER_TPU_HANG_WATCHDOG`` (the local master's sweep thread on
or off) and ``DLROVER_TPU_HANG_WATCHDOG_WINDOW_S``. Tests drive
:meth:`sweep` on an injected clock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import logger


class HangWatchdog:
    def __init__(
        self,
        speed_monitor,
        rdzv_manager,
        job_context=None,
        task_manager=None,
        window_s: Optional[float] = None,
        clock=None,
    ):
        self._speed_monitor = speed_monitor
        self._rdzv = rdzv_manager
        self._job_context = job_context
        self._task_manager = task_manager
        self.window_s = float(
            window_s if window_s is not None
            else flags.HANG_WATCHDOG_WINDOW_S.get()
        )
        self._clock = clock or time.time
        #: last declaration time; 0 = armed. Progress re-arms, so one
        #: stall episode fires once per window, not once per sweep.
        self._fired_at = 0.0
        #: round-formation guard: a freshly completed round gets a FULL
        #: window from its formation before it can be declared hung —
        #: the first steps of a new world legitimately take restart +
        #: compile time, and a relaunched master restores the
        #: PRE-crash progress stamp (a stale stamp must never bill the
        #: relaunch gap to collective_hang or force the just-re-formed
        #: healthy fleet back into JOINING).
        self._round_seen = -1
        self._round_formed_at = 0.0
        self.hang_events: List[Dict] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle (production sweep thread) ---------------------------

    def start(self):
        if self._thread is not None or self.window_s <= 0:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hang-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop_evt.set()

    def _loop(self):
        interval = max(1.0, self.window_s / 4.0)
        while not self._stop_evt.wait(interval):
            try:
                self.sweep()
            except Exception:
                logger.exception("hang watchdog sweep failed")

    # -- the declaration rule ------------------------------------------

    def sweep(self, now: Optional[float] = None) -> Optional[Dict]:
        """One watchdog pass; returns the hang event iff this sweep
        declared one."""
        now = self._clock() if now is None else now
        sm = self._speed_monitor
        round_now = self._rdzv.get_rdzv_round()
        if round_now != self._round_seen:
            # a round just (re)formed: start its window from formation
            # time, not from a progress stamp that may predate a master
            # relaunch or the new world's restart+compile phase
            self._round_seen = round_now
            self._round_formed_at = now
            self._fired_at = 0.0
            return None
        last = sm.last_progress_ts()
        if last <= 0:
            return None  # training never started
        stall_from = max(last, self._round_formed_at)
        stall_s = now - stall_from
        if stall_s < self.window_s:
            self._fired_at = 0.0  # progress resumed: re-arm
            return None
        if self._fired_at and now - self._fired_at < self.window_s:
            return None  # already declared this episode; give recovery a window
        world = set(self._rdzv.latest_world_ids())
        if not world:
            return None
        live = {nid for _, nid in sm.running_workers}
        if live != world:
            # a membership change is in flight — the rendezvous /
            # evictor path owns that; a hang is specifically a SEATED
            # round that stopped
            return None
        silent = self._silent_members(world, now)
        # bill the stall: from the stall start on first declaration,
        # from the previous declaration on a re-fire (no double count)
        billed_from = self._fired_at or stall_from
        sm.mark_downtime_start(ts=stall_from)
        sm.record_hang(max(0.0, now - billed_from))
        for nid in silent:
            if self._task_manager is not None:
                # their leased shards go back in the queue now; the
                # fence bump keeps their zombie reports from counting
                self._task_manager.remove_node_tasks(nid)
        self._rdzv.request_re_rendezvous(exclude=silent)
        event = {
            "ts": now,
            "stall_s": round(stall_s, 3),
            "world": len(world),
            "silent": silent,
            "refire": bool(self._fired_at),
        }
        self._fired_at = now
        self.hang_events.append(event)
        del self.hang_events[:-64]
        logger.warning(
            "collective hang declared: %d-node round seated but no step "
            "reports for %.0fs (window %.0fs); silent members %s; "
            "re-rendezvous of the seated cohort triggered",
            len(world), stall_s, self.window_s, silent or "none",
        )
        return event

    def _silent_members(self, world, now: float) -> List[int]:
        """Seated workers whose reports stopped when the fleet stalled:
        last heartbeat older than half the window while their peers
        kept reporting. These are the partitioned/hung subset the
        re-formed round must exclude; an empty list means a pure
        deadlock — the whole cohort re-rendezvouses and restarts the
        collective."""
        if self._job_context is None:
            return []
        silent: List[int] = []
        for nid in sorted(world):
            node = self._job_context.get_node(NodeType.WORKER, nid)
            hb = getattr(node, "heartbeat_time", 0.0) if node else 0.0
            if hb > 0 and now - hb > self.window_s / 2.0:
                silent.append(nid)
        return silent
