"""The goodput planner: the brain's observe → decide → act loop. The port's
own copy of dlrover_tpu/brain/planner.py.

- **Observe**: every input is a measured quantity from the master's
  ledgers: the fleet-median digest p50 step time, per-link comm bytes, the
  speed monitor's average resize downtime as the cost of acting, straggler
  flags and open downtime brackets as instability, the workers' reported
  device-memory occupancy as a feasibility gate.
- **Decide**: candidate worlds are
  :class:`~dlrover_tpu_torch.common.world.WorldDescriptor`\\ s. Each is
  scored by predicted productive seconds over a payback horizon: a resize
  only wins if its throughput gain amortizes its measured downtime cost
  within the horizon. Hysteresis (the same winning candidate for K
  consecutive decisions) and a post-execution cooldown turn storms and
  straggler episodes into HOLD decisions, not flapping.
- **Act**: an accepted plan flows through ``JobAutoScaler`` → ``Scaler``;
  the executed intent also (a) opens the rendezvous *growth gate* (waiting
  capacity is advertised to the fleet only when the planner decided to
  adopt it; shrink and recovery never wait for permission) and (b)
  publishes a *speculation hint* on the rendezvous world poll, the exact
  world the workers will be seated in next.

Every decision lands in an export/import-safe ledger (inputs snapshot,
scores, verdict, payback estimate) that survives a master relaunch; the
document is the JAX package's, so a ledger crosses between the packages.
The planner is clock-injected and reads no wall clock of its own
(``tests/test_torch_planner.py`` pins it), so its decisions are
deterministic given its inputs.

Left out, each in ROADMAP.md: the JAX planner's lock tracker (the lint
slice, item 15; a plain ``threading.Lock`` here) and a static headroom
oracle (``lint/memcheck.HeadroomOracle``, item 14): ``headroom_oracle``
stays an injectable argument, ``None`` by default, and the unarmed path
keeps every candidate.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.world import WorldDescriptor

HOLD = "hold"
RESIZE = "resize"

#: ledger bound: enough for a multi-day job at one decision/minute
#: windowing, small enough to ride every state snapshot
LEDGER_CAP = 512


@dataclasses.dataclass
class PlannerInputs:
    """One decision's measured observation snapshot. Node-level: the
    master plans in nodes (each node drives a fixed device count); the
    agent converts the hint to devices with its local device count."""

    ts: float = 0.0
    #: seated world size (nodes in the latest completed round)
    world: int = 0
    #: slices the seated world spans (1 = single-slice / unknown)
    n_slices: int = 1
    #: nodes waiting to (re)join — restorable capacity
    waiting: int = 0
    #: fleet-median digest p50 step seconds (0 = no digests yet)
    step_p50_s: float = 0.0
    #: per-link analytic comm bytes/step ({"ici": N, "dcn": M})
    comm_links: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: DCN overlap ratio the fleet reports (share of DCN bytes the
    #: schedule hides behind compute; −1.0 = unmeasured). Discounts the
    #: DCN cost term: overlapped bytes don't stretch the step.
    overlap_ratio: float = -1.0
    #: the seated world's layout (contract spec, e.g. "dp2xfsdp2+zero1");
    #: "" = unknown, treated as the pure-dp default layout
    layout_spec: str = ""
    #: per-operator share of step time from the kernel ledger
    #: ({"matmul": 0.6, "comm.all-reduce": 0.1, ...}; {} = unmeasured).
    #: The layout scorer reads the comm.* share — without it the
    #: planner cannot tell comm-bound from compute-bound and HOLDs on
    #: layout flips (it never guesses).
    kernel_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    #: measured average downtime one membership change costs this job
    resize_cost_s: float = 0.0
    #: ranks the step-digest detector currently flags
    stragglers: List[int] = dataclasses.field(default_factory=list)
    #: a downtime bracket is open (failure reported, round re-forming)
    downtime_open: bool = False
    #: per-device HBM occupancy at the CURRENT world (bytes; 0=unknown)
    hbm_used_bytes: float = 0.0
    hbm_capacity_bytes: float = 0.0
    #: job bounds (rendezvous params / job args)
    min_nodes: int = 1
    max_nodes: int = 0
    node_unit: int = 1

    @property
    def dcn_share(self) -> float:
        total = sum(self.comm_links.values())
        return self.comm_links.get("dcn", 0) / total if total else 0.0

    def snapshot(self) -> Dict:
        """JSON-able copy for the decision record (rounded so the
        ledger is bit-stable given the same virtual-clock inputs)."""
        return {
            "ts": round(self.ts, 3),
            "world": self.world,
            "n_slices": self.n_slices,
            "waiting": self.waiting,
            "step_p50_s": round(self.step_p50_s, 6),
            "comm_links": {k: int(v) for k, v in self.comm_links.items()},
            "dcn_share": round(self.dcn_share, 4),
            "overlap_ratio": round(self.overlap_ratio, 4),
            "layout_spec": self.layout_spec,
            "kernel_breakdown": {
                k: round(float(v), 4)
                for k, v in sorted(self.kernel_breakdown.items())
            },
            "resize_cost_s": round(self.resize_cost_s, 3),
            "stragglers": sorted(self.stragglers),
            "downtime_open": bool(self.downtime_open),
            "hbm_used_bytes": round(self.hbm_used_bytes, 1),
            "hbm_capacity_bytes": round(self.hbm_capacity_bytes, 1),
        }


class GoodputPlanner:
    """Deterministic decision engine over measured signals.

    Construction wires the observation sources (``speed_monitor``, the
    training rendezvous manager); ``decide()`` may also be driven with
    explicit :class:`PlannerInputs` (unit tests, what-if tooling). All
    time flows through the injected ``clock`` — this module contains no
    wall-clock read, which a test pins.
    """

    def __init__(
        self,
        speed_monitor=None,
        rdzv_manager=None,
        job_context=None,
        clock: Optional[Callable[[], float]] = None,
        min_nodes: int = 1,
        max_nodes: int = 0,
        node_unit: int = 1,
        n_slices: int = 1,
        cooldown_s: Optional[float] = None,
        horizon_s: Optional[float] = None,
        hysteresis: Optional[int] = None,
        decide_interval_s: Optional[float] = None,
        min_gain_frac: float = 0.02,
        hbm_headroom_frac: float = 0.10,
        layout_cost_s: float = 5.0,
        pp_microbatches: int = 4,
        hbm_capacity_gb: Optional[float] = None,
        dcn_gbps: Optional[float] = None,
        default_resize_cost_s: float = 30.0,
        headroom_oracle=None,
    ):
        self._sm = speed_monitor
        self._rdzv = rdzv_manager
        #: job context (master-side node registry): supplies the
        #: workers' reported HBM occupancy for the shrink-feasibility
        #: gate; capacity comes from DLROVER_TPU_PLANNER_HBM_GB (the
        #: deployment knows its chip; 0 = unknown, gate off)
        self._job_context = job_context
        #: the STATIC side of the same gate
        #: (the JAX package's ``lint/memcheck.HeadroomOracle``, ROADMAP item 14): measured
        #: occupancy only exists for worlds that have run — the oracle
        #: prices EVERY candidate (never-visited worlds, layout flips)
        #: against its device-class budget, and a candidate that cannot
        #: fit is vetoed with decision reason ``oom_veto`` instead of
        #: ever becoming an intent. None = unarmed.
        self._oracle = headroom_oracle
        self._hbm_capacity_bytes = float(
            hbm_capacity_gb if hbm_capacity_gb is not None
            else flags.PLANNER_HBM_GB.get()
        ) * 1e9
        self._clock = clock or time.time
        self._min_nodes = max(1, int(min_nodes))
        self._max_nodes = int(max_nodes)
        self._node_unit = max(1, int(node_unit))
        self._n_slices = max(1, int(n_slices))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else flags.PLANNER_COOLDOWN_S.get()
        )
        self.horizon_s = float(
            horizon_s if horizon_s is not None
            else flags.PLANNER_HORIZON_S.get()
        )
        self.hysteresis = int(
            hysteresis if hysteresis is not None
            else flags.PLANNER_HYSTERESIS.get()
        )
        self.decide_interval_s = float(
            decide_interval_s if decide_interval_s is not None
            else flags.PLANNER_INTERVAL_S.get()
        )
        self.min_gain_frac = float(min_gain_frac)
        self.hbm_headroom_frac = float(hbm_headroom_frac)
        #: cost charged for a SAME-world layout flip: a warm in-process
        #: remesh (the target layout is speculation-hinted, so the step
        #: re-lower is a warm cache hit), not a membership change — far
        #: cheaper than resize_cost_s, but never free
        self.layout_cost_s = float(layout_cost_s)
        #: microbatch count the pp executors run (the ``m`` in the
        #: interleaved 1f1b bubble fraction (p-1)/(p*m)); the bubble is
        #: the compute-side cost a pp layout candidate is charged
        self.pp_microbatches = max(1, int(pp_microbatches))
        self._dcn_bytes_per_s = float(
            dcn_gbps if dcn_gbps is not None else flags.PLANNER_DCN_GBPS.get()
        ) * 1e9
        self.default_resize_cost_s = float(default_resize_cost_s)
        # mutable decision state — one lock; decide() gathers inputs
        # BEFORE taking it (SpeedMonitor/rendezvous reads must never
        # nest inside the planner lock: the rendezvous growth gate
        # calls INTO the planner under its own lock, so the planner
        # calling OUT while locked would be a lock-order cycle)
        self._lock = threading.Lock()
        self._ledger: List[Dict] = []
        #: TRUE monotonic decision count — the ledger itself is capped
        #: at LEDGER_CAP, so consumers tracking "new decisions since"
        #: (the fleet runner's event log) must not read len(ledger)
        self._decisions_total: int = 0
        self._executed: List[Dict] = []
        self._counts: Dict[str, int] = {HOLD: 0, RESIZE: 0}
        self._intent: Optional[WorldDescriptor] = None
        #: the intent's plan has actually been pushed through the
        #: Scaler (note_executed): the growth gate and the speculation
        #: hint honor ONLY executed intents — a RESIZE decision whose
        #: execution failed must not adopt capacity with no plan on
        #: record and no cooldown window open
        self._intent_executed: bool = False
        self._intent_from: int = 0  # seated world when the intent formed
        self._intent_ts: float = 0.0
        #: lock-free publication for the poll fast path (the same
        #: copy-on-change pattern as the rendezvous _WorldSnapshot):
        #: (hint wire dict, gate-opening world or -1), republished
        #: under the lock on every intent/execution change and read as
        #: one atomic reference by num_nodes_waiting storms — the
        #: lock-free poll path must not re-serialize on the planner
        #: mutex
        self._pub: tuple = ({}, -1)
        self._last_exec_ts: float = 0.0
        self._last_decide_ts: float = 0.0
        self._streak_spec: str = ""
        self._streak: int = 0

    # -- observation -------------------------------------------------------

    def observe(self, now: Optional[float] = None) -> PlannerInputs:
        """Assemble the measured inputs from the wired master ledgers.
        Missing sources degrade to neutral values — the planner HOLDs
        on ignorance, it never guesses."""
        now = self._clock() if now is None else now
        inputs = PlannerInputs(
            ts=now,
            n_slices=self._n_slices,
            min_nodes=self._min_nodes,
            max_nodes=self._max_nodes,
            node_unit=self._node_unit,
        )
        if self._rdzv is not None:
            snap = self._rdzv.world_snapshot()
            inputs.world = len(snap.latest_world)
            # the RAW waiting count — the planner must see capacity the
            # growth gate is deliberately hiding from the fleet
            inputs.waiting = snap.num_waiting
            # slice topology from the seated metas themselves: the
            # agents report their slice names at join, so the
            # master derives the REAL slice count instead of needing a
            # configured one (constructor n_slices stays the fallback
            # for slice-name-less deployments). The DCN scoring model
            # and the slice-aligned candidate set key on this.
            slices = {
                getattr(m, "slice_name", "") or ""
                for m in (getattr(snap, "rdzv_nodes", None) or {}).values()
            }
            slices.discard("")
            if (
                len(slices) > 1
                and inputs.world > 0
                and inputs.world % len(slices) == 0
            ):
                inputs.n_slices = len(slices)
        if self._sm is not None:
            digests = self._sm.straggler_report().get("rank_digests", {})
            p50s = sorted(
                float(d.get("p50_s", 0.0)) for d in digests.values()
                if float(d.get("p50_s", 0.0)) > 0
            )
            if p50s:
                inputs.step_p50_s = p50s[len(p50s) // 2]
            link_report = self._sm.comm_link_report()
            links = link_report.get("per_step_bytes", {})
            inputs.comm_links = {k: int(v) for k, v in links.items()}
            inputs.overlap_ratio = float(
                link_report.get("overlap_ratio", -1.0)
            )
            inputs.resize_cost_s = self._sm.avg_downtime()
            inputs.stragglers = list(self._sm.stragglers())
            inputs.downtime_open = self._sm.downtime_in_progress()
            # per-kernel shares (the workers' kernel ledger, relayed by
            # the speed monitor when wired) — optional: an older monitor
            # without the method leaves the breakdown unmeasured and
            # the layout scorer inert
            kb = getattr(self._sm, "kernel_breakdown", None)
            if callable(kb):
                inputs.kernel_breakdown = {
                    str(k): float(v) for k, v in (kb() or {}).items()
                }
            layout = getattr(self._sm, "layout_spec", None)
            if callable(layout):
                inputs.layout_spec = str(layout() or "")
        if self._job_context is not None and self._hbm_capacity_bytes > 0:
            # the workers' reported per-device HBM occupancy (max
            # across the fleet — the tightest device gates a shrink)
            used_mb = max(
                (
                    n.used_resource.tpu_hbm_used_mb
                    for n in self._job_context.workers().values()
                    if not n.is_released
                ),
                default=0.0,
            )
            if used_mb > 0:
                inputs.hbm_used_bytes = used_mb * 1e6
                inputs.hbm_capacity_bytes = self._hbm_capacity_bytes
        return inputs

    # -- the scoring model -------------------------------------------------

    def _grad_dcn_bytes(self, inputs: PlannerInputs) -> float:
        """Reconstruct the full per-step gradient byte volume B from the
        measured DCN bytes via the hier_collectives model: on a
        hierarchical multislice world DCN carries exactly ``B / dp_in``
        (docs/design/hier_collectives.md). Single-slice worlds measure
        zero DCN and contribute zero everywhere."""
        dcn = float(inputs.comm_links.get("dcn", 0))
        if dcn <= 0 or inputs.n_slices <= 1 or inputs.world <= 0:
            return 0.0
        dp_in = max(1, inputs.world // inputs.n_slices)
        return dcn * dp_in

    def _candidate_dcn_bytes(
        self, wd: WorldDescriptor, inputs: PlannerInputs
    ) -> float:
        """Predicted per-step DCN bytes for a candidate world: the
        hierarchical ``B / dp_in`` when the candidate tiles into whole
        slices, else the flat all-reduce's ``B * (1 - 1/s)`` — the slow
        link carries dp_in x more, which is what makes a slice-aligned
        shrink beat an arbitrary one of similar size."""
        grad_b = self._grad_dcn_bytes(inputs)
        if grad_b <= 0:
            return 0.0
        if wd.n_slices <= 1:
            per_slice = (
                inputs.world // inputs.n_slices
                if inputs.n_slices > 1 else 0
            )
            if per_slice and wd.world_size > per_slice:
                # does not tile into whole surviving slices: the ragged
                # world runs the FLAT reduction across the original
                # slice spread
                s = inputs.n_slices
                return grad_b * (1.0 - 1.0 / s)
            return 0.0  # fits one slice: no DCN at all
        return grad_b / max(1, wd.dp_in)

    def predict_step_time(
        self, wd: WorldDescriptor, inputs: PlannerInputs
    ) -> float:
        """Predicted p50 step seconds at candidate ``wd``: the compute
        half scales with 1/dp (global batch is fixed across resizes —
        the elastic invariant), the DCN half re-derives from the byte
        model over the configured slow-link bandwidth."""
        base = inputs.step_p50_s
        if base <= 0 or inputs.world <= 0:
            return 0.0
        if (
            wd.world_size == inputs.world
            and wd.spec != self._current_spec(inputs)
        ):
            # same chips, different mesh factorization: the world-ratio
            # model below would predict zero change — the layout model
            # scores the comm-share delta instead
            return self.predict_layout_step_time(wd, inputs)
        # only EXPOSED DCN bytes sit on the critical path: the fleet's
        # reported overlap_ratio discounts the transfer seconds the
        # schedule hides behind compute (−1 sentinel = no discount)
        exposed = (
            1.0 - inputs.overlap_ratio
            if 0.0 <= inputs.overlap_ratio <= 1.0 else 1.0
        )
        dcn_now = (
            float(inputs.comm_links.get("dcn", 0)) * exposed
            / self._dcn_bytes_per_s
            if self._dcn_bytes_per_s > 0 else 0.0
        )
        compute = max(base - dcn_now, base * 0.05)
        dcn_next = (
            self._candidate_dcn_bytes(wd, inputs) * exposed
            / self._dcn_bytes_per_s
            if self._dcn_bytes_per_s > 0 else 0.0
        )
        return compute * (inputs.world / wd.world_size) + dcn_next

    def _current_spec(self, inputs: PlannerInputs) -> str:
        """The seated world's layout spec: the reported one, else the
        pure-dp default descriptor for (world, n_slices)."""
        if inputs.layout_spec:
            return inputs.layout_spec
        wd = self._descriptor(inputs.world, inputs.n_slices)
        return wd.spec if wd is not None else ""

    @staticmethod
    def _layout_comm_ratio(wd: WorldDescriptor) -> float:
        """Relative per-step ICI comm volume of a layout, in units of
        the global parameter bytes P (ring-collective cost model,
        docs/design/kernels.md):

        - dp axis ``d``: gradient all-reduce ``2(d-1)/d`` on the grad
          bytes the axis still carries;
        - fsdp axis ``f``: parameter all-gather fwd+bwd ``2(f-1)/f``
          plus gradient reduce-scatter ``(f-1)/f``, and the dp-axis
          all-reduce shrinks to its ``1/f`` shard;
        - zero-1: one extra sharded-parameter all-gather ``(d-1)/d``
          after the update;
        - pp axis ``p``: each device holds ``1/p`` of the layers, so
          the dp/fsdp/zero1 param-byte collectives all shrink by
          ``1/p`` (the stage-boundary activation ppermutes are
          activation bytes — ~0 in units of P, charged through the
          bubble model instead).

        A *model*, not a measurement — it only ever scales the comm
        share the kernel ledger measured, so an error here distorts a
        fraction of a fraction of the step."""
        axes = wd.axis_sizes()
        d = axes.get("dp", 1)
        f = axes.get("fsdp", 1)
        p = axes.get("pp", 1)
        grads = 2.0 * (d - 1) / d / f
        params = (2.0 * (f - 1) / f + (f - 1) / f) if f > 1 else 0.0
        z1 = (d - 1) / d if wd.zero1 else 0.0
        return (grads + params + z1) / p

    def _bubble_fraction(self, wd: WorldDescriptor) -> float:
        """Steady-state pipeline bubble of a candidate: the interleaved
        1f1b model ``(p-1)/(p*m)`` the engine's schedule contract pins
        (``parallel/pp_schedule.py``; virtual stages ``v=p``). Non-pp
        worlds idle nothing."""
        p = wd.pp
        if p <= 1:
            return 0.0
        return (p - 1) / (p * self.pp_microbatches)

    def predict_layout_step_time(
        self, wd: WorldDescriptor, inputs: PlannerInputs
    ) -> float:
        """Predicted p50 step seconds after a SAME-world layout flip:
        the kernel ledger's measured ``comm.*`` share of the step is
        rescaled by the layouts' relative comm-volume model; the
        compute share is untouched (same chips, same per-device flops).
        No measured breakdown → no predicted change → the gain gate
        HOLDs (the planner never flips a layout on an unmeasured
        claim)."""
        base = inputs.step_p50_s
        if base <= 0:
            return 0.0
        comm_share = sum(
            v for k, v in inputs.kernel_breakdown.items()
            if k.startswith("comm.")
        )
        comm_share = min(max(comm_share, 0.0), 0.95)
        if comm_share <= 0:
            return base
        cur = self._descriptor_of_spec(self._current_spec(inputs))
        cur_ratio = self._layout_comm_ratio(cur) if cur is not None \
            else None
        if not cur_ratio:
            return base
        scale = self._layout_comm_ratio(wd) / cur_ratio
        # the compute share carries the pipeline bubble: measured time
        # is ideal work / (1 - bubble), so a pp flip rescales it by
        # (1 - bubble_now) / (1 - bubble_candidate)
        bubble_now = self._bubble_fraction(cur) if cur is not None else 0.0
        compute_scale = (1.0 - bubble_now) / max(
            1.0 - self._bubble_fraction(wd), 1e-6
        )
        return (base * (1.0 - comm_share) * compute_scale
                + base * comm_share * scale)

    @staticmethod
    def _descriptor_of_spec(spec: str) -> Optional[WorldDescriptor]:
        try:
            return WorldDescriptor.parse(spec) if spec else None
        except ValueError:
            return None

    def _hbm_feasible(
        self, wd: WorldDescriptor, inputs: PlannerInputs
    ) -> bool:
        """Shrinking packs more state per device: project occupancy by
        the world ratio and reject candidates that would land inside
        the headroom reserve. Unknown occupancy gates nothing."""
        if inputs.hbm_used_bytes <= 0 or inputs.hbm_capacity_bytes <= 0:
            return True
        if wd.world_size >= inputs.world:
            return True
        projected = inputs.hbm_used_bytes * (
            inputs.world / wd.world_size
        )
        return projected <= inputs.hbm_capacity_bytes * (
            1.0 - self.hbm_headroom_frac
        )

    def score(self, wd: WorldDescriptor, inputs: PlannerInputs) -> Dict:
        """Predicted productive seconds over the payback horizon,
        normalized to current-throughput units: steps the candidate
        completes in ``horizon_s`` (paying the measured resize cost
        up-front when it differs from the current world), divided by
        the steps the current world would complete. >1 = the resize
        pays back inside the horizon."""
        t_now = inputs.step_p50_s
        t_next = self.predict_step_time(wd, inputs)
        cur_spec = self._current_spec(inputs)
        if t_now <= 0 or t_next <= 0:
            return {"spec": wd.spec, "world": wd.world_size,
                    "score": 1.0 if wd.spec == cur_spec else 0.0,
                    "t_pred_s": round(t_next, 6), "payback_s": None}
        cost = 0.0
        if wd.world_size != inputs.world:
            cost = inputs.resize_cost_s or self.default_resize_cost_s
        elif wd.spec != cur_spec:
            # same-world layout flip: a warm in-process remesh, not a
            # membership change
            cost = self.layout_cost_s
        horizon = max(self.horizon_s, cost)
        steps_next = max(0.0, horizon - cost) / t_next
        steps_now = horizon / t_now
        # payback: seconds of candidate runtime until the throughput
        # delta has earned the downtime back (None = never)
        rate_gain = 1.0 / t_next - 1.0 / t_now
        payback = (
            cost / (rate_gain * t_now) if rate_gain > 0 and cost > 0
            else (0.0 if cost == 0 else None)
        )
        return {
            "spec": wd.spec,
            "world": wd.world_size,
            "score": round(steps_next / steps_now, 6),
            "t_pred_s": round(t_next, 6),
            "resize_cost_s": round(cost, 3),
            "payback_s": round(payback, 3) if payback is not None else None,
        }

    # -- candidates --------------------------------------------------------

    def _descriptor(
        self, nodes: int, n_slices: int, pp: int = 1
    ) -> Optional[WorldDescriptor]:
        """A node-level candidate descriptor. ``pp`` > 1 preserves the
        seated pipeline axis across the size change — a pp fleet's
        resize is a per-stage dp rebalance (live_reshard
        ``stage_transfer_plan`` kind ``dp_within_stage``), never a
        silent collapse to pure dp. Falls back to the pure-dp world
        when the stage count does not divide the candidate size or the
        world is multislice (a sliced pp world moves the stage map and
        is a different decision)."""
        axes = {"dp": nodes}
        if pp > 1 and n_slices <= 1 and nodes % pp == 0:
            axes = {"dp": nodes // pp, "pp": pp}
        try:
            return WorldDescriptor.from_axis_sizes(
                axes,
                n_slices=max(1, n_slices),
                hier=n_slices > 1,
            )
        except ValueError:
            return None

    def candidates(self, inputs: PlannerInputs) -> List[WorldDescriptor]:
        """Candidate worlds worth scoring: the current world (HOLD
        baseline), adopting the waiting capacity, a slice-aligned
        shrink, and a one-unit shrink. All node-level, rounded to
        ``node_unit``, bounded by min/max and what is actually
        reachable (seated + waiting)."""
        world = inputs.world
        if world <= 0:
            return []
        unit = max(1, inputs.node_unit)
        per_slice = (
            world // inputs.n_slices if inputs.n_slices > 1 else 0
        )
        upper = world + max(0, inputs.waiting)
        if inputs.max_nodes > 0:
            upper = min(upper, inputs.max_nodes)
        raw: List[tuple] = [(world, inputs.n_slices)]
        if upper > world:
            grow = (upper // unit) * unit
            if per_slice:
                grow = (grow // per_slice) * per_slice
            if grow > world:
                raw.append((
                    grow,
                    grow // per_slice if per_slice else 1,
                ))
        if per_slice and inputs.n_slices > 1:
            raw.append((world - per_slice, inputs.n_slices - 1))
        shrink = ((world - unit) // unit) * unit
        if shrink >= inputs.min_nodes and shrink > 0:
            slices = 1
            if per_slice and shrink % per_slice == 0:
                slices = shrink // per_slice
            raw.append((shrink, slices))
        out: List[WorldDescriptor] = []
        seen = set()
        seen_nodes = set()
        # the HOLD baseline must be the CURRENT layout, not the pure-dp
        # default of the same size — a zero1/fsdp fleet scored against
        # the wrong incumbent would mistake the flip for a hold
        cur = self._descriptor_of_spec(self._current_spec(inputs))
        if cur is not None and cur.world_size == world:
            out.append(cur)
            seen.add(cur.spec)
            seen_nodes.add(world)
        # the seated pipeline axis rides every size candidate: resizing
        # a pp fleet rebalances dp within stages, it does not flatten
        cur_pp = cur.pp if cur is not None else 1
        for nodes, slices in raw:
            if nodes < max(1, inputs.min_nodes) or nodes in seen_nodes:
                continue
            if inputs.max_nodes > 0 and nodes > inputs.max_nodes:
                continue
            wd = self._descriptor(nodes, slices, pp=cur_pp)
            if wd is None:
                continue
            if not self._hbm_feasible(wd, inputs):
                continue
            seen_nodes.add(nodes)
            seen.add(wd.spec)
            out.append(wd)
        for wd in self.layout_candidates(inputs):
            if wd.spec not in seen:
                seen.add(wd.spec)
                out.append(wd)
        return out

    def _oracle_vetoes(
        self, cands: List[WorldDescriptor], inputs: PlannerInputs
    ) -> Tuple[List[WorldDescriptor], List[WorldDescriptor], List[Dict]]:
        """Price every non-incumbent candidate through the static
        headroom oracle. Returns ``(survivors, vetoed_wds,
        veto_records)`` — the records are the ledger-facing evidence
        ({spec, world, predicted/usable/budget bytes}). The incumbent
        is never vetoed: the fleet is already running it, and HOLD
        needs its baseline. Unarmed oracle -> everything survives."""
        if self._oracle is None:
            return cands, [], []
        cur_spec = self._current_spec(inputs)
        survivors: List[WorldDescriptor] = []
        vetoed: List[WorldDescriptor] = []
        records: List[Dict] = []
        for wd in cands:
            if wd.spec == cur_spec:
                survivors.append(wd)
                continue
            try:
                verdict = self._oracle.fits(wd)
            except Exception as e:
                # a broken oracle must never stall scaling decisions
                logger.warning("planner: headroom oracle failed: %s", e)
                survivors.append(wd)
                continue
            if verdict.get("fits", True):
                survivors.append(wd)
            else:
                vetoed.append(wd)
                records.append({
                    "spec": wd.spec,
                    "world": wd.world_size,
                    "predicted_bytes": int(verdict.get("peak_bytes", 0)),
                    "usable_bytes": int(verdict.get("usable_bytes", 0)),
                    "budget_bytes": int(verdict.get("budget_bytes", 0)),
                })
        return survivors, vetoed, records

    def layout_candidates(
        self, inputs: PlannerInputs
    ) -> List[WorldDescriptor]:
        """SAME-world candidates that re-factorize the mesh instead of
        changing membership: dp↔fsdp splits of the seated node count
        and the zero-1 toggle on the current factorization. Acting on
        one is a warm in-process remesh (the speculation hint carries
        the target spec, so workers warm-compile it), not a resize.
        Single-slice worlds only — a multislice layout flip also moves
        the DCN schedule and is a different decision."""
        world = inputs.world
        if world <= 0 or inputs.n_slices > 1:
            return []
        cur = self._descriptor_of_spec(self._current_spec(inputs))
        out: List[WorldDescriptor] = []

        def _add(axes: Dict[str, int], zero1: bool):
            try:
                wd = WorldDescriptor.from_axis_sizes(
                    dict(axes), n_slices=1, zero1=zero1
                )
            except ValueError:
                return
            if cur is None or wd.spec != cur.spec:
                out.append(wd)

        cur_axes = cur.axis_sizes() if cur is not None else {"dp": world}
        cur_z1 = cur.zero1 if cur is not None else False
        # dp <-> fsdp factorizations of the same node count
        for f in (1, 2, 4, 8):
            if f < world and world % f == 0:
                axes = {"dp": world // f}
                if f > 1:
                    axes["fsdp"] = f
                _add(axes, cur_z1)
        # pp re-factorizations — only when the fleet already REPORTS a
        # pp layout (the engine is proven to slab this model; the
        # planner cannot check n_layers % p from here): stage count
        # halved/doubled (per-stage dp width moves the other way) and
        # the pp exit (pure data axes) falls out of the dp/fsdp loop
        # above. Scored by the same measured-comm-share model — all
        # param collectives shrink 1/p, the compute share carries the
        # interleaved 1f1b bubble (p-1)/(p*m) — so a flip is never
        # adopted on an unmeasured claim.
        cur_pp = cur_axes.get("pp", 1)
        if cur_pp > 1:
            for p in {cur_pp // 2, cur_pp * 2}:
                if p > 1 and p != cur_pp and p <= world and world % p == 0:
                    axes = dict(cur_axes)
                    axes.pop("fsdp", None)
                    axes["pp"] = p
                    axes["dp"] = world // p
                    _add(axes, cur_z1)
        # the zero-1 toggle on the current factorization
        _add(cur_axes, not cur_z1)
        return out

    # -- the decision ------------------------------------------------------

    def decide(
        self,
        inputs: Optional[PlannerInputs] = None,
        now: Optional[float] = None,
    ) -> Dict:
        """One full observe→score→verdict pass. Appends the decision
        record to the ledger and returns it."""
        if inputs is None:
            inputs = self.observe(now)
        now = inputs.ts if now is None else now

        def record(verdict, reason, target=None, scores=None, payback=None,
                   vetoes=None):
            rec = {
                "ts": round(now, 3),
                "verdict": verdict,
                "reason": reason,
                "current_world": inputs.world,
                "target": target.spec if target is not None else "",
                "target_world": (
                    target.world_size if target is not None else 0
                ),
                "scores": scores or [],
                "payback_s": payback,
                # the oracle's oom evidence rides EVERY record of the
                # round that produced it (post-baseline ledger readers
                # use .get — wirecheck WC002 discipline), so a veto is
                # auditable even when the verdict itself is a plain
                # hold/resize on a surviving candidate
                "vetoes": list(vetoes or []),
                "inputs": inputs.snapshot(),
            }
            with self._lock:
                self._last_decide_ts = now
                self._counts[verdict] = self._counts.get(verdict, 0) + 1
                if verdict == RESIZE and target is not None:
                    self._intent = target
                    self._intent_executed = False
                    self._intent_from = inputs.world
                    self._intent_ts = now
                    self._publish_locked()
                self._ledger.append(rec)
                del self._ledger[:-LEDGER_CAP]
                self._decisions_total += 1
            if verdict == RESIZE:
                logger.info(
                    "planner: RESIZE %d -> %s (%s)",
                    inputs.world, rec["target"], reason,
                )
            return rec

        with self._lock:
            intent = self._intent
            intent_from = self._intent_from
            last_exec = self._last_exec_ts
        if intent is not None:
            target = intent.world_size
            if target == intent_from:
                # a layout intent: the node count never moves, so
                # "seated" means the fleet reports the target layout —
                # a layout-blind fleet satisfies immediately (the act
                # path is an in-process remesh; nothing to wait on)
                satisfied = (
                    not inputs.layout_spec
                    or inputs.layout_spec == intent.spec
                )
            else:
                satisfied = (
                    inputs.world >= target if target >= intent_from
                    else inputs.world <= target
                )
            reachable = inputs.world + max(0, inputs.waiting)
            expired = (
                # the capacity the intent targeted died before adoption:
                # a growth approval for nodes that no longer exist must
                # not hold the gate open for whoever joins NEXT
                (target > inputs.world and target > reachable)
                # ...and an approval never survives into instability —
                # adopting fresh capacity mid-straggler-episode is the
                # exact unapproved scale-out the gate exists to prevent
                or inputs.stragglers
                or inputs.downtime_open
            )
            if satisfied or expired:
                # satisfied: the intended world seated; expired: the
                # conditions the approval was granted under are gone.
                # Either way the growth gate closes and the speculation
                # hint clears (a stable fleet re-earns a new intent
                # through the normal hysteresis path).
                with self._lock:
                    self._intent = None
                    self._intent_executed = False
                    self._publish_locked()
                intent = None
        if inputs.world <= 0 or inputs.step_p50_s <= 0:
            self._reset_streak()
            return record(HOLD, "no_signal")
        if inputs.downtime_open or inputs.stragglers:
            # instability: a fleet mid-recovery or mid-straggler-episode
            # never triggers a resize — and the streak resets, so one
            # healthy window after the storm cannot flip the decision
            # either (hysteresis restarts from zero)
            self._reset_streak()
            return record(
                HOLD,
                "unstable:" + (
                    "downtime" if inputs.downtime_open else "stragglers"
                ),
            )
        if last_exec > 0 and now - last_exec < self.cooldown_s:
            self._reset_streak()
            return record(HOLD, "cooldown")
        cands, vetoed_wds, vetoes = self._oracle_vetoes(
            self.candidates(inputs), inputs
        )
        if not cands:
            self._reset_streak()
            return record(
                HOLD, "oom_veto" if vetoes else "no_candidates",
                vetoes=vetoes,
            )
        scores = [self.score(wd, inputs) for wd in cands]
        by_spec = {wd.spec: wd for wd in cands}
        best = max(scores, key=lambda s: (s["score"], -s["world"]))
        # the HOLD baseline is the current LAYOUT, not just the current
        # world size: same-world layout candidates share the size and
        # must not be mistaken for the incumbent
        cur_spec = self._current_spec(inputs)
        current_score = next(
            (s for s in scores if s["spec"] == cur_spec),
            next((s for s in scores if s["world"] == inputs.world), None),
        )
        baseline = current_score["score"] if current_score else 1.0
        # the oracle's vetoed candidates are still SCORED: when the
        # throughput winner is a world that cannot fit, the honest
        # verdict is "oom_veto on that world", not "no paying
        # candidate" — the ledger must show the resize the planner
        # WANTED and why it refused it. A HOLD forms no intent, so the
        # vetoed target is never gated in and never pre-warmed.
        if vetoed_wds:
            veto_scores = [self.score(wd, inputs) for wd in vetoed_wds]
            best_vetoed = max(
                veto_scores, key=lambda s: (s["score"], -s["world"])
            )
            if (
                best_vetoed["score"] > best["score"]
                and best_vetoed["score"]
                >= baseline * (1.0 + self.min_gain_frac)
            ):
                self._reset_streak()
                vetoed_by_spec = {wd.spec: wd for wd in vetoed_wds}
                return record(
                    HOLD, "oom_veto",
                    target=vetoed_by_spec[best_vetoed["spec"]],
                    scores=scores + veto_scores,
                    payback=best_vetoed.get("payback_s"),
                    vetoes=vetoes,
                )
        if (
            best["spec"] == cur_spec
            or best["score"] < baseline * (1.0 + self.min_gain_frac)
        ):
            self._reset_streak()
            return record(HOLD, "no_paying_candidate", scores=scores,
                          vetoes=vetoes)
        # hysteresis: the SAME winning candidate must survive K
        # consecutive decisions before it becomes a plan
        with self._lock:
            if self._streak_spec == best["spec"]:
                self._streak += 1
            else:
                self._streak_spec, self._streak = best["spec"], 1
            streak = self._streak
        if streak < self.hysteresis:
            return record(
                HOLD, f"hysteresis:{streak}/{self.hysteresis}",
                target=by_spec[best["spec"]], scores=scores,
                payback=best.get("payback_s"), vetoes=vetoes,
            )
        self._reset_streak()
        target = by_spec[best["spec"]]
        reason = (
            "layout_payback" if target.world_size == inputs.world
            else "payback"
        )
        return record(
            RESIZE, reason, target=target,
            scores=scores, payback=best.get("payback_s"), vetoes=vetoes,
        )

    def _reset_streak(self):
        with self._lock:
            self._streak_spec, self._streak = "", 0

    def sweep(self, now: Optional[float] = None) -> Optional[Dict]:
        """Throttled decide for poll loops (the autoscaler thread, the
        fleet harness tick loop): no-op until ``decide_interval_s`` has
        passed since the last decision."""
        now = self._clock() if now is None else now
        with self._lock:
            if now - self._last_decide_ts < self.decide_interval_s:
                return None
        return self.decide(now=now)

    # -- act plumbing ------------------------------------------------------

    def intent(self) -> Optional[WorldDescriptor]:
        with self._lock:
            return self._intent

    def _publish_locked(self):
        """Rebuild the lock-free poll publication. Caller holds the
        lock. Only an EXECUTED intent opens the gate / publishes the
        hint: a RESIZE decision whose scaler push failed leaves the
        fleet exactly as gated as before (and with no cooldown open,
        the next sweep retries the plan)."""
        if self._intent is not None and self._intent_executed:
            self._pub = (self._intent.to_wire(), self._intent.world_size)
        else:
            self._pub = ({}, -1)

    def note_executed(self, target: WorldDescriptor, now: Optional[float] = None):
        """The autoscaler pushed the plan to the scaler: start the
        cooldown window, remember the execution for the ledger (at
        most one executed plan per cooldown window by construction),
        and — only now — open the growth gate / publish the hint."""
        now = self._clock() if now is None else now
        with self._lock:
            self._last_exec_ts = now
            self._executed.append({
                "ts": round(now, 3),
                "target": target.spec,
                "target_world": target.world_size,
            })
            del self._executed[:-LEDGER_CAP]
            if (
                self._intent is not None
                and self._intent.spec == target.spec
            ):
                self._intent_executed = True
            self._publish_locked()

    def growth_allowed(self, seated_world: int) -> bool:
        """The rendezvous growth gate: waiting capacity is advertised
        to a HEALTHY seated fleet only while an EXECUTED plan grows
        past it (shrink/recovery paths never consult this). Called on
        the lock-free poll fast path and under the rendezvous lock —
        reads one published reference, takes no lock."""
        return self._pub[1] > seated_world

    def speculation_hint(self) -> Dict:
        """The rendezvous world poll's hint payload: the exact world
        the planner's EXECUTED plan targets ({} = no executed intent).
        Old agents drop the unknown field (serde), new agents
        warm-compile the target. Lock-free (published reference) — it
        rides the protocol's highest-rate poll."""
        return dict(self._pub[0])

    # -- observability / continuity ----------------------------------------

    def report(self, last_n: int = 32) -> Dict:
        """The goodput report's ``decisions`` section."""
        with self._lock:
            return {
                "counts": dict(self._counts),
                "intent": (
                    self._intent.spec if self._intent is not None else ""
                ),
                "executed": list(self._executed[-last_n:]),
                "last": list(self._ledger[-last_n:]),
                "total": self._decisions_total,
            }

    def prometheus_lines(self) -> List[str]:
        with self._lock:
            counts = dict(self._counts)
            last = self._ledger[-1] if self._ledger else None
            executed = len(self._executed)
            intent = self._intent
        lines = ["# TYPE dlrover_tpu_scale_decisions_total counter"]
        for verdict in sorted(counts):
            lines.append(
                f'dlrover_tpu_scale_decisions_total{{verdict="{verdict}"}} '
                f"{counts[verdict]}"
            )
        lines.append(
            f"dlrover_tpu_planner_executed_plans_total {executed}"
        )
        lines.append(
            "dlrover_tpu_planner_intent_world "
            f"{intent.world_size if intent is not None else 0}"
        )
        if last is not None:
            lines.append(
                f'dlrover_tpu_planner_last_decision{{verdict='
                f'"{last["verdict"]}",reason="{last["reason"]}"}} '
                f'{last["ts"]}'
            )
            lines.append(
                "dlrover_tpu_planner_last_target_world "
                f"{last['target_world']}"
            )
        return lines

    def export_state(self) -> Dict:
        """Durable ledger snapshot: decisions, executions, cooldown and
        hysteresis state survive a master relaunch — a relaunched
        planner must not re-execute a plan the dead master just paid
        for, nor forget a hysteresis streak mid-confirmation."""
        with self._lock:
            return {
                "ledger": list(self._ledger),
                "decisions_total": self._decisions_total,
                "executed": list(self._executed),
                "counts": dict(self._counts),
                "intent": (
                    self._intent.spec if self._intent is not None else ""
                ),
                "intent_executed": self._intent_executed,
                "intent_from": self._intent_from,
                "intent_ts": self._intent_ts,
                "last_exec_ts": self._last_exec_ts,
                "last_decide_ts": self._last_decide_ts,
                "streak_spec": self._streak_spec,
                "streak": self._streak,
            }

    def import_state(self, state: Dict):
        if not state:
            return
        intent = None
        spec = str(state.get("intent", "") or "")
        if spec:
            try:
                intent = WorldDescriptor.parse(spec)
            except ValueError:
                logger.warning("planner: dropping bad intent %r", spec)
        with self._lock:
            self._ledger = list(state.get("ledger") or [])[-LEDGER_CAP:]
            self._decisions_total = int(
                state.get("decisions_total", len(self._ledger))
            )
            self._executed = list(state.get("executed") or [])[-LEDGER_CAP:]
            counts = state.get("counts") or {}
            self._counts = {
                str(k): int(v) for k, v in counts.items()
            } or {HOLD: 0, RESIZE: 0}
            self._intent = intent
            self._intent_executed = bool(
                state.get("intent_executed", intent is not None)
            )
            self._intent_from = int(state.get("intent_from", 0))
            self._intent_ts = float(state.get("intent_ts", 0.0))
            self._publish_locked()
            self._last_exec_ts = float(state.get("last_exec_ts", 0.0))
            self._last_decide_ts = float(state.get("last_decide_ts", 0.0))
            self._streak_spec = str(state.get("streak_spec", ""))
            self._streak = int(state.get("streak", 0))
