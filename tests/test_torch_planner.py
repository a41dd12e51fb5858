"""The port's goodput planner (dlrover_tpu_torch/brain/planner.py) and its
world vocabulary (common/world.py), held to the JAX package's on the CPU.

Every case of the JAX package's ``tests/test_planner.py`` runs here as one
script of inputs on a virtual clock, fed to the JAX ``GoodputPlanner`` and
to the port's side by side (``Pair``): every decision record, candidate
set, prediction, score, gate answer and hint must be equal, and at the end
both planners' ``export_state()`` must serialise to byte-equal JSON. The
headroom-oracle cases inject one fake oracle into both (the JAX package's
``lint/memcheck.HeadroomOracle`` is not ported). Beside them: the
``WorldDescriptor`` grammar round-trips equal across the packages; a
planner ledger written through one package's state store restores in the
other's planner; ``observe()`` reads equal inputs from each package's own
speed monitor, rendezvous manager and job context; the port's ``/metrics``
carries the planner's lines; the hint rides the port's membership poll,
the master client and the worker context; and no module of the decision
path calls a wall clock.
"""

import ast
import json
import os
import urllib.request

import pytest

from dlrover_tpu.brain import planner as jplan
from dlrover_tpu.common import world as jworld
from dlrover_tpu_torch.brain import planner as pplan
from dlrover_tpu_torch.common import world as pworld

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dump(x):
    return json.dumps(x, sort_keys=True)


class Pair:
    """The JAX planner and the port's, driven by one script: each call
    runs on both and asserts the normalised outputs equal, returning the
    port's."""

    def __init__(self, **kw):
        kw.setdefault("clock", lambda: 0.0)
        kw.setdefault("cooldown_s", 100.0)
        kw.setdefault("horizon_s", 600.0)
        kw.setdefault("hysteresis", 2)
        kw.setdefault("decide_interval_s", 10.0)
        self.jax = jplan.GoodputPlanner(**kw)
        self.port = pplan.GoodputPlanner(**kw)

    @staticmethod
    def inputs(mod, ts=0.0, world=8, **kw):
        kw.setdefault("step_p50_s", 1.0)
        kw.setdefault("resize_cost_s", 10.0)
        return mod.PlannerInputs(ts=ts, world=world, **kw)

    def both(self, fn):
        """``fn(planner, plan_mod, world_mod)`` on both; equal results
        (normalised, ``_norm``)."""
        a = _norm(fn(self.jax, jplan, jworld))
        b = _norm(fn(self.port, pplan, pworld))
        assert _dump(a) == _dump(b)
        return b

    def decide(self, **kw):
        return self.both(lambda p, m, w: p.decide(
            inputs=self.inputs(m, **kw)))

    def drive_to_resize(self, make_kw, start=0.0, step=10.0, max_n=10):
        t = start
        d = None
        for _ in range(max_n):
            d = self.decide(**make_kw(t))
            if d["verdict"] == pplan.RESIZE:
                return d
            t += step
        return d

    def execute(self, now):
        self.both(lambda p, m, w: p.note_executed(p.intent(), now=now))

    def candidates(self, **kw):
        return self.both(lambda p, m, w: p.candidates(self.inputs(m, **kw)))

    def gate(self, seated):
        return self.both(lambda p, m, w: p.growth_allowed(seated))

    def hint(self):
        return self.both(lambda p, m, w: p.speculation_hint())

    def intent(self):
        return self.both(lambda p, m, w: p.intent())

    def report(self):
        return self.both(lambda p, m, w: p.report())

    def state_equal(self):
        a = json.dumps(self.jax.export_state(), sort_keys=True)
        b = json.dumps(self.port.export_state(), sort_keys=True)
        assert a == b
        return json.loads(b)


def _norm(x):
    """Package-neutral form: descriptors as their spec and world."""
    if isinstance(x, (jworld.WorldDescriptor, pworld.WorldDescriptor)):
        return {"spec": x.spec, "world": x.world_size, "wire": x.to_wire()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


def _specs(cands):
    return {c["spec"] for c in cands}


def _worlds(cands):
    return {c["world"] for c in cands}


# -- the JAX package's planner cases, one script each ---------------------------


def case_grow_pays_back_and_resizes_after_hysteresis():
    pair = Pair()
    d1 = pair.decide(ts=0.0, waiting=4)
    assert d1["verdict"] == pplan.HOLD and "hysteresis" in d1["reason"]
    assert d1["target"] == "dp12"
    d2 = pair.decide(ts=10.0, waiting=4)
    assert d2["verdict"] == pplan.RESIZE and d2["target_world"] == 12
    assert d2["payback_s"] is not None and d2["payback_s"] > 0
    # a decision alone opens nothing: only the executed plan does
    assert pair.hint() == {} and not pair.gate(8)
    pair.execute(10.0)
    assert pair.hint() == {"spec": "dp12", "world": 12, "n_slices": 1}
    assert pair.gate(8)
    return [pair]


def case_resize_cost_exceeding_horizon_gain_holds():
    pair = Pair(horizon_s=600.0)
    d = pair.drive_to_resize(
        lambda t: dict(ts=t, waiting=4, resize_cost_s=250.0))
    assert d["verdict"] == pplan.HOLD
    assert d["reason"] == "no_paying_candidate"
    cheap = Pair()
    d = cheap.drive_to_resize(
        lambda t: dict(ts=t, waiting=4, resize_cost_s=10.0))
    assert d["verdict"] == pplan.RESIZE
    return [pair, cheap]


def case_unmeasured_resize_cost_uses_conservative_default():
    pair = Pair(default_resize_cost_s=250.0, horizon_s=600.0)
    d = pair.drive_to_resize(
        lambda t: dict(ts=t, waiting=4, resize_cost_s=0.0))
    assert d["verdict"] == pplan.HOLD
    return [pair]


def case_hbm_infeasible_shrink_rejected():
    pair = Pair(hbm_headroom_frac=0.10)
    tight = pair.candidates(world=8, waiting=4, hbm_used_bytes=14e9,
                            hbm_capacity_bytes=16e9)
    assert 7 not in _worlds(tight) and {8, 12} <= _worlds(tight)
    roomy = pair.candidates(world=8, waiting=4, hbm_used_bytes=4e9,
                            hbm_capacity_bytes=16e9)
    assert 7 in _worlds(roomy)
    assert 7 in _worlds(pair.candidates(world=8, waiting=4))
    return [pair]


def case_dcn_model_prefers_slice_aligned_shrink():
    pair = Pair(dcn_gbps=25.0)
    kw = dict(world=8, n_slices=4,
              comm_links={"ici": int(60e9), "dcn": int(20e9)})

    def aligned(w):
        return w.WorldDescriptor.from_axis_sizes({"dp": 6}, n_slices=3,
                                                 hier=True)

    def ragged(w):
        return w.WorldDescriptor.from_axis_sizes({"dp": 7})

    t_aligned = pair.both(lambda p, m, w: p.predict_step_time(
        aligned(w), pair.inputs(m, **kw)))
    t_ragged = pair.both(lambda p, m, w: p.predict_step_time(
        ragged(w), pair.inputs(m, **kw)))
    assert t_aligned == pytest.approx(0.2 * 8 / 6 + 0.8, rel=1e-3)
    assert t_ragged == pytest.approx(0.2 * 8 / 7 + 1.2, rel=1e-3)
    s_aligned = pair.both(lambda p, m, w: p.score(
        aligned(w), pair.inputs(m, **kw)))
    s_ragged = pair.both(lambda p, m, w: p.score(
        ragged(w), pair.inputs(m, **kw)))
    assert s_aligned["score"] > s_ragged["score"]
    cands = {c["world"]: c for c in pair.candidates(**kw)}
    assert cands[6]["wire"]["n_slices"] == 3 and cands[6]["spec"] == \
        "dp6+3slice"
    return [pair]


def case_single_slice_world_has_no_dcn_penalty():
    pair = Pair()
    t = pair.both(lambda p, m, w: p.predict_step_time(
        w.WorldDescriptor.from_axis_sizes({"dp": 4}),
        pair.inputs(m, world=8, n_slices=1, comm_links={"ici": int(9e9)})))
    assert t == pytest.approx(2.0)
    return [pair]


def case_one_healthy_window_does_not_flip_a_decision():
    pair = Pair(hysteresis=2)
    assert "hysteresis:1/2" in pair.decide(ts=0.0, waiting=4)["reason"]
    d = pair.decide(ts=10.0, waiting=4, stragglers=[3])
    assert d["reason"] == "unstable:stragglers"
    d = pair.decide(ts=20.0, waiting=4)
    assert d["verdict"] == pplan.HOLD and "hysteresis:1/2" in d["reason"]
    assert pair.decide(ts=30.0, waiting=4)["verdict"] == pplan.RESIZE
    return [pair]


def case_open_downtime_bracket_holds():
    pair = Pair()
    d = pair.decide(ts=0.0, waiting=4, downtime_open=True)
    assert d["verdict"] == pplan.HOLD and d["reason"] == "unstable:downtime"
    return [pair]


def case_cooldown_bounds_executed_plans():
    pair = Pair(cooldown_s=100.0)
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4))
    assert d["verdict"] == pplan.RESIZE
    pair.execute(d["ts"])
    d2 = pair.decide(ts=d["ts"] + 10, world=12)
    assert d2["verdict"] == pplan.HOLD and d2["reason"] == "cooldown"
    assert pair.intent() is None
    assert pair.decide(ts=d["ts"] + 50, world=12,
                       waiting=4)["reason"] == "cooldown"
    assert "hysteresis" in pair.decide(ts=d["ts"] + 150, world=12,
                                       waiting=4)["reason"]
    return [pair]


def case_no_signal_holds():
    pair = Pair()
    d = pair.both(lambda p, m, w: p.decide(inputs=m.PlannerInputs(
        ts=0.0, world=8, step_p50_s=0.0)))
    assert d["verdict"] == pplan.HOLD and d["reason"] == "no_signal"
    return [pair]


def case_growth_gate_follows_executed_intent():
    pair = Pair()
    assert not pair.gate(8)
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4))
    assert not pair.gate(8)
    pair.execute(d["ts"])
    assert pair.gate(8) and not pair.gate(12)
    return [pair]


def case_prometheus_lines_count_decisions():
    pair = Pair()
    pair.decide(ts=0.0)
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4), start=10.0)
    assert d["verdict"] == pplan.RESIZE
    rows = "\n".join(pair.both(lambda p, m, w: p.prometheus_lines()))
    assert 'dlrover_tpu_scale_decisions_total{verdict="resize"} 1' in rows
    assert "dlrover_tpu_planner_intent_world 12" in rows
    assert "dlrover_tpu_planner_last_target_world 12" in rows
    return [pair]


def case_stale_intent_expires_when_capacity_dies_or_instability_hits():
    pair = Pair()
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4))
    pair.execute(d["ts"])
    assert pair.gate(8)
    pair.decide(ts=200.0, world=8, waiting=0)
    assert pair.intent() is None and not pair.gate(8)
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4), start=310.0)
    pair.execute(d["ts"])
    assert pair.gate(8)
    d = pair.decide(ts=500.0, world=8, waiting=4, stragglers=[1])
    assert d["reason"] == "unstable:stragglers"
    assert pair.intent() is None and not pair.gate(8) and pair.hint() == {}
    return [pair]


def case_decision_counter_survives_ledger_cap():
    pair = Pair(hysteresis=10_000)
    n = pplan.LEDGER_CAP + 7
    assert pplan.LEDGER_CAP == jplan.LEDGER_CAP
    for i in range(n):
        pair.decide(ts=float(i), waiting=4)
    assert pair.report()["total"] == n
    assert len(pair.state_equal()["ledger"]) == pplan.LEDGER_CAP
    again = Pair()
    state = json.loads(json.dumps(pair.port.export_state()))
    again.both(lambda p, m, w: p.import_state(state))
    assert again.report()["total"] == n
    return [pair, again]


def case_layout_comm_ratio_model():
    pair = Pair()
    for spec, want in (("dp4", 1.5), ("dp4+zero1", 2.25),
                       ("dp2xfsdp2", 2.0), ("dp1", 0.0)):
        got = pair.both(lambda p, m, w: type(p)._layout_comm_ratio(
            w.WorldDescriptor.parse(spec)))
        assert got == pytest.approx(want)
    return [pair]


def case_layout_candidates_same_world_only():
    pair = Pair()
    cands = pair.both(lambda p, m, w: p.layout_candidates(
        pair.inputs(m, world=4, layout_spec="dp4+zero1")))
    specs = _specs(cands)
    assert "dp4+zero1" not in specs
    assert {"dp2xfsdp2+zero1", "dp4"} <= specs
    assert _worlds(cands) == {4}
    assert pair.both(lambda p, m, w: p.layout_candidates(
        pair.inputs(m, world=8, n_slices=2, layout_spec=""))) == []
    return [pair]


def case_predict_layout_step_time_rescales_only_comm_share():
    pair = Pair()
    kb = {"comm.all-reduce": 0.3, "comm.all-gather": 0.1,
          "matmul": 0.4, "attention.bwd": 0.2}
    t = pair.both(lambda p, m, w: p.predict_layout_step_time(
        w.WorldDescriptor.parse("dp4"),
        pair.inputs(m, world=4, layout_spec="dp4+zero1",
                    kernel_breakdown=kb)))
    assert t == pytest.approx(0.6 + 0.4 * (1.5 / 2.25))
    blind = pair.both(lambda p, m, w: p.predict_layout_step_time(
        w.WorldDescriptor.parse("dp4"),
        pair.inputs(m, world=4, layout_spec="dp4+zero1")))
    assert blind == pytest.approx(1.0)
    return [pair]


def case_layout_flip_resizes_with_layout_payback_reason():
    pair = Pair()
    kb = {"comm.all-reduce": 0.4, "matmul": 0.6}
    d = pair.drive_to_resize(lambda t: dict(
        ts=t, world=4, layout_spec="dp4+zero1", kernel_breakdown=kb))
    assert d["verdict"] == pplan.RESIZE and d["reason"] == "layout_payback"
    assert d["target"] == "dp4" and d["target_world"] == 4
    assert {"dp4+zero1", "dp4"} <= {s["spec"] for s in d["scores"]}
    pair.execute(100.0)
    assert pair.hint()["spec"] == "dp4"
    return [pair]


def case_layout_flip_holds_without_measured_breakdown():
    pair = Pair()
    d = pair.drive_to_resize(lambda t: dict(ts=t, world=4,
                                            layout_spec="dp4+zero1"))
    assert d["verdict"] == pplan.HOLD
    assert d["reason"] == "no_paying_candidate"
    return [pair]


def case_layout_intent_satisfied_by_reported_spec():
    pair = Pair()
    kb = {"comm.all-reduce": 0.4, "matmul": 0.6}

    def mk(t):
        return dict(ts=t, world=4, layout_spec="dp4+zero1",
                    kernel_breakdown=kb)

    d = pair.drive_to_resize(mk)
    assert d["verdict"] == pplan.RESIZE and d["target"] == "dp4"
    pair.decide(**mk(200.0))
    assert pair.intent() is not None
    pair.decide(ts=300.0, world=4, layout_spec="dp4", kernel_breakdown=kb)
    assert pair.intent() is None
    return [pair]


class FakeOracle:
    """A duck-typed headroom oracle (the JAX ``HeadroomOracle``'s
    ``fits`` contract): 64 GB of zero-1 moments over dp plus 1 GB of
    temporaries a device, against 90 % of a ``budget_gb`` budget. At dp4
    that is 17 GB, over a 10 GB budget's 9 GB."""

    def __init__(self, budget_gb=10.0):
        self.budget = budget_gb * 1e9

    def fits(self, wd):
        peak = 64e9 / wd.world_size + 1e9
        usable = self.budget * 0.9
        return {"fits": peak <= usable, "peak_bytes": int(peak),
                "usable_bytes": int(usable), "budget_bytes": int(self.budget)}


class BoomOracle:
    def fits(self, wd):
        raise RuntimeError("no pricing today")


def _oom_kw(t=0.0):
    return dict(ts=t, world=8, n_slices=2, comm_links={"dcn": int(20e9)})


def case_oom_veto_blocks_the_winning_shrink():
    pair = Pair(hysteresis=1, headroom_oracle=FakeOracle())
    d = pair.decide(**_oom_kw())
    assert d["verdict"] == pplan.HOLD and d["reason"] == "oom_veto"
    assert d["target"] == "dp4" and d["target_world"] == 4
    v = next(r for r in d["vetoes"] if r["spec"] == "dp4")
    assert v["predicted_bytes"] > v["usable_bytes"] > 0
    assert v["budget_bytes"] == int(10e9)
    assert pair.intent() is None and pair.hint() == {}
    assert not pair.gate(8)
    for t in (10.0, 20.0, 30.0, 40.0):
        d = pair.decide(**_oom_kw(t))
        assert d["verdict"] == pplan.HOLD and d["reason"] == "oom_veto"
    return [pair]


def case_unarmed_planner_takes_the_same_shrink():
    pair = Pair(hysteresis=1)
    d = pair.drive_to_resize(_oom_kw)
    assert d["verdict"] == pplan.RESIZE and d["target_world"] == 4
    assert d["vetoes"] == []
    return [pair]


def case_oracle_with_headroom_vetoes_nothing():
    pair = Pair(hysteresis=1, headroom_oracle=FakeOracle(budget_gb=64.0))
    d = pair.drive_to_resize(_oom_kw)
    assert d["verdict"] == pplan.RESIZE and d["target_world"] == 4
    assert d["vetoes"] == []
    return [pair]


def case_broken_oracle_degrades_to_unarmed():
    pair = Pair(hysteresis=1, headroom_oracle=BoomOracle())
    d = pair.drive_to_resize(_oom_kw)
    assert d["verdict"] == pplan.RESIZE and d["target_world"] == 4
    return [pair]


def case_incumbent_is_never_vetoed():
    pair = Pair(hysteresis=1, headroom_oracle=FakeOracle(budget_gb=0.001))
    d = pair.decide(**_oom_kw())
    assert d["verdict"] == pplan.HOLD and d["reason"] == "oom_veto"
    vetoed = {r["spec"] for r in d["vetoes"]}
    assert vetoed and not vetoed & {"dp8+2slice", "dp8"}
    return [pair]


def case_sweep_throttles_on_the_injected_clock():
    clock = [5.0]
    pair = Pair(clock=lambda: clock[0], decide_interval_s=10.0)
    assert pair.both(lambda p, m, w: p.sweep()) is None
    clock[0] = 100.0
    first = pair.both(lambda p, m, w: p.sweep())
    assert first["reason"] == "no_signal"
    clock[0] = 105.0
    assert pair.both(lambda p, m, w: p.sweep()) is None
    clock[0] = 110.0
    assert pair.both(lambda p, m, w: p.sweep()) is not None
    return [pair]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_planner_case_matches_jax(case):
    """One JAX planner case's script through both planners: every output
    equal on the way, then ``export_state()`` byte-equal."""
    for pair in case():
        pair.state_equal()


# -- WorldDescriptor -------------------------------------------------------------

SPECS = ["dp1", "dp4", "dp12", "dp8+2slice", "dp6+3slice", "dp4+zero1",
         "dp4+2slice+overlap+zero1", "dp2xfsdp2", "dp2xfsdp2+zero1",
         "dp2xpp2", "pp2+2slice", "dp2xpp4+2slice", "dp2xsp2", "dp2xtp2",
         "dp2xfsdp2xtp2", "dp2xep2", "pp4"]
#: refused by the grammar, or read into another canonical spec
#: (``sp2xdp2`` is ``dp2xsp2``, ``dp0`` is ``dp1``)
ODD_SPECS = ["", "dp", "dp0", "foo2", "dp3+2slice", "dp4+overlap",
             "dp2xdp2", "sp2xdp2", "dp2x", "dp4+0slice"]


def _describe(wd):
    return {"spec": wd.spec, "mesh_spec": wd.mesh_spec,
            "world": wd.world_size, "axes": list(wd.axes),
            "axis_sizes": wd.axis_sizes(), "n_slices": wd.n_slices,
            "zero1": wd.zero1, "hier": wd.hier, "overlap": wd.overlap,
            "dp": wd.dp, "dp_in": wd.dp_in, "pp": wd.pp,
            "per_slice": wd.per_slice, "per_stage": wd.per_stage,
            "pp_spans_slices": wd.pp_spans_slices,
            "stage_map": [list(s) for s in wd.stage_map()],
            "wire": wd.to_wire()}


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", type(e).__name__)


@pytest.mark.parametrize("spec", SPECS + ODD_SPECS)
def test_world_spec_round_trips_equal_across_packages(spec):
    """``parse`` then ``spec`` round-trips for a canonical spec, and every
    derived field is equal in both packages; a spec the grammar refuses
    raises ``ValueError`` in both, and one it canonicalises reads the
    same in both."""
    j = _outcome(lambda: _describe(jworld.WorldDescriptor.parse(spec)))
    p = _outcome(lambda: _describe(pworld.WorldDescriptor.parse(spec)))
    assert j == p
    assert (p[0] == "ok") == (spec in SPECS or spec in (
        "dp0", "dp2xdp2", "sp2xdp2"))
    if spec in SPECS:
        assert p[1]["spec"] == spec
        assert pworld.WorldDescriptor.from_wire(p[1]["wire"]).spec == spec
        assert pworld.parse_contract_spec(spec) == \
            jworld.parse_contract_spec(spec)


@pytest.mark.parametrize("axes,kw", [
    ({"dp": 4}, {}), ({"dp": 2, "fsdp": 2}, {"zero1": True}),
    ({"tp": 2, "dp": 2}, {}), ({"dp": 1, "custom": 1}, {}),
    ({"dp": 2, "custom": 4}, {}), ({"dp": 4}, {"n_slices": 2, "hier": True}),
    ({"dp": 4}, {"hier": True}), ({"dp": 8}, {"n_slices": 2, "hier": True,
                                              "overlap": True}),
    ({"pp": 4, "dp": 1}, {"n_slices": 2}), ({}, {}),
])
def test_world_from_axis_sizes_equal_across_packages(axes, kw):
    j = _outcome(lambda: _describe(
        jworld.WorldDescriptor.from_axis_sizes(dict(axes), **kw)))
    p = _outcome(lambda: _describe(
        pworld.WorldDescriptor.from_axis_sizes(dict(axes), **kw)))
    assert j == p
    if axes == {"dp": 2, "custom": 4}:
        with pytest.raises(ValueError, match="non-canonical"):
            pworld.WorldDescriptor.from_axis_sizes(axes)
    if p[0] == "ok":
        args = (dict(axes), kw.get("zero1", False), kw.get("n_slices", 1),
                kw.get("overlap", False))
        assert _outcome(lambda: pworld.contract_spec_of(*args)) == \
            _outcome(lambda: jworld.contract_spec_of(*args))
    assert pworld.CANONICAL_AXES == jworld.CANONICAL_AXES


# -- the ledger across the packages' state stores --------------------------------


def _ledger_state():
    pair = Pair()
    d = pair.drive_to_resize(lambda t: dict(ts=t, waiting=4))
    pair.execute(d["ts"])
    pair.decide(ts=d["ts"] + 5, world=8, waiting=4)
    return pair.state_equal()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_planner_ledger_crosses_the_state_stores(writer, tmp_path):
    """A ledger saved through one package's ``MasterStateManager`` on the
    file backend restores in the other package's planner: its export is
    byte-equal to the writer's, and the relaunched planner keeps the
    cooldown (no immediate re-plan)."""
    from dlrover_tpu.master import state_store as jstore
    from dlrover_tpu_torch.master import state_store as pstore

    stores = {"jax": (jstore, jplan), "port": (pstore, pplan)}
    reader = "port" if writer == "jax" else "jax"
    state = _ledger_state()
    wstore, _ = stores[writer]
    rstore, rplan = stores[reader]
    wstore.MasterStateManager(wstore.FileStateBackend(
        str(tmp_path)), job_uid="u1").save_planner(state)
    loaded = rstore.MasterStateManager(rstore.FileStateBackend(
        str(tmp_path)), job_uid="u1").load_planner()
    planner = rplan.GoodputPlanner(clock=lambda: 0.0, cooldown_s=100.0,
                                   horizon_s=600.0, hysteresis=2,
                                   decide_interval_s=10.0)
    planner.import_state(loaded)
    assert json.dumps(planner.export_state(), sort_keys=True) == \
        json.dumps(state, sort_keys=True)
    assert planner.intent().spec == "dp12"
    d = planner.decide(inputs=Pair.inputs(rplan, ts=state["last_exec_ts"]
                                          + 10, waiting=4))
    assert d["reason"] == "cooldown"


# -- observe() from each package's own ledgers -----------------------------------


def _observe_script(plan, sm_mod, rdzv_mod, topo_mod):
    clock = [1000.0]
    sm = sm_mod.SpeedMonitor(clock=lambda: clock[0])
    mgr = rdzv_mod.ElasticTrainingRendezvousManager(clock=lambda: clock[0])
    mgr.update_rdzv_params(min_nodes=2, max_nodes=3, node_unit=1,
                           waiting_timeout=0.0)
    for nid in range(3):
        mgr.join_rendezvous(nid, nid, topo_mod.NodeTopologyMeta(
            node_id=nid, node_rank=nid))
    mgr.get_comm_world(0)
    p = plan.GoodputPlanner(speed_monitor=sm, rdzv_manager=mgr,
                            clock=lambda: clock[0], min_nodes=1,
                            max_nodes=8)
    sm.collect_global_step(1, 900.0)
    for nid in range(3):
        sm.collect_step_digest(nid, {"count": 10, "mean_s": 1.0,
                                     "p50_s": 1.0 + nid * 0.01,
                                     "p95_s": 1.1, "max_s": 1.2})
    sm.record_comm_links(0, {"ici": 1000, "dcn": 250})
    sm.mark_downtime_start(ts=950.0)
    sm.mark_downtime_end(ts=960.0)
    out = [p.observe().snapshot()]
    sm.mark_downtime_start()
    out.append(p.observe().snapshot())
    mgr.set_growth_gate(lambda seated: False)
    mgr.join_rendezvous(7, 7, topo_mod.NodeTopologyMeta(node_id=7,
                                                        node_rank=7))
    out.append(mgr.num_nodes_waiting())
    out.append(p.observe().snapshot())
    clock[0] += 30.0
    out.append(p.decide())
    return out


def test_observe_reads_measured_signals_equal_to_jax():
    from dlrover_tpu.master.monitor import speed_monitor as jsm
    from dlrover_tpu.master.rendezvous import manager as jrdzv
    from dlrover_tpu.master.rendezvous import net_topology as jtopo
    from dlrover_tpu_torch.master.monitor import speed_monitor as psm
    from dlrover_tpu_torch.master.rendezvous import manager as prdzv
    from dlrover_tpu_torch.master.rendezvous import net_topology as ptopo

    j = _observe_script(jplan, jsm, jrdzv, jtopo)
    p = _observe_script(pplan, psm, prdzv, ptopo)
    assert _dump(j) == _dump(p)
    first, open_, waiting, hidden, decision = p
    assert first["world"] == 3 and first["step_p50_s"] == pytest.approx(1.01)
    assert first["comm_links"] == {"ici": 1000, "dcn": 250}
    assert first["resize_cost_s"] == pytest.approx(10.0)
    assert not first["downtime_open"] and open_["downtime_open"]
    # the gate hides the joiner from the fleet, not from the planner
    assert waiting == 0 and hidden["waiting"] == 1
    assert decision["verdict"] == pplan.HOLD


def _slices_script(plan, rdzv_mod, topo_mod):
    mgr = rdzv_mod.ElasticTrainingRendezvousManager(clock=lambda: 0.0)
    mgr.update_rdzv_params(min_nodes=4, max_nodes=4, node_unit=1,
                           waiting_timeout=0.0)
    for nid in range(4):
        mgr.join_rendezvous(nid, nid, topo_mod.NodeTopologyMeta(
            node_id=nid, node_rank=nid, slice_name=f"slice-{nid // 2}"))
    mgr.get_comm_world(0)
    return plan.GoodputPlanner(rdzv_manager=mgr,
                               clock=lambda: 0.0).observe().snapshot()


def test_observe_derives_n_slices_from_seated_slice_names():
    from dlrover_tpu.master.rendezvous import manager as jrdzv
    from dlrover_tpu.master.rendezvous import net_topology as jtopo
    from dlrover_tpu_torch.master.rendezvous import manager as prdzv
    from dlrover_tpu_torch.master.rendezvous import net_topology as ptopo

    j = _slices_script(jplan, jrdzv, jtopo)
    p = _slices_script(pplan, prdzv, ptopo)
    assert j == p and p["world"] == 4 and p["n_slices"] == 2


def _hbm_script(plan, msg, consts, node_mod, jm_mod, servicer_mod, ctx):
    for i in range(2):
        ctx.update_node(node_mod.Node(consts.NodeType.WORKER, i,
                                      status=consts.NodeStatus.RUNNING))
    jm = jm_mod.LocalJobManager(job_context=ctx)
    servicer = servicer_mod.MasterServicer(job_manager=jm, job_context=ctx)
    for nid, used in ((0, 14_000.0), (1, 9_000.0)):
        servicer.report(msg.ResourceUsageReport(
            node_type=consts.NodeType.WORKER, node_id=nid, cpu_percent=0.5,
            memory_mb=1024.0, tpu_hbm_used_mb=used))
    p = plan.GoodputPlanner(job_context=ctx, clock=lambda: 0.0,
                            hbm_capacity_gb=16.0)
    inputs = p.observe()
    armed = inputs.snapshot()
    inputs.world, inputs.waiting, inputs.step_p50_s = 8, 4, 1.0
    worlds = sorted(wd.world_size for wd in p.candidates(inputs))
    blind = plan.GoodputPlanner(job_context=ctx,
                                clock=lambda: 0.0).observe().snapshot()
    return armed, worlds, blind


def test_observe_reads_reported_memory_through_job_context():
    """The workers' reported device memory lands on the node registry
    through each package's servicer; with a capacity configured the
    planner's feasibility gate reads it (8 -> 7 projects past the
    headroom), without one it stays off."""
    from dlrover_tpu.common import constants as jconst
    from dlrover_tpu.common import messages as jmsg
    from dlrover_tpu.common import node as jnode
    from dlrover_tpu.master import job_container as jcont
    from dlrover_tpu.master import servicer as jserv
    from dlrover_tpu.master.node import job_manager as jjm
    from dlrover_tpu_torch.common import constants as pconst
    from dlrover_tpu_torch.common import messages as pmsg
    from dlrover_tpu_torch.common import node as pnode
    from dlrover_tpu_torch.master.node import job_context as pctx
    from dlrover_tpu_torch.master import servicer as pserv
    from dlrover_tpu_torch.master.node import job_manager as pjm

    try:
        j = _hbm_script(jplan, jmsg, jconst, jnode, jjm, jserv,
                        jcont.JobContainer.fresh().job_context)
    finally:
        jcont.reset()
    p = _hbm_script(pplan, pmsg, pconst, pnode, pjm, pserv,
                    pctx.JobContext())
    assert _dump(j) == _dump(p)
    armed, worlds, blind = p
    assert armed["hbm_used_bytes"] == pytest.approx(14e9)
    assert armed["hbm_capacity_bytes"] == pytest.approx(16e9)
    assert 7 not in worlds and blind["hbm_used_bytes"] == 0.0


# -- the hint and the metrics on the port's wire ---------------------------------


def _executed_planner():
    p = pplan.GoodputPlanner(clock=lambda: 0.0, cooldown_s=100.0,
                             horizon_s=600.0, hysteresis=1,
                             decide_interval_s=10.0)
    d = p.decide(inputs=Pair.inputs(pplan, ts=0.0, waiting=4))
    assert d["verdict"] == pplan.RESIZE
    p.note_executed(p.intent(), now=0.0)
    return p


def test_speculation_hint_rides_the_membership_poll_and_client():
    """The hint rides the port servicer's ``NumNodesWaitingResponse``
    through the port's serde, reaches ``MasterClient.rendezvous_status``
    and ``speculation_hint`` in one RPC each, and an old master's reply
    without the field reads as no hint."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.serde import deserialize, serialize
    from dlrover_tpu_torch.master.servicer import MasterServicer

    servicer = MasterServicer(planner=_executed_planner())
    want = {"spec": "dp12", "world": 12, "n_slices": 1}
    back = deserialize(serialize(servicer.get(msg.NumNodesWaitingRequest())))
    assert back.speculation_hint == want

    class Loop:
        calls = 0

        def get(self, m, **kw):
            Loop.calls += 1
            return deserialize(serialize(servicer.get(m)))

    client = MasterClient("127.0.0.1:1", 0)
    client._client = Loop()
    assert client.rendezvous_status() == (0, 0, want)
    assert client.speculation_hint() == want
    assert Loop.calls == 2
    wire = json.loads(serialize(msg.NumNodesWaitingResponse(
        waiting_num=3, latest_round=7, speculation_hint=want)).decode())
    wire["some_future_field"] = {"x": 1}
    back = deserialize(json.dumps(wire).encode())
    assert back.waiting_num == 3 and not hasattr(back, "some_future_field")
    del wire["speculation_hint"], wire["some_future_field"]
    back = deserialize(json.dumps(wire).encode())
    assert dict(getattr(back, "speculation_hint", None) or {}) == {}


@pytest.mark.parametrize("num_processes,node_num,want", [
    (2, 1, 24), (4, 2, 24), (1, 1, 12), (8, 2, 48)])
def test_worker_context_hint_scales_by_processes_per_node(
        num_processes, node_num, want):
    """The master's node-level hint times the processes a node runs (the
    agent's environment: the world's processes over its nodes) arms the
    trainer; an empty hint arms nothing."""
    from dlrover_tpu_torch.train.bootstrap import WorkerContext, WorkerEnv

    class Trainer:
        hint = None

        def set_speculation_hint(self, world, n_slices=None):
            self.hint = (world, n_slices)

    class Client:
        def __init__(self, hint):
            self._hint = hint

        def speculation_hint(self):
            return self._hint

    env = WorkerEnv(num_processes=num_processes, node_num=node_num)
    tr = Trainer()
    ctx = WorkerContext(env, Client({"spec": "dp12", "world": 12,
                                     "n_slices": 1}))
    assert ctx.poll_speculation_hint(tr) is not None
    assert tr.hint == (want, 1)
    tr2 = Trainer()
    assert WorkerContext(env, Client({})).poll_speculation_hint(tr2) is None
    assert tr2.hint is None


def test_master_metrics_endpoint_serves_planner_lines(monkeypatch):
    """The port's ``/metrics`` carries the planner's provider, the same
    lines as the JAX planner's after the same decision."""
    from dlrover_tpu_torch.common import flags
    from dlrover_tpu_torch.master import metrics as mm

    monkeypatch.setenv(flags.MASTER_METRICS_PORT.name, "0")
    pair = Pair()
    pair.decide(ts=0.0, waiting=4)
    lines = pair.both(lambda p, m, w: p.prometheus_lines())
    server = mm.maybe_start(None, None, planner=pair.port)
    assert server is not None
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=5
        ).read().decode()
    finally:
        server.stop()
    assert 'dlrover_tpu_scale_decisions_total{verdict="hold"} 1' in body
    for line in lines:
        assert line in body


# -- the wall-clock pin ----------------------------------------------------------


def test_no_wall_clock_reads_in_decision_path():
    """The port's planner and auto-scaler decision path is clock-injected:
    no ``time.time()``/``monotonic()``/``perf_counter()`` call in these
    modules (``time.time`` as the injected clock's default is fine)."""
    files = [
        "dlrover_tpu_torch/brain/planner.py",
        "dlrover_tpu_torch/master/node/job_auto_scaler.py",
        "dlrover_tpu_torch/master/resource/optimizer.py",
        "dlrover_tpu_torch/master/scaler/base.py",
        "dlrover_tpu_torch/master/hyperparams.py",
    ]
    offenders = []
    for rel in files:
        with open(os.path.join(REPO_ROOT, rel)) as f:
            tree = ast.parse(f.read(), filename=rel)
        for node in ast.walk(tree):
            fn = getattr(node, "func", None)
            if (isinstance(node, ast.Call) and isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "time"
                    and fn.attr in ("time", "monotonic", "perf_counter")):
                offenders.append(f"{rel}:{node.lineno} time.{fn.attr}()")
    assert not offenders, offenders
