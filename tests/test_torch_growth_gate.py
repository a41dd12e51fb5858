"""The rendezvous growth gate (master/rendezvous/manager.py with
brain/planner.py) held to the JAX package's on the CPU, and a
planner-directed scale-out end to end.

(a) One join / liveness / gate script through the JAX rendezvous manager
    and the port's, on one virtual clock: after every event the waiting
    count the fleet is told, the round completions, the seated world and
    the published snapshot's alive and waiting ids are equal. Growth of a
    healthy seated world waits for the gate; a dead seated member, a
    member re-joining and the hang watchdog's virtual waiter never do.
    Where the port differs: once the planner's plan is executed, a grown
    round waits for every seated member to re-join, at the local master's
    default last-call window too.
(b) The port's auto-scaler bills an executed plan's re-form: the grown
    round's completion opens a bracket at the fleet's last progress stamp,
    which the next step report closes.
(c) The CLI: an in-process port master with the planner armed (a 1 s
    decide interval, hysteresis 2, a 1 s last-call window), two
    ``elastic_run --accelerator cpu
    --master_addr`` agents of one process each on gloo, a 2-layer,
    width-64 Llama (``LlamaConfig.tiny()``) with a memory save every step.
    The second agent starts after the first's 2nd step: the first keeps
    stepping while its joiner waits, the planner executes one RESIZE to 2
    nodes, the first node's workers take ``SCALE_OUT_STOP_S`` to stop, the
    round re-forms at 2 nodes and both ranks resume from the
    breakpoint-persisted step. Bounded by ``SCALE_OUT_TIMEOUT_S``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import uuid

import pytest

from dlrover_tpu.master.rendezvous import manager as jrdzv
from dlrover_tpu.master.rendezvous import net_topology as jtopo
from dlrover_tpu_torch.master.rendezvous import manager as prdzv
from dlrover_tpu_torch.master.rendezvous import net_topology as ptopo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Rig:
    """One package's training rendezvous manager on a settable clock with
    a settable gate."""

    def __init__(self, rdzv, topo, clock, allowed, min_nodes=2,
                 max_nodes=4, timeout=1.0):
        self.topo = topo
        self.mgr = rdzv.ElasticTrainingRendezvousManager(
            clock=lambda: clock[0])
        self.mgr.update_rdzv_params(min_nodes=min_nodes, max_nodes=max_nodes,
                                    node_unit=1, waiting_timeout=timeout)
        self.allowed = allowed

    def join(self, nid):
        return self.mgr.join_rendezvous(nid, nid, self.topo.NodeTopologyMeta(
            node_id=nid, node_rank=nid))

    def view(self):
        s = self.mgr.world_snapshot()
        return {"told_waiting": self.mgr.num_nodes_waiting(),
                "round": self.mgr.get_rdzv_round(),
                "world": list(s.latest_world),
                "alive": sorted(s.alive_ids),
                "waiting": sorted(s.waiting_ids),
                "force_reform": s.force_reform}


def _script(events, min_nodes=2, max_nodes=4):
    """Run ``events`` through both packages; every view equal. Returns
    the port's views."""
    clock = [100.0]
    allowed = [False]
    rigs = [Rig(jrdzv, jtopo, clock, allowed, min_nodes, max_nodes),
            Rig(prdzv, ptopo, clock, allowed, min_nodes, max_nodes)]
    views = []
    for ev, *args in events:
        outs = []
        for rig in rigs:
            if ev == "join":
                out = rig.join(args[0])
            elif ev == "poll":
                rnd, _, world, _ = rig.mgr.get_comm_world(args[0])
                out = [rnd, sorted(m.node_id for m in world.values())]
            elif ev == "gate":
                rig.mgr.set_growth_gate(lambda seated: allowed[0])
                out = None
            elif ev == "allow":
                allowed[0] = args[0]
                out = None
            elif ev == "tick":
                clock[0] += args[0]
                out = None
            elif ev == "dead":
                out = rig.mgr.remove_alive_node(args[0])
            elif ev == "alive":
                out = rig.mgr.add_alive_node(args[0])
            elif ev == "reform":
                out = rig.mgr.request_re_rendezvous(exclude=args[0])
            elif ev == "complete":
                with rig.mgr._lock:
                    out = rig.mgr._check_rdzv_completed()
            else:
                raise ValueError(ev)
            outs.append([out, rig.view()])
        assert outs[0] == outs[1], (ev, args, outs)
        views.append(outs[1])
    return views


def _seat(n):
    return [("join", i) for i in range(n)] + [("tick", 2.0), ("poll", 0)]


GATE_SCRIPTS = {
    # the JAX package's test_rendezvous_gate_suppresses_only_pure_growth
    "pure_growth_waits_recovery_does_not": _seat(4) + [
        ("gate",), ("join", 4), ("tick", 10.0), ("complete",),
        ("allow", True), ("allow", False), ("dead", 2), ("alive", 2),
        ("join", 2)],
    # a gated joiner polls: no round forms until the gate opens, then the
    # seated world re-joins and the grown round forms
    "gated_joiner_forms_no_round_until_allowed": _seat(2) + [
        ("gate",), ("join", 2), ("tick", 5.0), ("poll", 2), ("poll", 2),
        ("allow", True), ("join", 0), ("join", 1), ("tick", 2.0),
        ("poll", 0), ("poll", 2)],
    # the watchdog's virtual waiter and a newcomer during its re-form are
    # never gated
    "hang_reform_is_never_gated": _seat(2) + [
        ("gate",), ("reform", [1]), ("join", 0), ("join", 2),
        ("tick", 2.0), ("poll", 0)],
    # a seated member that died is recovery: its replacement seats at once
    "replacement_of_a_dead_member_is_never_gated": _seat(2) + [
        ("gate",), ("dead", 1), ("join", 3), ("join", 0), ("tick", 2.0),
        ("poll", 3)],
    # without a gate, growth is advertised at once (today's behaviour)
    "no_gate_advertises_growth": _seat(2) + [
        ("join", 2), ("tick", 2.0), ("poll", 2)],
    # the first round is never gated (nothing seated yet)
    "first_round_is_not_gated": [
        ("gate",), ("join", 0), ("join", 1), ("tick", 2.0), ("poll", 0)],
    # the gate opens for the seated size it was asked about
    "gate_reads_the_seated_world_size": _seat(3) + [
        ("gate",), ("join", 5), ("allow", True), ("tick", 2.0),
        ("poll", 5)],
}


@pytest.mark.parametrize("name", sorted(GATE_SCRIPTS))
def test_growth_gate_matches_jax(name):
    views = _script(GATE_SCRIPTS[name])
    last = views[-1][1]
    if name == "pure_growth_waits_recovery_does_not":
        told = [v[1]["told_waiting"] for v in views]
        # seated 4; the joiner hidden and it cannot complete a round;
        # allowed: visible; shut again: hidden; a seated member dies:
        # visible though the gate is shut; alive again: hidden; the
        # member re-joining: both visible
        assert told[6:] == [0, 0, 0, 0, 1, 0, 1, 0, 2]
        assert views[9][0] is False
    elif name == "gated_joiner_forms_no_round_until_allowed":
        assert [v[0] for v in views[7:9]] == [[1, []], [1, []]]
        assert views[8][1]["told_waiting"] == 0
        assert views[-2][0] == [2, [0, 1, 2]] and last["world"] == [0, 1, 2]
        assert views[-1][0] == [2, [0, 1, 2]]
    elif name == "hang_reform_is_never_gated":
        assert views[5][1]["told_waiting"] == 1  # the virtual waiter
        assert views[-1][0] == [2, [0, 2]] and not last["force_reform"]
    elif name == "replacement_of_a_dead_member_is_never_gated":
        assert views[6][1]["told_waiting"] == 1
        assert views[-1][0] == [2, [0, 3]]
    elif name == "no_gate_advertises_growth":
        assert views[4][1]["told_waiting"] == 1
        assert views[-1][0] == [1, []]  # one joiner is under min_nodes
    elif name == "first_round_is_not_gated":
        assert views[-1][0] == [1, [0, 1]]
    elif name == "gate_reads_the_seated_world_size":
        assert views[6][1]["told_waiting"] == 0
        assert views[7][1]["told_waiting"] == 1


def _default_window():
    """The local master's last-call window (its constructor's default)."""
    import inspect

    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    return inspect.signature(LocalJobMaster).parameters[
        "rdzv_waiting_timeout"].default


# each: the seated world, the joiners, the seated members that re-join
# after the gate opened (before the last poll), and the last poll's
# world in the JAX package and in the port
EXECUTED_GROWTH = {
    # the joiner waited behind the gate past the window: the JAX manager
    # seats it alone once the gate opens, the port waits for node 0
    "one_seated_node": ([0], [1], [], [1], None),
    # one of two seated nodes re-joined and node 1 took longer than the
    # window: the JAX manager seats node 0 with the joiner and leaves
    # node 1 behind, the port waits for node 1
    "two_seated_nodes_one_rejoined": ([0, 1], [2], [0], [0, 2], None),
    # every seated member re-joined: both seat the grown world
    "every_seated_node_rejoined": ([0, 1], [2], [0, 1], [0, 1, 2],
                                   [0, 1, 2]),
}


@pytest.mark.parametrize("name", sorted(EXECUTED_GROWTH))
def test_executed_growth_waits_for_the_seated_world(name):
    """At the local master's default last-call window, with the planner's
    plan executed (the gate open): the port completes the grown round
    only once every seated member re-joined, where the JAX manager lets
    the joiners complete one as soon as the window has passed since
    their join (ROADMAP's known differences). Both tell the seated world
    the joiners wait, so the seated members re-join."""
    seated, joiners, rejoin, jax_world, port_world = EXECUTED_GROWTH[name]
    window = _default_window()
    assert window == 60
    clock = [100.0]
    allowed = [False]
    n = len(seated) + len(joiners)
    out = {}
    for pkg, rdzv, topo in (("jax", jrdzv, jtopo), ("port", prdzv, ptopo)):
        rig = Rig(rdzv, topo, clock, allowed, min_nodes=1, max_nodes=n,
                  timeout=window)
        clock[0] = 100.0
        allowed[0] = False
        for nid in seated:
            rig.join(nid)
        clock[0] += window + 1
        assert rig.mgr.get_comm_world(seated[0])[0] == 1
        rig.mgr.set_growth_gate(lambda size: allowed[0])
        for nid in joiners:
            rig.join(nid)
        clock[0] += window + 1
        assert rig.mgr.get_comm_world(joiners[0])[2] == {}
        assert rig.mgr.num_nodes_waiting() == 0
        allowed[0] = True  # the planner executed its plan
        assert rig.mgr.num_nodes_waiting() == len(joiners)
        for nid in rejoin:
            rig.join(nid)
        clock[0] += window + 1  # a seated member persists for longer
        _, _, world, _ = rig.mgr.get_comm_world(joiners[0])
        out[pkg] = sorted(m.node_id for m in world.values())
        if out[pkg] != port_world and pkg == "port":
            # the port held the round: the rest of the seated world
            # re-joins and the grown round forms at once
            for nid in seated:
                if nid not in rejoin:
                    rig.join(nid)
            _, _, world, _ = rig.mgr.get_comm_world(joiners[0])
            assert sorted(m.node_id for m in world.values()) == sorted(
                seated + joiners)
    assert out == {"jax": jax_world, "port": port_world or []}


# -- (b) the auto-scaler bills an executed plan's re-form ------------------------


def test_the_auto_scaler_bills_an_executed_plans_reform():
    """An executed RESIZE opens no bracket (the seated node keeps
    stepping); the grown round's completion does, backdated to the last
    step the old world reported, and the new world's first step report
    closes it. A re-form with no executed plan is not billed."""
    from dlrover_tpu_torch.brain.planner import GoodputPlanner
    from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
    from dlrover_tpu_torch.common.global_context import MasterConfigContext
    from dlrover_tpu_torch.common.node import Node
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
    from dlrover_tpu_torch.master.node.job_auto_scaler import JobAutoScaler
    from dlrover_tpu_torch.master.node.job_context import JobContext
    from dlrover_tpu_torch.master.resource.optimizer import LocalOptimizer
    from dlrover_tpu_torch.master.scaler.base import LocalScaler

    clock = [1000.0]
    now = lambda: clock[0]  # noqa: E731
    sm = SpeedMonitor(clock=now)
    mgr = prdzv.ElasticTrainingRendezvousManager(clock=now)
    mgr.update_rdzv_params(min_nodes=1, max_nodes=2, node_unit=1,
                           waiting_timeout=_default_window())
    ctx = JobContext()
    ctx.update_node(Node(NodeType.WORKER, 0, status=NodeStatus.RUNNING))
    planner = GoodputPlanner(
        speed_monitor=sm, rdzv_manager=mgr, clock=now, min_nodes=1,
        max_nodes=2, cooldown_s=100.0, horizon_s=600.0, hysteresis=1,
        decide_interval_s=1.0)
    mgr.set_growth_gate(planner.growth_allowed)
    config = MasterConfigContext()
    config.update({"seconds_to_autoscale_worker": 0.0})
    auto = JobAutoScaler(
        LocalOptimizer(min_workers=1, max_workers=2),
        LocalScaler(job_context=ctx), speed_monitor=sm, planner=planner,
        clock=now, job_context=ctx, config=config, rdzv_manager=mgr)

    def join(nid):
        mgr.join_rendezvous(nid, nid, ptopo.NodeTopologyMeta(
            node_id=nid, node_rank=nid))

    def step(n, ts):
        sm.collect_global_step(n, ts)
        sm.collect_step_digest(0, {"count": 10, "mean_s": 1.0, "p50_s": 1.0,
                                   "p95_s": 1.05, "max_s": 1.1})
        sm.mark_downtime_end(ts=ts)

    def sweep(dt=2.0):
        clock[0] += dt
        return auto.sweep()

    join(0)
    clock[0] += 61.0
    mgr.get_comm_world(0)
    step(10, clock[0])
    # a re-join with no executed plan: the round re-forms unbilled
    join(0)
    clock[0] += 61.0
    mgr.get_comm_world(0)
    assert mgr.get_rdzv_round() == 2
    sweep()
    assert not sm.downtime_in_progress()
    step(11, clock[0])
    join(1)
    plan = None
    for _ in range(5):
        plan = sweep()
        if planner.export_state()["executed"]:
            break
    assert [e["target_world"] for e in planner.export_state()["executed"]] \
        == [2], planner.export_state()["ledger"]
    assert plan.node_group_resources[NodeType.WORKER].count == 2
    assert not sm.downtime_in_progress()
    last = clock[0] + 1.0
    step(12, last)  # the seated node steps on until it sees the waiter
    sweep()
    assert not sm.downtime_in_progress()
    assert mgr.num_nodes_waiting() == 1
    clock[0] += 30.0  # the breakpoint persist
    join(0)
    mgr.get_comm_world(1)
    assert mgr.get_rdzv_round() == 3
    sweep()
    assert sm.downtime_in_progress()
    step(13, clock[0] + 20.0)  # the grown world's first step
    assert not sm.downtime_in_progress()
    assert sm.total_downtime() == pytest.approx(clock[0] + 20.0 - last)
    assert sm.avg_downtime() == pytest.approx(clock[0] + 20.0 - last)
    sweep()
    assert not sm.downtime_in_progress()


# -- (c) the CLI: a planner-directed scale-out -----------------------------------

SCALE_OUT_TIMEOUT_S = 90
#: steps each rank trains after the re-formed round's restore
SCALE_OUT_AFTER = 3

#: seconds node 0's first-life workers take to stop once their agent sees
#: the waiter (the breakpoint persist takes tens of seconds on the card):
#: the joiner, long past the 1 s last-call window, polls meanwhile
SCALE_OUT_STOP_S = 3.0

SCALE_WORKER = """\
import json, os, signal, sys, time
from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
from dlrover_tpu_torch.run import llama_pretrain
from dlrover_tpu_torch.train import bootstrap

def emit(kind, **kw):
    print("SCALE_JSON " + json.dumps({"kind": kind, **kw}), flush=True)

ckpt_dir, after, grown = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
stop_s = float(sys.argv[4])
ctx = bootstrap.init()
ctx.step_report_interval = 0.0
args = llama_pretrain.parse_args([
    "--model", "tiny", "--layers", "2", "--seq", "32", "--micro-batch", "1",
    "--global-batch", "4", "--steps", "1", "--device", "cpu", "--seed", "0"])
cfg, trainer, state, next_batch, _ = llama_pretrain.build(args, "cpu", ctx)
trainer.poll_every_steps = 1
ckpt = Checkpointer(ckpt_dir, save_storage_interval=0)
restored = ckpt.load(target=state)
start = restored[0] if restored is not None else 0
for _ in range(start):
    next_batch()
world = bootstrap.process_count()
emit("life", world=world, rank=bootstrap.process_index(), start=start,
     tier=ckpt.last_restore_stats.get("tier") if restored else None)
# the grown world trains ``after`` steps; the first trains until stopped,
# and takes ``stop_s`` to stop
end = start + after if world >= grown else 10 ** 9
if world < grown:
    signal.signal(signal.SIGTERM,
                  lambda *_: (time.sleep(stop_s), os._exit(0)))
deadline = time.time() + 60
step = start
while step < end and time.time() < deadline:
    state, loss = trainer.step(state, next_batch())
    step += 1
    ckpt.save(step, state)
    ctx.report_step(step, force=True, digest=trainer.step_digest)
    hint = trainer.speculation_hint
    emit("step", step=step, loss=loss.item(), world=world, t=time.time(),
         hint=hint.spec if hint is not None else "")
    time.sleep(0.2)
ckpt.close()
emit("end", step=step)
"""


def _lives(job, node, process_id):
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    path = os.path.join(agent_log_dir(job, node),
                        f"worker-{process_id}-restart0.log")
    lives = []
    if not os.path.exists(path):
        return lives, ""
    with open(path, errors="replace") as f:
        text = f.read()
    for line in text.splitlines():
        if not line.startswith("SCALE_JSON "):
            continue
        rec = json.loads(line.split(" ", 1)[1])
        if rec["kind"] == "life":
            lives.append({"life": rec, "steps": [], "end": None})
        elif lives:
            if rec["kind"] == "step":
                lives[-1]["steps"].append(rec)
            else:
                lives[-1]["end"] = rec
    return lives, text


@pytest.mark.parametrize("nproc", [1, 2], ids=["dp1_to_dp2", "dp2_to_dp4"])
def test_cli_planner_directed_scale_out(nproc, tmp_path, monkeypatch):
    """Two agents of ``nproc`` gloo processes each: the first node trains
    at dp ``nproc`` until the planner's executed RESIZE, then both nodes'
    ranks restore the persisted step and train on at dp ``2 nproc`` (the
    ``dp2_to_dp4`` case restores halves staged at dp2 into quarters, the
    four-card leg's shape)."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.agent.paral_config_tuner import (
        default_config_path,
    )
    from dlrover_tpu_torch.brain.planner import RESIZE
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    t0 = time.time()
    job = f"torch-scale-{uuid.uuid4().hex[:8]}"
    script = tmp_path / "scale_worker.py"
    script.write_text(SCALE_WORKER)
    ckpt_dir = str(tmp_path / "ck")
    for k in list(os.environ):
        if k.startswith("DLROVER_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    # a 1 s last-call window: the first round seats node 0 alone after
    # 1 s, and the joiner, which waits far longer behind the gate, still
    # forms no round without node 0 once the plan is executed
    master = LocalJobMaster(
        port=0, node_num=2, min_node_num=1, rdzv_waiting_timeout=1.0,
        planner=True, planner_kwargs=dict(decide_interval_s=1.0,
                                          hysteresis=2))
    master.container.config.update({"seconds_to_autoscale_worker": 0.0})
    training = master.rdzv_managers["training"]
    master.prepare()
    exit_code = []
    runner = threading.Thread(
        target=lambda: exit_code.append(master.run(poll_interval=0.25)),
        daemon=True)
    runner.start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")

    def agent(node):
        return subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
             f"--master_addr=127.0.0.1:{master.port}", "--nnodes=1:2",
             f"--nproc_per_node={nproc}", f"--node_id={node}",
             "--accelerator", "cpu", f"--job_name={job}",
             "--max_restarts=0", "--monitor_interval", "0.5", str(script),
             "--", ckpt_dir, str(SCALE_OUT_AFTER), str(2 * nproc),
             str(SCALE_OUT_STOP_S)],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    agents = []
    try:
        agents.append(agent(0))
        deadline = t0 + SCALE_OUT_TIMEOUT_S - 20
        while training.get_rdzv_round() < 1:
            assert time.time() < deadline, "node 0 never seated"
            time.sleep(0.05)
        while True:
            lives, text = _lives(job, 0, 0)
            if lives and len(lives[0]["steps"]) >= 2:
                break
            assert time.time() < deadline, text[-2000:]
            time.sleep(0.05)
        join_t = time.time()
        agents.append(agent(1))
        outs = [a.communicate(timeout=max(
            1.0, t0 + SCALE_OUT_TIMEOUT_S - 5 - time.time()))[0]
            for a in agents]
        runner.join(timeout=30)
        # node 0's processes lived twice (ids 0..nproc-1 in both rounds),
        # node 1's once (ids nproc..2 nproc-1)
        logs = {pid: _lives(job, pid // nproc, pid)
                for pid in range(2 * nproc)}
        detail = (outs[0][-2500:], outs[1][-2500:],
                  {pid: t[-1200:] for pid, (_, t) in logs.items()})
        assert [a.returncode for a in agents] == [0, 0], detail
        assert exit_code == [0], detail
        state = master.planner.export_state()
        verdicts = [d["verdict"] for d in state["ledger"]]
        # HOLDs up to the streak, then one RESIZE to 2 nodes, executed once
        assert verdicts.count(RESIZE) == 1, state["ledger"]
        resize = state["ledger"][verdicts.index(RESIZE)]
        assert resize["target"] == "dp2" and resize["target_world"] == 2
        assert resize["current_world"] == 1
        before = state["ledger"][:verdicts.index(RESIZE)]
        assert before and before[-1]["reason"] == "hysteresis:1/2"
        assert [e["target_world"] for e in state["executed"]] == [2]
        exec_ts = state["executed"][0]["ts"]
        firsts, seconds = [], []
        for pid, (lives, _) in logs.items():
            assert len(lives) == (2 if pid < nproc else 1), detail
            if pid < nproc:
                firsts.append(lives[0])
            seconds.append(lives[-1])
        for first in firsts:
            # node 0 kept stepping while its joiner waited: at least two
            # step reports after the join, all at its own world, and the
            # round did not re-form before the executed plan
            assert first["life"]["world"] == nproc
            assert first["life"]["start"] == 0
            assert len([x for x in first["steps"] if x["t"] > join_t]) >= 2
            assert all(x["world"] == nproc for x in first["steps"])
            # the executed plan's hint (2 nodes x nproc): a step polls it
            # first, so every first-life step that began after the
            # execution armed it (the agent may stop the worker before
            # its next poll: on the CPU the breakpoint persist takes
            # milliseconds)
            steps = first["steps"]
            began_after = [cur for prev, cur in zip(steps, steps[1:])
                           if prev["t"] > exec_ts]
            assert all(x["hint"] == f"dp{2 * nproc}" for x in began_after)
            assert all(x["hint"] == "" for x in steps if x["t"] < exec_ts)
        # the re-formed round: 2 nproc ranks, each resuming the persisted
        # step from the disk tiers
        assert all(x["steps"][0]["t"] > exec_ts for x in seconds)
        assert {x["life"]["world"] for x in seconds} == {2 * nproc}
        assert sorted(x["life"]["rank"] for x in seconds) == list(
            range(2 * nproc))
        starts = {x["life"]["start"] for x in seconds}
        assert len(starts) == 1, detail
        start = starts.pop()
        assert 2 <= start <= min(f["steps"][-1]["step"] for f in firsts)
        assert all(x["life"]["tier"] in ("disk", "object") for x in seconds)
        for x in seconds:
            assert [s["step"] for s in x["steps"]] == list(
                range(start + 1, start + 1 + SCALE_OUT_AFTER))
            assert x["end"]["step"] == start + SCALE_OUT_AFTER
        # one global batch and one global mean: every rank's losses are
        # equal, and the step the first life also trained agrees with it
        # up to the dp reduce's order
        losses = [[s["loss"] for s in x["steps"]] for x in seconds]
        assert all(x == losses[0] for x in losses)
        seen = {s["step"]: s["loss"] for s in firsts[0]["steps"]}
        if start + 1 in seen:
            assert losses[0][0] == pytest.approx(seen[start + 1], rel=1e-4)
        # the ledger billed the re-form, and the planner reads its cost
        assert master.speed_monitor.avg_downtime() > 0
        assert time.time() - t0 < SCALE_OUT_TIMEOUT_S
    finally:
        for a in agents:
            if a.poll() is None:
                a.kill()
                a.wait()
        master.stop()
        for node in (0, 1):
            shutil.rmtree(os.path.dirname(agent_log_dir(job, node)),
                          ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_config_path(job, 0))), ignore_errors=True)


def test_a_grown_rank_resumes_the_loader_from_process_0s_sidecar(
        tmp_path, monkeypatch):
    """A rank the world grew by has no sidecar of its own: it takes process
    0's position (every process draws the identical global batch), so the
    grown world agrees on the loader and trains every record once."""
    import numpy as np

    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap
    from dlrover_tpu_torch.train.datasets import pack_tokens

    corpus = tmp_path / "c.bin"
    tokens = np.random.RandomState(0).randint(0, 256, (16, 32))
    pack_tokens(str(corpus), tokens.reshape(-1).tolist(), dtype="uint32")
    ckpt_dir = tmp_path / "ck"
    args = llama_pretrain.parse_args([
        "--device", "cpu", "--model", "tiny", "--seq", "32",
        "--micro-batch", "1", "--global-batch", "4", "--data", str(corpus),
        "--data-dtype", "uint32", "--ckpt-dir", str(ckpt_dir)])
    cfg, trainer, *_ = llama_pretrain.build(args)
    llama_pretrain.write_sidecar(llama_pretrain.sidecar_path(
        str(ckpt_dir), 0), 2, {"epoch": 0, "completed_samples": 8})

    def first_batch(rank):
        monkeypatch.setattr(bootstrap, "process_index", lambda: rank)
        batches, _, restored = llama_pretrain.open_data(
            args, cfg, trainer, 32, "cpu", restored_step=2,
            log=lambda m: None)
        return restored, next(batches).numpy()

    own, grown = first_batch(0), first_batch(3)
    assert own[0] == grown[0] == 2
    np.testing.assert_array_equal(own[1], grown[1])
    order = np.arange(16)
    np.random.RandomState(1).shuffle(order)
    np.testing.assert_array_equal(own[1].reshape(4, 32),
                                  tokens[order[8:12]])


def test_a_sidecar_ahead_of_the_restore_rewinds_in_its_epoch(tmp_path):
    """A sidecar written after steps the restore does not have (the worker
    stepped on while the agent persisted the breakpoint) rewinds by one
    global batch a step when that stays in its epoch; otherwise, or with
    no global batch given, it is dropped as before."""
    from dlrover_tpu_torch.run import llama_pretrain

    path = llama_pretrain.sidecar_path(str(tmp_path), 0)
    llama_pretrain.write_sidecar(path, 5, {"epoch": 1,
                                           "completed_samples": 40})
    assert llama_pretrain.read_sidecar(path, 5, 8)["step"] == 5
    assert llama_pretrain.read_sidecar(path, 3, 8) == {
        "step": 3, "loader": {"epoch": 1, "completed_samples": 24}}
    assert llama_pretrain.read_sidecar(path, 0, 8) == {
        "step": 0, "loader": {"epoch": 1, "completed_samples": 0}}
    # the epoch's start is behind the rewind: no position
    llama_pretrain.write_sidecar(path, 5, {"epoch": 1,
                                           "completed_samples": 8})
    assert llama_pretrain.read_sidecar(path, 3, 8) is None
    assert llama_pretrain.read_sidecar(path, 3) is None
