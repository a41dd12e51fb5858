"""The port's collective-hang watchdog and rendezvous re-form signal, held
to the JAX package's on the CPU, and the hang end to end under the CLI.

(a) The JAX package's five watchdog cases (``tests/test_shard_lease.py``:
    the round guard after a relaunch, the seated fleet-wide declaration,
    membership changes and stragglers ignored, the silent members excluded
    and billed, the re-fire), each driven on one clock through both
    packages' watchdog, speed monitor and rendezvous manager: the returned
    events, the excluded members, ``num_nodes_waiting`` and the
    attribution are equal.
(b) The re-form signal: a virtual waiter until the seated cohort re-joins,
    cleared by the next completed round, and ``latest_world_ids``, equal in
    both packages.
(c) ``elastic_run --standalone`` of a CPU worker that SIGSTOPs itself
    after its 3rd step report, under a 16 s window: the master
    declares one hang and bills ``collective_hang``, the agent stops the
    wedged worker and starts it again, and the second life finishes.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import uuid

import pytest

from dlrover_tpu.common.node import Node as JaxNode
from dlrover_tpu.master.monitor import hang_watchdog as jhang
from dlrover_tpu.master.monitor import speed_monitor as jspeed
from dlrover_tpu.master.node.job_context import JobContext as JaxJobContext
from dlrover_tpu.master.rendezvous import manager as jmanager
from dlrover_tpu.master.rendezvous import net_topology as jtopo
from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.ipc import default_socket_path
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.monitor import hang_watchdog as phang
from dlrover_tpu_torch.master.monitor import speed_monitor as pspeed
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.rendezvous import manager as pmanager
from dlrover_tpu_torch.master.rendezvous import net_topology as ptopo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": (jhang, jspeed, jmanager, jtopo, JaxJobContext, JaxNode),
    "port": (phang, pspeed, pmanager, ptopo, JobContext, Node),
}


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Tasks:
    """Records the watchdog's lease releases."""

    def __init__(self):
        self.removed = []

    def remove_node_tasks(self, node_id):
        self.removed.append(node_id)


class Rig:
    """One package's watchdog on a seated, freshly formed round of ``n``
    workers (the JAX tests' ``_hang_rig``), recording every
    ``request_re_rendezvous`` exclusion."""

    def __init__(self, pkg, n=4, window=30.0):
        hang, speed, manager, topo, ctx_cls, node_cls = PKGS[pkg]
        self.clock = clock = Clock()
        self.node_cls = node_cls
        self.sm = speed.SpeedMonitor(clock=clock)
        self.rdzv = manager.ElasticTrainingRendezvousManager(clock=clock)
        self.rdzv.update_rdzv_params(min_nodes=n - 2, max_nodes=n,
                                     waiting_timeout=5.0, node_unit=1)
        self.tasks = Tasks()
        self.ctx = ctx_cls()
        self.wd = hang.HangWatchdog(
            speed_monitor=self.sm, rdzv_manager=self.rdzv,
            task_manager=self.tasks, window_s=window, clock=clock)
        self.excluded = []
        real = self.rdzv.request_re_rendezvous

        def request(exclude=()):
            self.excluded.append(sorted(exclude))
            real(exclude=exclude)

        self.rdzv.request_re_rendezvous = request
        self.topo = topo
        for nid in range(n):
            self.join(nid)
            self.sm.add_running_worker("worker", nid)
        with self.rdzv._lock:
            self.rdzv._check_rdzv_completed()
        assert self.wd.sweep() is None  # latches the fresh round

    def join(self, nid):
        self.rdzv.join_rendezvous(nid, nid, self.topo.NodeTopologyMeta(
            node_id=nid, node_rank=nid, process_num=1,
            node_ip=f"10.0.0.{nid}", node_port=1))

    def look(self, event=None):
        return {"event": event, "waiting": self.rdzv.num_nodes_waiting(),
                "world": self.rdzv.latest_world_ids(),
                "round": self.rdzv.get_rdzv_round(),
                "excluded": list(self.excluded),
                "released": list(self.tasks.removed),
                "attribution": self.sm.attribution(),
                "downtime_open": self.sm.downtime_in_progress(),
                "events": list(self.wd.hang_events)}


def case_round_guard_after_relaunch(r):
    out = []
    # the restored ledger's progress stamp predates the relaunch
    r.sm.collect_global_step(10, r.clock.t - 500.0)
    r.clock.t += 5
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 20
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 10  # 35 s since the round formed, no progress since
    out.append(r.look(r.wd.sweep()))
    return out


def case_seated_fleetwide_stall(r):
    out = []
    r.sm.collect_global_step(10, r.clock.t)
    r.clock.t += 10
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 25
    out.append(r.look(r.wd.sweep()))
    out.append(r.look(r.wd.sweep()))  # one declaration per episode
    return out


def case_membership_changes_and_stragglers(r):
    out = []
    r.sm.collect_global_step(10, r.clock.t)
    r.clock.t += 40
    r.sm.collect_step_digest(1, {"count": 3, "mean_s": 2.0, "p50_s": 2.0},
                             ts=r.clock.t)
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 40
    r.sm.remove_running_worker("worker", 3)
    out.append(r.look(r.wd.sweep()))
    return out


def case_silent_members(r):
    t0 = r.clock.t
    r.wd._job_context = r.ctx
    for nid in range(4):
        node = r.node_cls(NodeType.WORKER, nid)
        node.update_heartbeat(t0)
        r.ctx.update_node(node)
    r.sm.collect_global_step(10, t0)
    r.clock.t += 35
    for nid in (0, 1):
        r.ctx.get_node(NodeType.WORKER, nid).update_heartbeat(r.clock.t - 5)
    out = [r.look(r.wd.sweep())]
    state = json.loads(json.dumps(r.sm.export_state()))
    out.append({"progress": state["last_progress_ts"],
                "hang_s": state["hang_s"]})
    return out


def case_refire_until_recovery(r):
    out = []
    r.sm.collect_global_step(10, r.clock.t)
    r.clock.t += 31
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 15
    out.append(r.look(r.wd.sweep()))
    r.clock.t += 16
    out.append(r.look(r.wd.sweep()))
    r.sm.collect_global_step(11, r.clock.t)
    r.clock.t += 5
    out.append(r.look(r.wd.sweep()))
    return out


CASES = {
    "round_guard": case_round_guard_after_relaunch,
    "seated_stall": case_seated_fleetwide_stall,
    "membership_and_stragglers": case_membership_changes_and_stragglers,
    "silent_members": case_silent_members,
    "refire": case_refire_until_recovery,
}


@pytest.mark.parametrize("case", list(CASES))
def test_watchdog_case_matches_jax(case):
    got = {pkg: CASES[case](Rig(pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    out = got["port"]
    hang = out[-1]["attribution"]["categories"]["collective_hang"] \
        if "attribution" in out[-1] else out[-1]["hang_s"]
    # each case shows what the JAX test asserts of it
    if case == "round_guard":
        assert out[0]["event"] is None and out[1]["event"] is None
        assert out[1]["attribution"]["categories"]["collective_hang"] == 0.0
        assert out[2]["event"] is not None
    elif case == "seated_stall":
        assert out[0]["event"] is None
        assert out[1]["event"]["world"] == 4 and out[1]["waiting"] == 1
        assert out[1]["excluded"] == [[]] and out[2]["event"] is None
        assert out[1]["downtime_open"] and hang > 0
    elif case == "membership_and_stragglers":
        assert [o["event"] for o in out] == [None, None]
        assert out[-1]["excluded"] == [] and out[-1]["waiting"] == 0
    elif case == "silent_members":
        assert out[0]["event"]["silent"] == [2, 3]
        assert out[0]["excluded"] == [[2, 3]]
        assert out[0]["released"] == [2, 3]
        assert hang == pytest.approx(35, abs=1)
        assert out[1]["progress"] == 1000.0
    else:
        assert out[0]["event"] and out[1]["event"] is None
        assert out[2]["event"]["refire"] and out[3]["event"] is None
        assert hang == pytest.approx(62, abs=1)


def test_reform_signal_and_latest_world_match_jax():
    def drive(pkg):
        r = Rig(pkg)
        out = [r.look()]
        r.rdzv.request_re_rendezvous(exclude=[3])
        out.append(r.look())  # a virtual waiter: nobody joined yet
        for nid in (0, 1):
            r.join(nid)
        out.append(r.look())  # real waiters now
        r.clock.t += 6.0  # the waiting timeout passes with 2 of min 2
        world = r.rdzv.get_comm_world(0)
        out.append((world[0], sorted(m.node_id for m in world[2].values())))
        out.append(r.look())
        return out

    jout, pout = drive("jax"), drive("port")
    assert pout == jout
    assert [o["waiting"] for o in pout if isinstance(o, dict)] == [0, 1, 2, 0]
    assert pout[3] == (2, [0, 1]) and pout[-1]["world"] == [0, 1]


# -- (c) the hang under the CLI ------------------------------------------------------


# above the agent's 10 s stop grace (a SIGTERM waits in a stopped process,
# so the SIGKILL after the grace stops it) plus a restart, so that the
# watchdog does not re-fire before the re-formed round seats the new life
HANG_WINDOW_S = 16.0
HANG_AFTER = 3
HANG_STEPS = 5
HANG_TIMEOUT_S = 120

# a CPU worker: a step report every 0.2 s; the first life (no marker file
# yet) SIGSTOPs itself after its HANG_AFTER-th report, alive but never
# stepping again, while its agent keeps heartbeating
HANG_WORKER = """\
import os, signal, sys, time
from dlrover_tpu_torch.train import bootstrap
marker = sys.argv[1]
first = not os.path.exists(marker)
ctx = bootstrap.init()
ctx.step_report_interval = 0.0
print(f"[hang] life {'first' if first else 'second'} pid {os.getpid()}",
      flush=True)
for step in range(1, STEPS + 1):
    time.sleep(0.2)
    ctx.report_step(step, force=True)
    print(f"[hang] step {step} at {time.time():.3f}", flush=True)
    if first and step == AFTER:
        open(marker, "w").close()
        print(f"[hang] stopping at {time.time():.3f}", flush=True)
        os.kill(os.getpid(), signal.SIGSTOP)
print("[hang] done", flush=True)
"""


def test_cli_recovers_a_wedged_worker(tmp_path):
    job = f"torch-hang-{uuid.uuid4().hex[:8]}"
    script = tmp_path / "hang_worker.py"
    script.write_text(HANG_WORKER.replace("STEPS", str(HANG_STEPS))
                      .replace("AFTER", str(HANG_AFTER)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), DLROVER_TPU_HANG_WATCHDOG_WINDOW_S=str(
            HANG_WINDOW_S), OMP_NUM_THREADS="1")
    try:
        r = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
             "--standalone", "--nnodes=1", "--nproc_per_node=1",
             "--accelerator", "cpu", f"--job_name={job}",
             "--max_restarts=0", "--monitor_interval", "0.2", str(script),
             "--", str(tmp_path / "stopped")],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=HANG_TIMEOUT_S)
        with open(os.path.join(agent_log_dir(job, 0),
                               "worker-0-restart0.log")) as f:
            log = f.read()
        assert r.returncode == 0, (r.stderr[-3000:], log[-2000:])
        declared = [x for x in r.stderr.splitlines()
                    if "collective hang declared" in x]
        assert len(declared) == 1, r.stderr[-3000:]
        assert "re-rendezvous requested" in r.stderr
        assert "membership changed; restarting workers" in r.stderr
        # both lives wrote the one log: the second trained every step
        assert log.count("[hang] life first") == 1
        assert log.count("[hang] life second") == 1
        assert log.count("[hang] done") == 1
        second = log.split("[hang] life second", 1)[1]
        assert second.count("[hang] step ") == HANG_STEPS
        summary = [x for x in r.stderr.splitlines()
                   if "attribution {" in x][-1]
        cats = json.loads(re.search(r"attribution (\{.*\}); downtime",
                                    summary).group(1))["categories"]
        # declared by the first sweep (every W/4) past the window
        assert HANG_WINDOW_S <= cats["collective_hang"] <= \
            1.25 * HANG_WINDOW_S + 0.5, cats
        assert "local master exiting: succeeded" in r.stderr
    finally:
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
