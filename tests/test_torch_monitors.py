"""The master's speed and straggler monitors of the port held to the JAX
package's, on the CPU.

(a) ``percentile``, ``digest_of``, ``merge_windows`` and ``StepTimeDigest``
    give equal results on the same seeded samples.
(b) One seeded ``StragglerDetector.observe`` stream gives equal returns,
    records, ``lost_seconds`` and ``snapshot`` in both packages.
(c) One ``SpeedMonitor`` event script on an injected clock (global steps,
    worker joins, removals and evictions, two downtime brackets with their
    breakdowns, digests with a slow rank, checkpoint blocking, comm links,
    a layout, a hang) gives equal ``attribution()``, ``goodput()``,
    ``total_downtime()``, ``avg_downtime()``, ``downtime_breakdown()``,
    ``straggler_report()``, ``comm_link_report()`` and ``trace_events()``,
    and ``speed_monitor_lines`` the same text.
(d) A request script through both servicers, each holding a speed monitor
    and a job manager on one fixed clock (step reports with digests from a
    fast and a slow rank, a failure report, a straggler query, checkpoint
    and resize reports, the training status): byte-equal replies and an
    equal attribution, goodput and straggler report; the step report the
    port's master client sends with a digest is the JAX client's, byte for
    byte.
(e) The master's ``/metrics`` on an ephemeral port serves the gate's and
    the speed monitor's lines, and the local master starts it only under
    ``DLROVER_TPU_MASTER_METRICS_PORT``.
(f) The worker side: the trainer's digest skips the first step, is the
    step's host wall on the CPU and its device time between CUDA events on
    the card (waiting only for the step before the one just queued), and
    ``WorkerContext.report_step`` drains a window with the input wait and
    keeps a window whose report failed for the next report, as the JAX
    bootstrap does.
"""

import urllib.request

import numpy as np
import pytest
import torch

from dlrover_tpu.agent.master_client import MasterClient as JaxMasterClient
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.common import serde as jserde
from dlrover_tpu.common.global_context import (
    MasterConfigContext as JaxConfigContext,
)
from dlrover_tpu.master import metrics as jmetrics
from dlrover_tpu.master.monitor import speed_monitor as jspeed
from dlrover_tpu.master.monitor import straggler as jstraggler
from dlrover_tpu.master.node.job_context import JobContext as JaxJobContext
from dlrover_tpu.master.node.job_manager import (
    LocalJobManager as JaxLocalJobManager,
)
from dlrover_tpu.master.rendezvous import manager as jmanager
from dlrover_tpu.master.servicer import MasterServicer as JaxServicer
from dlrover_tpu.observability import digest as jdigest
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import serde
from dlrover_tpu_torch.common.constants import NodeType, RendezvousName
from dlrover_tpu_torch.master import metrics
from dlrover_tpu_torch.master.job_container import JobContainer
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.master.monitor import speed_monitor
from dlrover_tpu_torch.master.monitor import straggler
from dlrover_tpu_torch.master.node.job_manager import LocalJobManager
from dlrover_tpu_torch.master.rendezvous import manager
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.observability import digest
from dlrover_tpu_torch.rpc.transport import RequestGate
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig


class Clock:
    """A settable clock both packages' monitors read."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- (a) the digest -------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_percentile_and_digest_of_match_jax(n):
    rng = np.random.default_rng(n)
    samples = rng.exponential(0.3, n).tolist()
    for q in (0.0, 0.25, 0.5, 0.95, 1.0):
        assert digest.percentile(samples, q) == jdigest.percentile(samples, q)
    assert digest.digest_of(samples) == jdigest.digest_of(samples)


def test_step_digest_and_merge_windows_match_jax():
    rng = np.random.default_rng(5)
    mine, theirs = digest.StepTimeDigest(max_samples=8), \
        jdigest.StepTimeDigest(max_samples=8)
    windows = []
    for size in (0, 3, 12, 1):
        for x in rng.exponential(0.2, size).tolist() + [-1.0] * (size > 2):
            mine.add(x)
            theirs.add(x)
        a, b = mine.snapshot_and_reset(), theirs.snapshot_and_reset()
        assert a == b
        if a is not None:
            a["input_wait_s"] = float(rng.uniform(0, 2))
        windows.append(a)
    for x in windows + [{}, {"count": 0}]:
        for y in windows + [None]:
            assert digest.merge_windows(x, y) == jdigest.merge_windows(x, y)
    digest.set_last_window(windows[1])
    assert digest.last_window() == windows[1]


# -- (b) the straggler detector --------------------------------------------------


def _observations(seed=3):
    """(node, p50, count, ts): four ranks, rank 2 slow for four windows,
    then recovered, rank 3 slow twice, an eviction in between."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(8):
        for node in range(4):
            p50 = 1.0 + 0.05 * rng.standard_normal()
            if node == 2 and 1 <= w <= 4:
                p50 *= 2.0
            if node == 3 and w in (5, 6):
                p50 *= 1.8
            out.append((node, round(p50, 6), int(rng.integers(1, 20)),
                        1000.0 + 15 * w))
    return out


def test_straggler_detector_matches_jax():
    mine = straggler.StragglerDetector(ratio=1.5, windows=3)
    theirs = jstraggler.StragglerDetector(ratio=1.5, windows=3)
    for i, (node, p50, count, ts) in enumerate(_observations()):
        if i == 20:
            mine.forget(1)
            theirs.forget(1)
        a = mine.observe(node, p50, count=count, ts=ts)
        b = theirs.observe(node, p50, count=count, ts=ts)
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.to_dict() == b.to_dict()
        assert mine.stragglers() == theirs.stragglers()
    # a zero p50 and a fleet of one flag nothing
    assert mine.observe(0, 0.0) is None and theirs.observe(0, 0.0) is None
    assert [r.to_dict() for r in mine.records()] == [
        r.to_dict() for r in theirs.records()]
    assert [r.to_dict() for r in mine.drain_new()] == [
        r.to_dict() for r in theirs.drain_new()]
    assert mine.drain_new() == [] and theirs.drain_new() == []
    assert mine.lost_seconds() == theirs.lost_seconds() > 0
    assert mine.snapshot() == theirs.snapshot()


def test_straggler_flags_read_the_jax_names(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_STRAGGLER_RATIO", "2.5")
    monkeypatch.setenv("DLROVER_TPU_STRAGGLER_WINDOWS", "4")
    mine, theirs = straggler.StragglerDetector(), \
        jstraggler.StragglerDetector()
    assert (mine.ratio, mine.windows) == (theirs.ratio, theirs.windows) == (
        2.5, 4)


# -- (c) the speed monitor -------------------------------------------------------


def _drive(mod, clock):
    """One event script through ``mod.SpeedMonitor`` on ``clock``."""
    sm = mod.SpeedMonitor(clock=clock)
    rng = np.random.default_rng(11)
    sm.set_target_worker_num(3)
    for node in range(3):
        sm.add_running_worker(NodeType.WORKER, node)
    out = {"joined": sm.all_worker_joined()}
    step = 0
    for w in range(6):
        clock.t += 15.0
        step += 10
        sm.collect_global_step(step)
        sm.collect_global_step(step - 3)  # a stale report changes nothing
        for node in range(3):
            p50 = 0.5 + 0.02 * rng.standard_normal()
            if node == 1 and w >= 1:
                p50 *= 1.9  # rank 1 straggles from the second window
            rec = sm.collect_step_digest(node, {
                "count": 10, "mean_s": round(p50 * 1.05, 6),
                "p50_s": round(p50, 6), "p95_s": round(p50 * 1.3, 6),
                "max_s": round(p50 * 1.5, 6),
                "input_wait_s": round(float(rng.uniform(0, 0.3)), 6)},
                ts=clock.t)
            out.setdefault("records", []).append(
                None if rec is None else rec.to_dict())
        sm.record_ckpt_blocking(0.02 * (w + 1), node_id=w % 3)
        sm.record_comm_links(w % 3, {"ici": 1000 * (w + 1), "dcn": 10},
                             overlap_ratio=0.25 if w % 2 else -1.0)
        if w == 2:
            # a failure: the bracket opens at the report's time and
            # closes at the next step report
            sm.mark_downtime_start(ts=clock.t + 1.0)
            out["open"] = sm.downtime_in_progress()
            clock.t += 30.0
            out["goodput_open"] = sm.goodput()
            out["down_open"] = sm.total_downtime()
            sm.record_downtime_breakdown(rendezvous_s=2.5, compile_s=4.0,
                                         state_transfer_s=9.0,
                                         restore_tier="shm")
            sm.mark_downtime_end(ts=clock.t)
        if w == 4:
            sm.mark_downtime_start()
            clock.t += 12.0
            sm.record_downtime_breakdown(rendezvous_s=1.0,
                                         state_transfer_s=3.0,
                                         restore_tier="live")
            sm.mark_downtime_end()
            sm.record_hang(5.5)
            sm.evict_worker(NodeType.WORKER, 2)
    sm.remove_running_worker(NodeType.WORKER, 0)
    sm.report_layout("dp2")
    clock.t += 3.0
    out.update(
        attribution=sm.attribution(), goodput=sm.goodput(),
        total_downtime=sm.total_downtime(), avg=sm.avg_downtime(),
        breakdown=sm.downtime_breakdown(),
        stragglers=sm.stragglers(), report=sm.straggler_report(),
        links=sm.comm_link_report(), layout=sm.layout_spec(),
        workers=sorted(sm.running_workers), speed=sm.running_speed(),
        secs=sm.secs_per_step(), step=sm.completed_global_step,
        start=sm.start_training_time, progress=sm.last_progress_ts(),
        events=sm.trace_events(), joined_after=sm.all_worker_joined())
    return sm, out


def test_speed_monitor_script_matches_jax():
    mine_sm, mine = _drive(speed_monitor, Clock())
    theirs_sm, theirs = _drive(jspeed, Clock())
    assert mine == theirs
    # the script exercised what it is about
    assert mine["stragglers"] == [1]
    cats = mine["attribution"]["categories"]
    assert cats["straggler_wait"] > 0 and cats["checkpoint"] > 0
    assert cats["collective_hang"] == 5.5 and cats["productive"] > 0
    assert mine["total_downtime"] == 41.0
    assert mine["breakdown"]["restore_tiers"] == {"shm": 1, "live": 1}
    assert metrics.speed_monitor_lines(mine_sm) == \
        jmetrics.speed_monitor_lines(theirs_sm)


def test_speed_monitor_without_digests_attributes_the_residual():
    """No rank sent a digest: productive is the wall minus the downtime
    nothing explained, in both packages."""
    outs = []
    for mod in (speed_monitor, jspeed):
        clock = Clock()
        sm = mod.SpeedMonitor(clock=clock)
        sm.collect_global_step(1)
        clock.t += 100.0
        sm.mark_downtime_start()
        clock.t += 20.0
        sm.mark_downtime_end()
        sm.collect_global_step(2)
        outs.append((sm.attribution(), sm.goodput()))
    assert outs[0] == outs[1]
    assert outs[0][0]["productive_source"] == "residual"


# -- (d) the servicers ------------------------------------------------------------


def _managers(mod, config):
    mgrs = {
        RendezvousName.TRAINING:
            mod.ElasticTrainingRendezvousManager(config=config),
        RendezvousName.NETWORK_CHECK:
            mod.NetworkCheckRendezvousManager(config=config),
    }
    for m in mgrs.values():
        m.update_rdzv_params(min_nodes=2, max_nodes=2, node_unit=1,
                             waiting_timeout=60)
    return mgrs


def _jax_master(clock):
    ctx = JaxJobContext()
    sm = jspeed.SpeedMonitor(clock=clock)
    sm.set_target_worker_num(2)
    mgrs = _managers(jmanager, JaxConfigContext())
    jm = JaxLocalJobManager(speed_monitor=sm, rdzv_managers=mgrs,
                            job_context=ctx, clock=clock)
    return JaxServicer(job_manager=jm, speed_monitor=sm, rdzv_managers=mgrs,
                       job_context=ctx), sm


def _port_master(clock):
    container = JobContainer()
    sm = speed_monitor.SpeedMonitor(clock=clock)
    sm.set_target_worker_num(2)
    mgrs = _managers(manager, container.config)
    pm = LocalJobManager(speed_monitor=sm, rdzv_managers=mgrs,
                         job_context=container.job_context, clock=clock)
    return MasterServicer(job_manager=pm, speed_monitor=sm,
                          rdzv_managers=mgrs,
                          job_context=container.job_context), sm


def _monitor_script():
    """(kind, request, seconds the clock moves before it), from the JAX
    package's classes: two ranks' step reports with digests (rank 1 at
    twice rank 0's p50), a failure, a straggler query, checkpoint and
    resize reports, the recovery's step report, the training status."""
    m = jmsg
    seq = [(0.0, "report", m.NodeAddressReport(
        node_type="worker", node_id=node, addr=f"10.0.0.{node + 1}"))
        for node in (0, 1)]
    seq.append((0.0, "get", m.TrainingStatusRequest()))
    for w in range(4):
        for node in (0, 1):
            p50 = 0.25 * (2 if node else 1) + 0.001 * w
            seq.append((7.5, "report", m.GlobalStepReport(
                node_id=node, step=10 * (w + 1), timestamp=0.0,
                digest={"count": 10, "mean_s": round(p50 * 1.1, 6),
                        "p50_s": round(p50, 6), "p95_s": round(p50 * 1.4, 6),
                        "max_s": round(p50 * 2, 6),
                        "input_wait_s": 0.01 * (node + 1)})))
        seq.append((0.0, "get", m.StragglersRequest()))
    seq += [
        (0.0, "report", m.CheckpointStepReport(node_id=0, step=40,
                                               blocking_s=0.021)),
        (0.0, "report", m.CheckpointStepReport(node_id=1, step=40,
                                               blocking_s=0.019)),
        (2.0, "report", m.NodeFailureReport(
            node_type="worker", node_id=1, restart_count=0,
            error_data="Traceback (most recent call last):", exit_code=-9)),
        (0.0, "get", m.StragglersRequest()),
        (0.0, "get", m.TrainingStatusRequest()),
        (40.0, "report", m.ResizeBreakdownReport(
            rendezvous_s=0.01, compile_s=8.0, state_transfer_s=5.5,
            restore_tier="shm")),
        (5.0, "report", m.WorkerReport(node_type="worker", node_id=1,
                                       step=-1)),
        (5.0, "report", m.GlobalStepReport(
            node_id=1, step=50, digest={"count": 1, "mean_s": 0.6,
                                        "p50_s": 0.6, "p95_s": 0.6,
                                        "max_s": 0.6})),
        (1.0, "get", m.StragglersRequest()),
        (0.0, "get", m.TrainingStatusRequest()),
    ]
    return seq


def test_servicers_with_speed_monitors_reply_alike():
    jclock, pclock = Clock(), Clock()
    jax_side, jsm = _jax_master(jclock)
    port_side, psm = _port_master(pclock)
    for i, (dt, kind, request) in enumerate(_monitor_script()):
        jclock.t += dt
        pclock.t += dt
        if isinstance(request, (jmsg.GlobalStepReport, jmsg.WorkerReport,
                                jmsg.NodeFailureReport)):
            request.timestamp = jclock.t
        wire = jserde.serialize(request)
        jfn = jax_side.get if kind == "get" else jax_side.report
        pfn = port_side.get if kind == "get" else port_side.report
        jreply = jserde.serialize(jfn(jserde.deserialize(wire)))
        preply = serde.serialize(pfn(serde.deserialize(wire)))
        assert preply == jreply, (i, type(request).__name__, preply, jreply)
    assert psm.attribution() == jsm.attribution()
    assert psm.goodput() == jsm.goodput() < 1.0
    assert psm.total_downtime() == jsm.total_downtime() == 50.0
    assert psm.straggler_report() == jsm.straggler_report()
    assert psm.downtime_breakdown() == jsm.downtime_breakdown()
    # rank 1's p50 is twice rank 0's for three windows: flagged, and the
    # straggler queries after it answered [1] in both packages
    assert psm.stragglers() == jsm.stragglers() == [1]
    assert sorted(psm.running_workers) == sorted(jsm.running_workers)


def test_step_report_with_a_digest_is_the_jax_one():
    sent = []

    class Capture:
        def report(self, request, **kw):
            sent.append(request)

    window = {"count": 4, "mean_s": 0.25, "p50_s": 0.24, "p95_s": 0.3,
              "max_s": 0.31, "input_wait_s": 0.002}
    JaxMasterClient("x:1", node_id=3, client=Capture()).report_global_step(
        12, digest=window, timestamp=1234.5)
    port = MasterClient("127.0.0.1:1", node_id=3)
    port._client = Capture()
    port.report_global_step(12, digest=window, timestamp=1234.5)
    assert serde.serialize(sent[1]) == jserde.serialize(sent[0])


# -- (e) /metrics ----------------------------------------------------------------


def test_metrics_endpoint_serves_the_gauges():
    clock = Clock()
    sm = speed_monitor.SpeedMonitor(clock=clock)
    sm.collect_global_step(7)
    clock.t += 10
    gate = RequestGate(report_cap=1)
    assert gate.try_enter("report", node_id=0)
    assert not gate.try_enter("report", node_id=1)
    gate.leave("report")

    class Server:
        pass

    server = Server()
    server.gate = gate
    srv = metrics.MasterMetricsServer(port=0)
    srv.add_provider(gate.prometheus_lines)
    srv.add_provider(lambda: metrics.speed_monitor_lines(sm))
    srv.add_provider(lambda: 1 / 0)  # a failing provider is skipped
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            body = r.read().decode()
        assert r.status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/x",
                                   timeout=10)
    finally:
        srv.stop()
    lines = body.splitlines()
    assert lines == gate.prometheus_lines() + metrics.speed_monitor_lines(sm)
    assert 'dlrover_tpu_master_rpc_total{method="report",outcome=' \
           '"rejected"} 1' in lines
    assert "dlrover_tpu_master_global_step 7" in lines
    assert "dlrover_tpu_master_goodput 1.000000" in lines


def test_local_master_serves_metrics_only_when_asked(monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_MASTER_METRICS_PORT", raising=False)
    master = LocalJobMaster()
    master.prepare()
    try:
        assert master._metrics_server is None
    finally:
        master.stop()
    monkeypatch.setenv("DLROVER_TPU_MASTER_METRICS_PORT", "0")
    master = LocalJobMaster(node_num=2)
    master.prepare()
    try:
        port = master._metrics_server.port
        assert port > 0
        assert master.speed_monitor is master.container.speed_monitor
        client = MasterClient(f"127.0.0.1:{master.port}", node_id=0)
        client.report_global_step(3, digest={
            "count": 2, "mean_s": 0.5, "p50_s": 0.5, "p95_s": 0.5,
            "max_s": 0.5})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics",
                timeout=10) as r:
            body = r.read().decode()
    finally:
        master.stop()
    assert "dlrover_tpu_master_global_step 3" in body.splitlines()
    assert "dlrover_tpu_master_stragglers 0" in body.splitlines()


# -- (f) the worker side ------------------------------------------------------------


def test_trainer_digest_skips_the_first_step():
    from dlrover_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    trainer = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg),
                             TrainConfig(global_batch_size=2,
                                         micro_batch_size=1))
    state = trainer.init_state(
        llama.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = torch.zeros((2, 1, 8), dtype=torch.long)
    for _ in range(3):
        state, _ = trainer.step(state, batch)
    window = trainer.step_digest.snapshot_and_reset()
    assert window["count"] == 2 and window["mean_s"] > 0
    assert trainer.step_digest.snapshot_and_reset() is None


def test_trainer_digest_on_the_cpu_is_the_host_wall():
    """On the CPU the step is synchronous: each sample is the step's host
    wall from its entry to its return."""
    import time

    from dlrover_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()

    def slow_loss(p, t):
        time.sleep(0.05)
        return llama.loss_fn(p, t, cfg)

    trainer = ElasticTrainer(slow_loss, TrainConfig(global_batch_size=1,
                                                    micro_batch_size=1))
    state = trainer.init_state(
        llama.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = torch.zeros((1, 1, 8), dtype=torch.long)
    walls = []
    for _ in range(4):
        t0 = time.monotonic()
        state, _ = trainer.step(state, batch)
        walls.append(time.monotonic() - t0)
    window = trainer.step_digest.snapshot_and_reset()
    assert window["count"] == 3
    assert 0.05 <= window["mean_s"] <= sum(walls[1:]) / 3
    assert window["max_s"] <= max(walls[1:])


def test_trainer_digest_on_the_card_reads_step_events(monkeypatch):
    """On the card a sample is the device time between the step's start
    and end events: after queuing step N the trainer waits for step N-1's
    end event only (never the step just queued), reads every pair that has
    passed, skips the first step's, and ``step_digest`` reads a passed
    pair without waiting. Fake events stand in for CUDA's."""
    from dlrover_tpu_torch.train import trainer as trainer_mod

    now = [0.0]
    waits = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t, self.done = None, False

        def record(self, stream=None):
            self.t = now[0]

        def query(self):
            return self.done

        def synchronize(self):
            waits.append(self)
            self.done = True

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(trainer_mod.torch.cuda, "Event", FakeEvent)
    trainer = ElasticTrainer(lambda p, t: None, TrainConfig(
        global_batch_size=1, micro_batch_size=1))
    device_times = [5.0, 0.2, 0.25, 0.3]  # the first step builds
    starts, t = [], 0.0
    for dur in device_times:
        start = FakeEvent(enable_timing=True)
        now[0] = t
        start.record()
        starts.append(start)
        t += dur
        now[0] = t  # the end event's device time
        trainer._end_step(0.0, start, stream=None)
    ends = [e for _, e, _ in trainer._step_events]
    # the host waited for each step's predecessor's end, in order
    assert len(waits) == 3 and all(w.t is not None for w in waits)
    assert not ends[-1].done and len(ends) == 1
    assert trainer._digest.snapshot_and_reset() == {
        "count": 2, "mean_s": 0.225, "p50_s": 0.2, "p95_s": 0.25,
        "max_s": 0.25}
    # the last step's pair is read once the card has passed its end
    assert trainer.step_digest.snapshot_and_reset() is None
    ends[-1].done = True
    window = trainer.step_digest.snapshot_and_reset()
    assert window["count"] == 1 and window["mean_s"] == pytest.approx(0.3)
    assert len(waits) == 3 and not trainer._step_events


def test_report_step_drains_a_window_and_keeps_a_failed_one():
    calls = []

    class Client:
        fail = False

        def report_global_step(self, step, digest=None):
            calls.append((step, digest))
            if self.fail:
                raise ConnectionError("master gone")

    client = Client()
    ctx = bootstrap.WorkerContext(bootstrap.WorkerEnv(), client=client)
    d = digest.StepTimeDigest()
    for x in (0.2, 0.4):
        d.add(x)
    ctx.add_input_wait(0.5)
    ctx.report_step(2, force=True, digest=d)
    assert calls[-1] == (2, {"count": 2, "mean_s": 0.3, "p50_s": 0.2,
                             "p95_s": 0.4, "max_s": 0.4,
                             "input_wait_s": 0.5})
    assert digest.last_window() == calls[-1][1]
    # throttled: no report inside the interval without force
    d.add(1.0)
    ctx.report_step(3, digest=d)
    assert len(calls) == 1
    client.fail = True
    ctx.add_input_wait(0.25)
    ctx.report_step(3, force=True, digest=d)
    failed = calls[-1][1]
    assert failed["count"] == 1 and failed["input_wait_s"] == 0.25
    client.fail = False
    d.add(3.0)
    ctx.report_step(4, force=True, digest=d)
    window = dict(count=1, mean_s=3.0, p50_s=3.0, p95_s=3.0, max_s=3.0,
                  input_wait_s=0.0)
    assert calls[-1] == (4, digest.merge_windows(failed, window))
    assert calls[-1][1] == jdigest.merge_windows(failed, window)
    assert calls[-1][1]["count"] == 2
