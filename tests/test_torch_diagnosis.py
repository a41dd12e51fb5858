"""The port's diagnosis chain against the JAX package's, case by case as
tests/test_diagnosis.py runs it.

Each case feeds the same records, stacks and speed samples, built from a
seed with numpy, to both packages and requires:
- equal facts from ``InferenceChain.infer``;
- equal enqueued actions (``action_cls``, ``action_content``,
  ``instance``; the expiry is a wall-clock stamp and left out);
- equal resolver summaries (``stuck_at``, ``pending_programs``,
  ``mfu_ranking``, ``slowest_node``);
- equal ``StackTrie.hot_path``/``render`` over the same faulthandler text,
  equal ``HangDumper`` bundles from one child process per package, and
  equal ``report_once`` messages to a recording client.
Last, a port-only run of the cross-node dump orchestration over the port's
master and agents.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dlrover_tpu.agent import diagnosis_agent as jagent_mod
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.common.constants import NodeStatus as JNodeStatus
from dlrover_tpu.common.constants import NodeType as JNodeType
from dlrover_tpu.common.node import Node as JNode
from dlrover_tpu.diagnosis import actions as jactions
from dlrover_tpu.diagnosis import data as jdata
from dlrover_tpu.diagnosis import inference as jinf
from dlrover_tpu.diagnosis import operators as jops
from dlrover_tpu.master.diagnosis.manager import (
    DiagnosisManager as JDiagnosisManager,
)
from dlrover_tpu.master.job_container import JobContainer as JJobContainer
from dlrover_tpu.master.node.job_context import JobContext as JJobContext
from dlrover_tpu.master.node.job_context import get_job_context
from dlrover_tpu.profiler import analysis as janalysis
from dlrover_tpu.profiler import hang_dump as jhang_dump

from dlrover_tpu_torch.agent import diagnosis_agent as pagent_mod
from dlrover_tpu_torch.common import messages as pmsg
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.diagnosis import actions as pactions
from dlrover_tpu_torch.diagnosis import data as pdata
from dlrover_tpu_torch.diagnosis import inference as pinf
from dlrover_tpu_torch.diagnosis import operators as pops
from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.profiler import analysis as panalysis
from dlrover_tpu_torch.profiler import hang_dump as phang_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2, 3]
FUNCS = ["psum", "all_reduce", "_ring_step", "wait", "synchronize",
         "train_step", "main", "_end_step"]


def facts(inferences):
    """Facts as plain tuples, comparable across the packages."""
    return [(f.name, f.attribution, f.description, f.configuration)
            for f in inferences]


def action_key(action):
    return (action.action_cls, action.action_content, action.instance)


def drain(next_action, ids):
    out = []
    for i in ids:
        while True:
            a = next_action(i)
            if a is None:
                break
            out.append(action_key(a))
    return out


def random_stack(rng, main=True):
    """One faulthandler dump: a main thread and an idle helper, frames
    drawn from FUNCS."""
    depth = int(rng.randint(2, 6))
    frames = [FUNCS[int(i)] for i in rng.randint(0, len(FUNCS), depth)]
    head = ("Current thread 0x%x (most recent call first):\n" if main
            else "Thread 0x%x (most recent call first):\n")
    lines = [head % int(rng.randint(1, 1 << 30))]
    for k, fn in enumerate(frames):
        lines.append(f'  File "/app/mod{k}.py", line {10 + k} in {fn}\n')
    lines.append("\nThread 0x2 (most recent call first):\n"
                 '  File "/usr/lib/python3/threading.py", line 320 in wait\n'
                 '  File "/usr/lib/python3/threading.py", line 600 in run\n')
    return "".join(lines)


def seeded_records(seed):
    """(kind, content, node_id) reports of one seeded scenario: metrics
    with hang flags and mfu, log tails, hang dumps with stacks and pending
    programs."""
    rng = np.random.RandomState(seed)
    nodes = int(rng.randint(2, 5))
    all_hang = bool(rng.rand() < 0.6)
    out = []
    for n in range(nodes):
        out.append(("TpuMetricsRecord", json.dumps({
            "hang": all_hang or bool(rng.rand() < 0.5),
            "mfu": round(float(rng.rand()) * 0.5, 4)}), n))
        log = ["step %d loss %.3f" % (s, rng.rand()) for s in range(3)]
        if rng.rand() < 0.4:
            log.append(["RESOURCE_EXHAUSTED: out of memory",
                        "Traceback (most recent call last):",
                        "hbm ecc error on chip 2",
                        "another task died"][int(rng.randint(0, 4))])
        out.append(("TrainingLogRecord",
                    pdata.TrainingLogRecord(node_id=n, logs=log).to_json(),
                    n))
        if rng.rand() < 0.7:
            out.append(("HangDumpRecord", json.dumps({
                "reason": "tpu_timer_hang",
                "stacks": {str(100 + n): random_stack(rng)},
                "pending": {str(18890 + n): {"hang": True, "pending": [
                    {"name": ["nccl:AllReduce", "train_step"][
                        int(rng.randint(0, 2))], "age_us": 9_000_000}]}},
            }), n))
    return nodes, out


# -- each case of tests/test_diagnosis.py, both packages ---------------------

@pytest.mark.parametrize("text", [
    "", "RESOURCE_EXHAUSTED: HBM OOM", "worker preempted, SIGTERM",
    "hbm ecc error on chip 3",
    "Traceback (most recent call last):\n  ValueError",
    "all good, step 100 loss 2.3",
    "Terminating process because the JAX distributed service detected "
    "fatal errors. This most likely indicates that another task died",
    "SIGTERM received, reporting preemption notice",
    "hbm ecc uncorrectable error\ncoordination_service_agent.cc: agent",
])
def test_classify_log(text):
    assert pops.classify_log(text) == jops.classify_log(text)


def test_data_manager_window_and_latest():
    got = []
    for data in (pdata, jdata):
        dm = data.DiagnosisDataManager(expire_time_secs=60)
        dm.store_data(data.TrainingLogRecord(node_id=0, logs=["a"]))
        dm.store_data(data.TrainingLogRecord(node_id=0, logs=["b"]))
        dm.store_data(data.TrainingLogRecord(node_id=1, logs=["c"]))
        old = data.TrainingLogRecord(node_id=2, logs=["old"])
        old.timestamp = time.time() - 120
        dm.store_data(old)
        latest = dm.latest_per_node(data.DiagnosisDataType.TRAINING_LOG)
        got.append((len(dm.get_data(data.DiagnosisDataType.TRAINING_LOG)),
                    {k: v.data_content for k, v in latest.items()}))
    assert got[0] == got[1] == (3, {0: "b", 1: "c"})


def test_hang_operator_confirms_and_denies():
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        dm = data.DiagnosisDataManager()
        op = ops.CheckTrainingHangOperator(dm)
        seen = [facts(op.infer([ops.HANG_PROBLEM]))]
        dm.store_data(data.TpuMetricsRecord(node_id=0, hang=True))
        dm.store_data(data.TpuMetricsRecord(node_id=1, hang=True))
        seen.append(facts(op.infer([ops.HANG_PROBLEM])))
        dm.store_data(data.TpuMetricsRecord(node_id=1, hang=False))
        seen.append(facts(op.infer([ops.HANG_PROBLEM])))
        got.append(seen)
    assert got[0] == got[1]
    assert [s[0][1] for s in got[0]] == ["not", "is", "not"]


class _Samples:
    """A speed monitor's face to the hang check: a completed global step
    and its step samples, each with a timestamp."""

    def __init__(self, stamps):
        self.completed_global_step = len(stamps)
        self._samples = [type("S", (), {"timestamp": t})() for t in stamps]


@pytest.mark.parametrize("silent_s,threshold", [(5.0, 30.0), (45.0, 30.0),
                                                (0.5, 0.0)])
def test_hang_check_reads_step_silence(silent_s, threshold):
    """The step reports corroborate the timers' flag: a fleet that reported
    a step within the threshold is not hung."""
    sm = _Samples([time.time() - 100.0, time.time() - silent_s])
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        dm = data.DiagnosisDataManager()
        dm.store_data(data.TpuMetricsRecord(node_id=0, hang=True))
        op = ops.CheckTrainingHangOperator(dm, sm, silence_secs=threshold)
        got.append(facts(op.infer([ops.HANG_PROBLEM])))
    assert got[0] == got[1]
    assert got[0][0][1] == ("is" if silent_s >= threshold else "not")


def _chain(data, ops, inf, dm):
    return inf.InferenceChain(
        [ops.HANG_PROBLEM, ops.FAILURE_PROBLEM],
        [ops.CheckTrainingHangOperator(dm),
         ops.CheckFailureNodeOperator(dm),
         ops.ResolveTrainingHangOperator(dm),
         ops.ResolveFailureNodeOperator(dm)])


def test_full_chain_failure_to_action():
    got = []
    for data, ops, inf in ((pdata, pops, pinf), (jdata, jops, jinf)):
        dm = data.DiagnosisDataManager()
        dm.store_data(data.TrainingLogRecord(
            node_id=3, logs=["XlaRuntimeError: RESOURCE_EXHAUSTED"]))
        got.append(facts(_chain(data, ops, inf, dm).infer()))
    assert got[0] == got[1]
    actions = [f for f in got[0] if f[0] == "action"]
    assert [a[2] for a in actions] == ["restart"]


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_chain_gives_equal_facts(seed):
    """Two chain cycles over one seeded scenario: the same facts, the
    second cycle's resolution included."""
    _, records = seeded_records(seed)
    got = []
    for data, ops, inf in ((pdata, pops, pinf), (jdata, jops, jinf)):
        dm = data.DiagnosisDataManager()
        for kind, content, node in records:
            dm.store_data(data.parse_report(kind, content, node_id=node))
        chain = _chain(data, ops, inf, dm)
        got.append([facts(chain.infer()), facts(chain.infer())])
    assert got[0] == got[1]


def _port_manager():
    ctx = JobContext()
    return DiagnosisManager(interval_secs=3600, job_context=ctx), ctx


def _jax_manager():
    JJobContainer.fresh()
    return JDiagnosisManager(interval_secs=3600), get_job_context()


def _report(msg_mod, kind, content, node):
    return msg_mod.DiagnosisReportData(data_cls=kind, data_content=content,
                                       node_id=node)


def _both_managers(node_ids):
    out = []
    for make, node_cls, ntype, nstatus, msg_mod in (
            (_port_manager, Node, NodeType, NodeStatus, pmsg),
            (_jax_manager, JNode, JNodeType, JNodeStatus, jmsg)):
        mgr, ctx = make()
        for i in node_ids:
            ctx.update_node(node_cls(ntype.WORKER, i,
                                     status=nstatus.RUNNING))
        out.append((mgr, ctx, msg_mod))
    return out


def test_manager_enqueues_actions_for_heartbeat():
    got = []
    for mgr, ctx, msg_mod in _both_managers([5]):
        mgr.collect_diagnosis_data(_report(
            msg_mod, "TrainingLogRecord", pdata.TrainingLogRecord(
                node_id=5, logs=["chip failure on host"]).to_json(), 5))
        got.append((facts(mgr.diagnose_once()), drain(ctx.next_action, [5])))
    assert got[0] == got[1]
    assert got[0][1] == [("RelaunchWorker", "hardware", 5)]


def test_manager_hang_restarts_all():
    got = []
    for mgr, ctx, msg_mod in _both_managers([0, 1]):
        for i in range(2):
            mgr.collect_diagnosis_data(_report(
                msg_mod, "TpuMetricsRecord", json.dumps({"hang": True}), i))
        mgr.diagnose_once()
        phase1 = drain(ctx.next_action, [0, 1])
        for i in range(2):
            mgr.collect_diagnosis_data(_report(msg_mod, "HangDumpRecord",
                                               json.dumps({
                "reason": "master_request",
                "stacks": {str(100 + i): (
                    'Current thread 0x1 (most recent call first):\n'
                    '  File "c.py", line 1 in psum\n')},
                "pending": {},
            }), i))
        mgr.diagnose_once()
        got.append((phase1, drain(ctx.next_action, [0, 1])))
    assert got[0] == got[1]
    assert [a[0] for a in got[0][0]] == ["CollectHangDump"] * 2
    assert [a[0] for a in got[0][1]] == ["RestartWorker"] * 2
    assert all("psum" in a[1] for a in got[0][1])


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_manager_enqueues_equal_actions(seed):
    nodes, records = seeded_records(seed)
    got = []
    for mgr, ctx, msg_mod in _both_managers(range(nodes)):
        cycles = []
        for _ in range(3):
            for kind, content, node in records:
                mgr.collect_diagnosis_data(_report(msg_mod, kind, content,
                                                   node))
            cycles.append((facts(mgr.diagnose_once()),
                           drain(ctx.next_action, range(nodes))))
        got.append(cycles)
    assert got[0] == got[1]


def test_parse_report_types():
    got = []
    for data in (pdata, jdata):
        rec = data.parse_report("TpuMetricsRecord",
                                json.dumps({"hang": True}), node_id=7)
        rec2 = data.parse_report("Unknown", "free text", node_id=1)
        got.append((type(rec).__name__, rec.node_id, rec.hang,
                    rec2.data_content))
    assert got[0] == got[1] == ("TpuMetricsRecord", 7, True, "free text")


@pytest.mark.parametrize("restarts,budget,tail", [
    (0, 3, "OOM on step"), (0, 3, "ICI link down; DATA_LOSS"),
    (3, 3, "Traceback (most recent call last)"),
    (1, 3, "Traceback (most recent call last)"),
])
def test_agent_failure_decision(restarts, budget, tail):
    got = pagent_mod.DiagnosisAgent().diagnose_training_failure(
        pagent_mod.WorkerFailure(0, restarts, budget, log_tail=tail))
    want = jagent_mod.DiagnosisAgent().diagnose_training_failure(
        jagent_mod.WorkerFailure(0, restarts, budget, log_tail=tail))
    assert got == want


def test_action_expiry():
    got = []
    for ctx, actions in ((JobContext(), pactions), (JJobContext(),
                                                    jactions)):
        a = actions.restart_worker(1, expiry=-5)
        a.expired_ts = time.time() - 1
        ctx.enqueue_action(a)
        first = ctx.next_action(1)
        ctx.enqueue_action(actions.restart_worker(1, reason="x"))
        got.append((first, action_key(ctx.next_action(1))))
    assert got[0] == got[1] == (None, ("RestartWorker", "x", 1))


def _summary(fact):
    cfg = fact.config()
    return (fact.description, {k: cfg.get(k) for k in (
        "stuck_at", "pending_programs", "mfu_ranking", "slowest_node",
        "hang_dump_hosts", "reason")})


def test_hang_resolver_summarizes_hang_dumps():
    stack = (
        'Thread 0x1 (most recent call first):\n'
        '  File "/app/dlrover_tpu/ops/ring_attention.py", line 88 in '
        '_ring_step\n'
        '  File "/app/train.py", line 80 in main\n'
    )
    bundle = {
        "reason": "tpu_timer_hang",
        "stacks": {"101": stack, "102": stack},
        "pending": {"9200": {"hang": True, "pending": [
            {"name": "jit_train_step", "age_us": 9_000_000}]}},
    }
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        dm = data.DiagnosisDataManager()
        for node_id, mfu in ((0, 0.42), (1, 0.11)):
            rec = data.TpuMetricsRecord(hang=True, mfu=mfu)
            rec.node_id = node_id
            dm.store_data(rec)
        op = ops.ResolveTrainingHangOperator(dm)
        (first,) = op.infer([])
        held = op.infer([])  # no dump arrived yet: the restart waits
        for node_id in (0, 1):
            dm.store_data(data.parse_report(
                "HangDumpRecord", json.dumps(bundle), node_id=node_id))
        (fact,) = op.infer([])
        assert held == []
        got.append((_summary(first), _summary(fact),
                    ops.rank_stragglers_by_mfu(dm)))
    assert got[0] == got[1]
    summary = got[0][1][1]
    assert summary["stuck_at"].startswith("_ring_step")
    assert summary["pending_programs"] == "jit_train_step"
    assert summary["slowest_node"] == "1"
    assert summary["mfu_ranking"] == "1:0.110,0:0.420"
    assert summary["hang_dump_hosts"] == "2"


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_resolver_summaries(seed):
    _, records = seeded_records(seed)
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        dm = data.DiagnosisDataManager()
        for kind, content, node in records:
            dm.store_data(data.parse_report(kind, content, node_id=node))
        op = ops.ResolveTrainingHangOperator(dm, dump_wait_secs=0.0)
        got.append([_summary(f) for f in op.infer([]) + op.infer([])])
    assert got[0] == got[1]


def test_hang_resolver_without_dumps_keeps_plain_action():
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        op = ops.ResolveTrainingHangOperator(data.DiagnosisDataManager(),
                                             dump_wait_secs=0.0)
        got.append([_summary(f) for f in op.infer([]) + op.infer([])])
    assert got[0] == got[1]
    assert [s[0] for s in got[0]] == ["collect_dumps", "restart_all"]
    assert got[0][1][1]["stuck_at"] is None


def test_hang_resolver_new_episode_discards_stale_dumps():
    got = []
    for data, ops in ((pdata, pops), (jdata, jops)):
        dm = data.DiagnosisDataManager()
        op = ops.ResolveTrainingHangOperator(dm, dump_wait_secs=0.0)
        seen = [_summary(f) for f in op.infer([])]
        old = data.HangDumpRecord(stacks={"1": (
            'Current thread 0x1 (most recent call first):\n'
            '  File "old.py", line 1 in old_wedge\n')})
        old.node_id = 0
        old.timestamp = time.time() - 500.0
        dm.store_data(old)
        op._last_hang_seen = time.time() - 200.0
        op._dump_requested_at = time.time() - 500.0
        seen += [_summary(f) for f in op.infer([]) + op.infer([])]
        got.append(seen)
    assert got[0] == got[1]
    assert [s[0] for s in got[0]] == ["collect_dumps", "collect_dumps",
                                      "restart_all"]
    assert got[0][2][1]["stuck_at"] is None


# -- the stack trie -----------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("main_only", [True, False])
def test_stack_trie_hot_path_and_render(seed, main_only):
    rng = np.random.RandomState(seed)
    dumps = [random_stack(rng, main=bool(rng.rand() < 0.8))
             for _ in range(6)]
    got = []
    for analysis in (panalysis, janalysis):
        trie = analysis.StackTrie()
        for text in dumps:
            trie.add_dump(text, main_only=main_only)
        got.append((trie.hot_path(), trie.render(), trie.render(0.3),
                    trie.total, analysis.parse_faulthandler(dumps[0]),
                    [analysis.is_idle_stack(s) for s in
                     analysis.parse_faulthandler(dumps[1])]))
    assert got[0] == got[1]


def test_load_stacks_from_bundle_and_directory(tmp_path):
    rng = np.random.RandomState(7)
    bundle = {"stacks": {str(i): random_stack(rng) for i in range(3)}}
    path = tmp_path / "bundle.json"
    path.write_text(json.dumps(bundle))
    sdir = tmp_path / "stacks"
    sdir.mkdir()
    for pid, text in bundle["stacks"].items():
        (sdir / f"hang_stacks-{pid}.txt").write_text(text)
    for src in (str(path), str(sdir)):
        p, j = panalysis.load_stacks(src), janalysis.load_stacks(src)
        assert (p.hot_path(), p.render()) == (j.hot_path(), j.render())


# -- the hang dumper and the agent's report ------------------------------------

class _PendingServer:
    """A fixed ``/pending`` endpoint on a free port, standing in for one
    rank's device timer."""

    BODY = {"hang": True, "pending": [{"name": "nccl:AllReduce",
                                       "age_us": 12_000_000}]}

    def __enter__(self):
        body = json.dumps(self.BODY).encode()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def _stuck_worker(package, stack_dir):
    prog = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        from {package}.profiler.hang_dump import install_stack_dump_handler
        install_stack_dump_handler({stack_dir!r})
        def wedged_collective():
            print('READY', flush=True)
            time.sleep(120)
        wedged_collective()
    """)
    p = subprocess.Popen([sys.executable, "-c", prog],
                         stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "READY"
    time.sleep(0.5)  # out of print() and into the sleep
    return p


def _normalised(bundle, pid):
    """A bundle with its pid key and time taken out; each stack parsed to
    its main-thread frames."""
    stacks = bundle["stacks"]
    assert set(stacks) == {str(pid)}
    return {
        "reason": bundle["reason"],
        "stacks": panalysis.parse_faulthandler(stacks[str(pid)],
                                               main_only=True),
        "pending": bundle["pending"],
    }


def test_hang_dumper_bundles_match(tmp_path):
    got = []
    with _PendingServer() as srv:
        for name, dump_mod in (("dlrover_tpu_torch", phang_dump),
                               ("dlrover_tpu", jhang_dump)):
            stack_dir = str(tmp_path / name)
            worker = _stuck_worker(name, stack_dir)
            try:
                dumper = dump_mod.HangDumper(
                    stack_dir, worker_pids=[worker.pid],
                    metrics_ports=[srv.port], settle_secs=1.0)
                bundle = dumper.dump(reason="tpu_timer_hang")
                got.append(_normalised(bundle, worker.pid))
            finally:
                worker.kill()
                worker.wait(timeout=10)
    assert got[0] == got[1]
    assert got[0]["stacks"][0][-1].startswith("wedged_collective")
    assert got[0]["pending"] == {str(srv.port): _PendingServer.BODY}


class _RecordingClient:
    def __init__(self):
        self.records = []

    def report_diagnosis_data(self, kind, payload):
        self.records.append((kind, payload))


def test_report_once_messages_match(tmp_path):
    metrics = {"hang": True, "step_latency_ms": 233.5, "pending": 1,
               "oldest_pending_us": 12_000_000, "execute_total": 40,
               "mfu": 0.2, "device_flops_total": 1.9e15}
    got = []
    with _PendingServer() as srv:
        for name, agent_mod, dump_mod in (
                ("dlrover_tpu_torch", pagent_mod, phang_dump),
                ("dlrover_tpu", jagent_mod, jhang_dump)):
            stack_dir = str(tmp_path / name)
            worker = _stuck_worker(name, stack_dir)
            client = _RecordingClient()
            try:
                agent = agent_mod.DiagnosisAgent(client=client, node_id=3)
                agent.set_log_source(lambda: "step 7 loss 2.5")
                agent.set_metrics_source(lambda: dict(metrics))
                agent.set_hang_dumper(dump_mod.HangDumper(
                    stack_dir, worker_pids=[worker.pid],
                    metrics_ports=[srv.port], settle_secs=1.0))
                agent.report_once()
                agent.report_once()  # the dumper's cooldown: no 2nd dump
                assert agent.collect_and_ship_dump("master_request")
                assert not agent.collect_and_ship_dump("master_request")
            finally:
                worker.kill()
                worker.wait(timeout=10)
            seen = []
            for kind, payload in client.records:
                if kind == "HangDumpRecord":
                    payload = _normalised(json.loads(payload), worker.pid)
                seen.append((kind, payload))
            got.append(seen)
    assert got[0] == got[1]
    assert [k for k, _ in got[0]] == [
        "TrainingLogRecord", "TpuMetricsRecord", "HangDumpRecord",
        "TrainingLogRecord", "TpuMetricsRecord", "HangDumpRecord"]


# -- port only: the cross-node dump orchestration, end to end -----------------

def test_cross_node_dump_orchestration_e2e(tmp_path):
    """Two hosts with wedged worker processes report hang metrics to the
    port's master; the master broadcasts CollectHangDump on the agents'
    status replies; each agent SIGUSR2-dumps its workers and ships the
    bundle; the master's record holds both ranks' stacks and the restart
    names the wedge frame and the slowest node."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.diagnosis.data import DiagnosisDataType
    from dlrover_tpu_torch.master.local_master import start_local_master
    from dlrover_tpu_torch.profiler.hang_dump import HangDumper

    master = start_local_master(node_num=2)
    workers = []
    try:
        agents = {}
        for node_id in range(2):
            stack_dir = str(tmp_path / f"node{node_id}")
            workers.append(_stuck_worker("dlrover_tpu_torch", stack_dir))
            client = MasterClient(f"127.0.0.1:{master.port}",
                                  node_id=node_id)
            agent = pagent_mod.DiagnosisAgent(client=client,
                                              node_id=node_id)
            dumper = HangDumper(stack_dir, worker_pids=[workers[-1].pid],
                                settle_secs=1.0)
            # the cooldown blocks the agent's own dump: the dumps here
            # come only from the master's broadcast
            dumper._last_dump = time.time()
            agent.set_hang_dumper(dumper)
            agents[node_id] = (agent, client)
            client.report_diagnosis_data(
                "TpuMetricsRecord",
                json.dumps({"hang": True, "mfu": 0.05 + 0.1 * node_id}))
        for _, client in agents.values():
            client.report_worker_status(cpu_percent=1.0, memory_mb=1.0)

        master.diagnosis_manager.diagnose_once()
        for node_id, (agent, client) in agents.items():
            resp = client.report_worker_status(cpu_percent=1.0,
                                               memory_mb=1.0)
            kinds = [a.action_cls for a in resp.actions]
            assert "CollectHangDump" in kinds, kinds
            agent.collect_and_ship_dump(reason="master_request")

        dm = master.diagnosis_manager.data_manager
        dumps = dm.latest_per_node(DiagnosisDataType.HANG_DUMP)
        assert set(dumps) == {0, 1}
        for rec in dumps.values():
            assert any("wedged_collective" in text
                       for text in rec.stacks.values()), rec.stacks

        master.diagnosis_manager.diagnose_once()
        ctx = master.container.job_context
        restarts = [a for a in drain(
            lambda i: ctx.next_action(i), [0, 1]) if a[0] == "RestartWorker"]
        assert len(restarts) == 2
        assert all("wedged_collective" in a[1] and "[slowest node 0]" in a[1]
                   for a in restarts), restarts
    finally:
        for p in workers:
            p.kill()
            p.wait(timeout=10)
        master.stop()
