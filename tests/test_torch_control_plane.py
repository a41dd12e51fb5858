"""The port's control plane held to the JAX package's, on the CPU.

(a) Serde: every message class of ``dlrover_tpu.common.messages`` has a port
    class of the same registered name, fields and defaults; a sample of
    each serialises to the same bytes in both packages and decodes in the
    other to an equal object.
(b) Servicer: one scripted request sequence goes, as serde bytes, through
    each package's servicer in process (no transport): node addresses, a
    two-node training rendezvous and each node's comm world, KV set, get,
    add and multi-get, a sync join and finish, heartbeats, the dataset
    messages (params, a task, leases with an ack, a task result, the shard
    checkpoint out and in, the epoch), a failure report (which requeues the
    node's shards), a succeeded report, a global step and a checkpoint
    step. The replies are equal byte for byte (the task managers run on one
    fixed clock, so a lease's deadline is equal too).
(c) ``classify_log`` and ``diagnose_training_failure`` give the JAX answer
    on a sample of every JAX pattern and the stated class on each CUDA
    counterpart; the agent's ``_worker_env`` gives the JAX keys and values
    for the same world and config, the accelerator's value aside.
(d) A two-process gloo ``bootstrap.init()`` from the env ``_worker_env``
    makes: an all-reduce gives the sum.
Also: the port's transport (shedding, a handler's failure, version skew),
and a checkpoint save's step reaching the port's master.
"""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import threading
import typing
import uuid

import pytest
import torch

from dlrover_tpu.agent.config import ElasticLaunchConfig as JaxLaunchConfig
from dlrover_tpu.agent.diagnosis_agent import DiagnosisAgent as JaxDiagnosis
from dlrover_tpu.agent.diagnosis_agent import WorkerFailure as JaxFailure
from dlrover_tpu.agent.elastic_agent import ElasticAgent as JaxAgent
from dlrover_tpu.agent.rendezvous import CommWorld as JaxCommWorld
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.common import serde as jserde
from dlrover_tpu.common.global_context import (
    MasterConfigContext as JaxConfigContext,
)
from dlrover_tpu.diagnosis import operators as joperators
from dlrover_tpu.master.node.job_context import JobContext as JaxJobContext
from dlrover_tpu.master.node.job_manager import (
    LocalJobManager as JaxLocalJobManager,
)
from dlrover_tpu.master.rendezvous import manager as jmanager
from dlrover_tpu.master.rendezvous.kv_store import KVStoreService as JaxKV
from dlrover_tpu.master.rendezvous.sync_service import SyncService as JaxSync
from dlrover_tpu.master.servicer import MasterServicer as JaxServicer
from dlrover_tpu.master.shard.dataset_manager import (
    DatasetShardCheckpoint as JaxShardCheckpoint,
)
from dlrover_tpu.master.shard.task_manager import TaskManager as JaxTaskManager
from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.diagnosis_agent import (
    DiagnosisAgent,
    WorkerAction,
    WorkerFailure,
)
from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent, agent_log_dir
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.rendezvous import CommWorld
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common import serde
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.diagnosis.operators import classify_log
from dlrover_tpu_torch.master.job_container import JobContainer
from dlrover_tpu_torch.master.local_master import start_local_master
from dlrover_tpu_torch.master.node.job_manager import LocalJobManager
from dlrover_tpu_torch.master.rendezvous import manager
from dlrover_tpu_torch.master.rendezvous.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous.sync_service import SyncService
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.rpc import policy
from dlrover_tpu_torch.rpc.transport import RequestGate, RpcClient, RpcError
from dlrover_tpu_torch.rpc.transport import RpcServer
from dlrover_tpu_torch.utils.net import find_free_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = sorted(
    name for name, cls in jserde._REGISTRY.items()
    if cls.__module__ == jmsg.__name__
)
WAIT_S = 60


# -- (a) serde ----------------------------------------------------------------


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def _sample(hint, mod):
    """A value of the field's type, unlike its default, built from the
    package ``mod``'s classes."""
    if hint is int:
        return 7
    if hint is float:
        return 2.5
    if hint is str:
        return "sample"
    if hint is bool:
        return True
    if hint is bytes:
        return b"\x00\x01\xff"
    origin = typing.get_origin(hint) or hint
    args = typing.get_args(hint)
    if origin is dict:
        return {"k": 1, "nested": {"x": [1, 2]}}
    if origin is tuple:
        return (1, 2, 3)
    if origin is list:
        if not args:
            return [1, "two", 3.0]
        inner = args[0]
        if dataclasses.is_dataclass(inner):
            return [_instance(getattr(mod, inner.__name__), mod)]
        return [_sample(inner, mod), _sample(inner, mod)]
    raise AssertionError(f"no sample for {hint}")


def _instance(cls, mod):
    hints = typing.get_type_hints(cls)
    return cls(**{f.name: _sample(hints[f.name], mod)
                  for f in dataclasses.fields(cls)})


def test_every_jax_message_class_is_registered_in_the_port():
    assert len(JAX_NAMES) > 50
    port_names = {name for name, cls in serde._REGISTRY.items()
                  if cls.__module__ == msg.__name__}
    assert set(JAX_NAMES) == port_names


@pytest.mark.parametrize("name", JAX_NAMES)
def test_message_crosses_both_ways(name):
    jcls, pcls = jserde.registered(name), serde.registered(name)
    assert pcls is not None, name
    jfields, pfields = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [f.name for f in jfields] == [f.name for f in pfields]
    assert [_default(f) for f in jfields] == [_default(f) for f in pfields]
    for jobj, pobj in ((jcls(), pcls()), (_instance(jcls, jmsg),
                                          _instance(pcls, msg))):
        wire = jserde.serialize(jobj)
        assert serde.serialize(pobj) == wire
        assert serde.deserialize(wire) == pobj
        assert jserde.deserialize(serde.serialize(pobj)) == jobj


# -- (b) the servicer ---------------------------------------------------------

# the task managers' clock: a lease's deadline is CLOCK_T + its TTL in both
CLOCK_T = 1000.0


def _jax_servicer():
    ctx = JaxJobContext()
    config = JaxConfigContext()
    mgrs = {
        RendezvousName.TRAINING:
            jmanager.ElasticTrainingRendezvousManager(config=config),
        RendezvousName.NETWORK_CHECK:
            jmanager.NetworkCheckRendezvousManager(config=config),
    }
    for m in mgrs.values():
        m.update_rdzv_params(min_nodes=2, max_nodes=2, node_unit=1,
                             waiting_timeout=60)
    jm = JaxLocalJobManager(rdzv_managers=mgrs, job_context=ctx)
    tm = JaxTaskManager(clock=lambda: CLOCK_T, lease_ttl=30.0)
    return JaxServicer(task_manager=tm, job_manager=jm, rdzv_managers=mgrs,
                       kv_store=JaxKV(), sync_service=JaxSync(ctx),
                       job_context=ctx)


def _port_servicer():
    container = JobContainer()
    ctx = container.job_context
    mgrs = {
        RendezvousName.TRAINING: manager.ElasticTrainingRendezvousManager(
            config=container.config),
        RendezvousName.NETWORK_CHECK: manager.NetworkCheckRendezvousManager(
            config=container.config),
    }
    for m in mgrs.values():
        m.update_rdzv_params(min_nodes=2, max_nodes=2, node_unit=1,
                             waiting_timeout=60)
    pm = LocalJobManager(rdzv_managers=mgrs, job_context=ctx)
    tm = TaskManager(clock=lambda: CLOCK_T, lease_ttl=30.0)
    return MasterServicer(task_manager=tm, job_manager=pm,
                          rdzv_managers=mgrs,
                          kv_store=KVStoreService(),
                          sync_service=SyncService(ctx),
                          job_context=ctx), ctx


def _script():
    """(kind, request) pairs, built from the JAX package's classes."""
    m = jmsg
    seq = []
    for node in (0, 1):
        seq.append(("report", m.NodeAddressReport(
            node_type="worker", node_id=node, addr=f"10.0.0.{node + 1}")))
    for node in (0, 1):
        seq.append(("get", m.JoinRendezvousRequest(
            node_id=node, node_rank=node, local_world_size=2,
            rdzv_name="training", node_ip=f"10.0.0.{node + 1}",
            node_port=29500 + node)))
    seq.append(("get", m.NumNodesWaitingRequest(rdzv_name="training")))
    for node in (0, 1):
        seq.append(("get", m.CommWorldRequest(node_id=node,
                                              rdzv_name="training")))
    seq += [
        ("get", m.NumNodesWaitingRequest(rdzv_name="training")),
        ("get", m.RunningNodesRequest()),
        ("report", m.KVStoreSet(key="a", value=b"alpha")),
        ("get", m.KVStoreGet(key="a")),
        ("get", m.KVStoreGet(key="missing")),
        ("get", m.KVStoreAdd(key="n", amount=3)),
        ("get", m.KVStoreAdd(key="n", amount=4)),
        ("get", m.KVStoreMultiGet(keys=["a", "n", "missing"])),
        ("report", m.SyncJoin(sync_name="s", node_id=0, node_rank=0)),
        ("get", m.SyncQuery(sync_name="s")),
        ("report", m.SyncJoin(sync_name="s", node_id=1, node_rank=1)),
        ("get", m.SyncQuery(sync_name="s")),
        ("report", m.SyncFinish(sync_name="t")),
        ("get", m.SyncQuery(sync_name="t")),
        ("report", m.HeartbeatReport(node_type="worker", node_id=0,
                                     timestamp=1000.0)),
        ("report", m.WorkerReport(node_type="worker", node_id=1,
                                  timestamp=1000.0, step=3,
                                  has_resource=True, cpu_percent=0.5,
                                  memory_mb=100.0, tpu_hbm_used_mb=2048.0)),
        # the data plane: a dataset, a task, two leases (the second acks
        # one shard under the first's fence), a task result, the shard
        # checkpoint out and in, the epoch; a request for an unknown
        # dataset
        ("report", m.DatasetShardParams(dataset_name="ds", dataset_size=50,
                                        shard_size=10, num_epochs=2)),
        ("get", m.TaskRequest(dataset_name="ds", node_id=0)),
        ("get", m.ShardLeaseRequest(dataset_name="ds", node_id=1, count=2)),
        ("get", m.ShardLeaseRequest(dataset_name="ds", node_id=1, count=1,
                                    done_task_ids=[1], lease_epoch=1)),
        ("report", m.TaskResult(dataset_name="ds", task_id=0, node_id=0)),
        ("report", m.TaskResult(dataset_name="ds", task_id=0, node_id=0)),
        ("get", m.ShardCheckpointRequest(dataset_name="ds")),
        ("get", m.DatasetEpochRequest(dataset_name="ds")),
        ("get", m.TaskRequest(dataset_name="none", node_id=0)),
        ("get", m.ShardCheckpointRequest(dataset_name="none")),
        ("report", m.WorkerReport(node_type="worker", node_id=1,
                                  timestamp=1000.5, step=4)),
        ("report", m.GlobalStepReport(node_id=0, step=5, timestamp=1001.0)),
        ("report", m.CheckpointStepReport(node_id=0, step=4,
                                          blocking_s=0.02)),
        ("report", m.NodeFailureReport(
            node_type="worker", node_id=1, restart_count=0,
            error_data="Traceback (most recent call last):", exit_code=1,
            timestamp=1002.0)),
        ("get", m.NumNodesWaitingRequest(rdzv_name="training")),
        # node 1's failure requeued the shards it held
        ("get", m.ShardCheckpointRequest(dataset_name="ds")),
        ("report", m.ShardCheckpointReport(
            dataset_name="ds", content=JaxShardCheckpoint(
                dataset_name="ds", todo=[[20, 30], [40, 50]], epoch=1,
                completed_records=30, task_id_seq=7).to_json())),
        ("get", m.ShardLeaseRequest(dataset_name="ds", node_id=0, count=5)),
        ("get", m.DatasetEpochRequest(dataset_name="ds")),
        ("report", m.SucceededReport(node_type="worker", node_id=0)),
        ("get", m.RunningNodesRequest()),
        ("get", m.TrainingStatusRequest()),
        ("get", m.ElasticRunConfigRequest()),
        ("get", m.PreCheckRequest(node_id=0)),
    ]
    return seq


def test_servicer_replies_match_jax():
    jax_side = _jax_servicer()
    port_side, ctx = _port_servicer()
    script = _script()
    for i, (kind, request) in enumerate(script):
        wire = jserde.serialize(request)
        jfn = jax_side.get if kind == "get" else jax_side.report
        pfn = port_side.get if kind == "get" else port_side.report
        jreply = jserde.serialize(jfn(jserde.deserialize(wire)))
        preply = serde.serialize(pfn(serde.deserialize(wire)))
        assert preply == jreply, (i, type(request).__name__, preply, jreply)
    # the comm world was formed, and the port's master holds the step
    world = port_side.get(msg.CommWorldRequest(node_id=0))
    assert world.completed and world.coordinator_addr == "10.0.0.1:29500"
    assert ctx.ckpt_steps() == {0: 4}


# -- (c) classification and the worker env -----------------------------------

# one sample per JAX pattern, in the order of the tuples
JAX_SAMPLES = [
    "Traceback (most recent call last):\n  File 'x.py'",
    "Fatal Python error: Aborted",
    "jaxlib.xla_extension.XlaRuntimeError: INTERNAL: failed",
    "JAX distributed service detected fatal errors; shutting down",
    "The coordination service says another task died",
    "leader task was preempted",
    "Failed to send RPC to coordination service",
    "RESOURCE_EXHAUSTED: out of memory allocating 4GB",
    "UNAVAILABLE: connection reset",
    "coordination service heartbeat timed out",
    "worker got SIGTERM (preemption notice)",
    "ici link down on chip 3",
    "hbm uncorrectable error at 0x10",
    "",
    "step 2 loss 5.54",
]
# the CUDA counterparts, with the class each must get
CUDA_SAMPLES = [
    ("RuntimeError: [../third_party/gloo/gloo/transport/tcp/pair.cc:534] "
     "Connection closed by peer [127.0.0.1]:41377", "retryable"),
    ("torch.distributed.DistBackendError: NCCL communicator was aborted on "
     "rank 1.", "retryable"),
    ("Traceback (most recent call last):\n  ...\nRuntimeError: [gloo] "
     "Connection closed by peer", "retryable"),
    ("RuntimeError: CUDA error: uncorrectable ECC error encountered",
     "hardware"),
    ("NVRM: Xid (PCI:0000:18:00): 79, pid=1234, GPU has fallen off the bus.",
     "hardware"),
    ("RuntimeError: CUDA error: GPU has fallen off the bus", "hardware"),
]


@pytest.mark.parametrize("text", JAX_SAMPLES)
def test_classification_matches_jax(text):
    assert classify_log(text) == joperators.classify_log(text)
    for restarts, budget in ((0, 1), (1, 1), (2, 3)):
        want = JaxDiagnosis().diagnose_training_failure(JaxFailure(
            node_id=0, restart_count=restarts, max_restarts=budget,
            log_tail=text))
        got = DiagnosisAgent().diagnose_training_failure(WorkerFailure(
            node_id=0, restart_count=restarts, max_restarts=budget,
            log_tail=text))
        assert got == want


def test_every_jax_pattern_has_a_sample():
    for pats in (joperators.FATAL_PATTERNS, joperators.PEER_FAILURE_PATTERNS,
                 joperators.RETRYABLE_PATTERNS,
                 joperators.HARDWARE_PATTERNS):
        for pat in pats:
            assert any(re.search(pat, s, re.IGNORECASE)
                       for s in JAX_SAMPLES), pat


@pytest.mark.parametrize("text,kind", CUDA_SAMPLES)
def test_cuda_failures_get_their_class(text, kind):
    assert classify_log(text) == kind
    action = DiagnosisAgent().diagnose_training_failure(WorkerFailure(
        node_id=0, restart_count=0, max_restarts=1, log_tail=text))
    assert action == (WorkerAction.RELAUNCH_WORKER if kind == "hardware"
                      else WorkerAction.RESTART_WORKER)


class _StubClient:
    master_addr = "127.0.0.1:50051"
    node_id = 0


@pytest.fixture
def job_name():
    name = f"torch-cp-{uuid.uuid4().hex[:10]}"
    yield name
    shutil.rmtree(os.path.dirname(agent_log_dir(name, 0)),
                  ignore_errors=True)


def _worlds(coordinator):
    common = dict(rdzv_round=3, group=0, node_rank=1, world_size=2,
                  num_processes=4, process_id_base=2,
                  coordinator_addr=coordinator,
                  members={0: (5, 2, "10.0.0.1", 29500),
                           1: (0, 2, "10.0.0.2", 29501)},
                  slice_names={0: "", 1: ""})
    return JaxCommWorld(**common), CommWorld(**common)


def test_worker_env_matches_jax(job_name):
    common = dict(node_id=0, job_name=job_name, nproc_per_node=2,
                  max_restarts=2, entrypoint="train.py")
    jagent = JaxAgent(JaxLaunchConfig(accelerator="cpu", **common),
                      client=_StubClient())
    pagent = ElasticAgent(ElasticLaunchConfig(accelerator="cuda", **common),
                          client=_StubClient())
    jworld, pworld = _worlds("10.0.0.1:29500")
    for local_rank in (0, 1):
        want = jagent._worker_env(jworld, local_rank)
        got = pagent._worker_env(pworld, local_rank)
        assert sorted(got) == sorted(want)
        diff = {k for k in want if got[k] != want[k]}
        assert diff == {"DLROVER_TPU_ACCELERATOR"}, diff
        assert (want["DLROVER_TPU_ACCELERATOR"],
                got["DLROVER_TPU_ACCELERATOR"]) == ("cpu", "cuda")
        assert got["DLROVER_TPU_PROCESS_ID"] == str(2 + local_rank)


# -- (d) a two-process gloo world ---------------------------------------------

BOOTSTRAP = """\
import torch, torch.distributed as dist
from dlrover_tpu_torch.train import bootstrap
ctx = bootstrap.init()
assert dist.is_initialized() and dist.get_backend() == "gloo"
t = torch.tensor([float(ctx.process_id + 1)])
dist.all_reduce(t)
print("SUM", ctx.process_id, dist.get_world_size(), t.item(), flush=True)
"""


def test_two_process_gloo_bootstrap(job_name):
    agent = ElasticAgent(ElasticLaunchConfig(
        node_id=0, job_name=job_name, nproc_per_node=2, accelerator="cpu"),
        client=_StubClient())
    world = CommWorld(rdzv_round=1, node_rank=0, world_size=1,
                      num_processes=2, process_id_base=0,
                      coordinator_addr=f"127.0.0.1:{find_free_port()}",
                      members={0: (0, 2, "127.0.0.1", 0)})
    procs = []
    for local_rank in (0, 1):
        env = agent._worker_env(world, local_rank)
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", BOOTSTRAP], cwd=REPO_ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=WAIT_S)
        finally:
            p.kill()
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    sums = sorted(line.split()[1:] for out in outs
                  for line in out.splitlines() if line.startswith("SUM"))
    assert sums == [["0", "2", "3.0"], ["1", "2", "3.0"]]


# -- the transport ------------------------------------------------------------


class _EchoServicer:
    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def get(self, request, context=None):
        if isinstance(request, msg.KVStoreGet) and request.key == "block":
            self.entered.set()
            self.release.wait(WAIT_S)
        if isinstance(request, msg.KVStoreGet) and request.key == "raise":
            raise ValueError("handler failed")
        return msg.KVStoreResponse(found=True, value=request.key.encode())

    def report(self, request, context=None):
        return msg.SimpleResponse(reason=type(request).__name__)


def test_transport_round_trip_shed_and_errors():
    servicer = _EchoServicer()
    server = RpcServer(servicer, port=0,
                       gate=RequestGate(report_cap=1, get_cap=1))
    server.start()
    try:
        client = RpcClient(f"127.0.0.1:{server.port}", node_id=3)
        assert client.available(timeout=10)
        assert client.get(msg.KVStoreGet(key="x")).value == b"x"
        assert client.report(msg.SyncFinish()).reason == "SyncFinish"
        # a handler that raised: INTERNAL, classified application, not
        # retried
        with pytest.raises(RpcError) as e:
            client.get(msg.KVStoreGet(key="raise"), retries=3)
        assert policy.classify(e.value) == policy.APPLICATION
        # the get cap is full while one get blocks: the next is shed
        blocker = threading.Thread(
            target=client.get, args=(msg.KVStoreGet(key="block"),),
            daemon=True)
        blocker.start()
        assert servicer.entered.wait(WAIT_S)
        with pytest.raises(policy.OverloadedError):
            client.get(msg.KVStoreGet(key="y"), on_overload="raise")
        assert server.gate.recently_shed(3, window_s=60)
        servicer.release.set()
        blocker.join(WAIT_S)
        assert not blocker.is_alive()
        # an unknown message type: the typed skew reply
        raw = RpcClient(f"127.0.0.1:{server.port}")._post(
            "/dlrover_tpu.Master/get", b'{"_t":"NoSuchMessage"}', 10)
        reply = serde.deserialize(raw)
        assert not reply.success and "NoSuchMessage" in reply.reason
    finally:
        servicer.release.set()
        server.stop(grace=5)
    # a stopped server is unavailable
    assert policy.classify(ConnectionRefusedError()) == policy.UNAVAILABLE
    assert not RpcClient(f"127.0.0.1:{server.port}").available(timeout=0.3)


def test_master_client_kv_store_over_the_transport():
    """The agent's master client against a running port master: the KV
    store's set, get, add and multi calls over HTTP."""
    master = start_local_master(node_num=1)
    try:
        client = MasterClient(f"127.0.0.1:{master.port}", node_id=0)
        assert client.available(timeout=10)
        client.kv_store_set("a", b"alpha")
        assert client.kv_store_get("a") == b"alpha"
        assert client.kv_store_get("missing") == b""
        assert client.kv_store_add("n", 3) == 3
        assert client.kv_store_add("n", 4) == 7
        client.kv_store_multi_set({"b": b"beta", "c": b"\x00\xff"})
        assert client.kv_store_multi_get(["a", "b", "c", "n", "x"]) == {
            "a": b"alpha", "b": b"beta", "c": b"\x00\xff", "n": b"7",
            "x": b""}
    finally:
        master.stop()


# -- the engine's save report -------------------------------------------------


@pytest.mark.parametrize("async_staging", [True, False])
def test_checkpoint_save_reaches_the_master(tmp_path, async_staging):
    name = f"torch-cp-{uuid.uuid4().hex[:10]}"
    master = start_local_master(node_num=1)
    try:
        client = MasterClient(f"127.0.0.1:{master.port}", node_id=0)
        engine = CheckpointEngine(
            str(tmp_path / "ckpt"), job_name=name, node_id=0, process_id=0,
            async_staging=async_staging, master_client=client)
        try:
            state = {"step": 3, "w": torch.arange(16, dtype=torch.float32)}
            engine.save_to_memory(3, state)
            engine.wait_staging(timeout=WAIT_S)
            assert master.container.job_context.ckpt_steps() == {0: 3}
            state["step"] = 5
            engine.save_to_storage(5, state)
            engine.wait_staging(timeout=WAIT_S)
            assert master.container.job_context.ckpt_steps() == {0: 5}
        finally:
            engine.close()
    finally:
        master.stop()
        h = SharedMemoryHandler(shm_name(name, 0, 0))
        if h.attach():
            h.close(unlink=True)
