"""Flash checkpoint's agent side across the two packages, on the CPU.

The port's ``common/ipc.py``, ``checkpoint/saver.py::AsyncCheckpointSaver``
and ``checkpoint/replica.py`` against the JAX package's: one socket path,
one JSON protocol, one event dict, one back-pressure key and one replica
wire, so a trainer of either package works under a saver of either
package. Also: the persist back-pressure, the breakpoint persist's refusal
of a segment it cannot lock, the save-at-breakpoint of a SIGKILLed
trainer, replicas on loopback, and a host-gather stage whose shm lock is
taken in one thread and released in another.

Every test uses its own short job name (a unix socket path holds at most
107 bytes), unlinks the job's segments and removes its socket directory
at teardown; every wait has a timeout and every server thread is a daemon.
"""

import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import uuid

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import replica as jreplica
from dlrover_tpu.checkpoint import saver as jsaver
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm
from dlrover_tpu.common import ipc as jipc
from dlrover_tpu_torch.checkpoint import replica, saver
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    as_bytes,
    flatten_state,
    shm_name,
)
from dlrover_tpu_torch.common import ipc
from dlrover_tpu_torch.common.storage import KeepLatestStepStrategy
from dlrover_tpu_torch.models.convert import train_state_to_numpy
from dlrover_tpu_torch.run import llama_pretrain

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 30.0


@pytest.fixture
def job(tmp_path, monkeypatch):
    """A job name of this test's own and a checkpoint dir; the job's
    segments and socket directory removed at teardown."""
    name = f"ag-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.delenv("DLROVER_TPU_CKPT_LOCAL_DIR", raising=False)
    monkeypatch.delenv("DLROVER_TPU_CKPT_REPLICA", raising=False)
    yield name, str(tmp_path / "ckpt")
    for node in range(4):
        h = SharedMemoryHandler(shm_name(name, node, 0))
        if h.attach():
            h.close(unlink=True)
    shutil.rmtree(f"/tmp/dlrover_tpu/{name}", ignore_errors=True)


def _wait_for(cond, what, timeout=WAIT_S):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _small_states():
    """One state in both packages: f32, bf16 (through its bits) and an
    int32 scalar."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    v = rng.integers(-2**15, 2**15, (16,)).astype(np.int16)
    jstate = {"step": jnp.asarray(7, jnp.int32),
              "v": jnp.asarray(v.view(ml_dtypes.bfloat16)),
              "w": jnp.asarray(w)}
    tstate = {"step": 7, "v": torch.from_numpy(v.copy()).view(torch.bfloat16),
              "w": torch.from_numpy(w.copy())}
    return jstate, tstate


def _zeroed_targets():
    jstate, tstate = _small_states()
    jt = {k: jnp.zeros_like(v) for k, v in jstate.items()}
    tt = {"step": 0, "v": torch.zeros_like(tstate["v"]),
          "w": torch.zeros_like(tstate["w"])}
    return jt, tt


def _port_bytes(state):
    return {leaf.name: as_bytes(leaf.value).numpy().tobytes()
            for leaf in flatten_state(state)}


def _jax_bytes(state):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v).tobytes()
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


# -- the wire -----------------------------------------------------------------


def test_wire_names_match_jax(job):
    """The names and dicts both packages' savers and engines meet on."""
    name, _ = job
    assert ipc.default_socket_path(name, 3) == jipc.default_socket_path(
        name, 3) == f"/tmp/dlrover_tpu/{name}/node-3/ipc.sock"
    for attr in ("CKPT_EVENT_QUEUE", "SHM_LOCK", "PERSIST_STATE_DICT",
                 "TRACKER_FILE"):
        assert getattr(saver, attr) == getattr(jsaver, attr), attr
    for kwargs in ({"event_type": "save", "step": 4, "persist": True,
                    "ckpt_dir": "/c"}, {"event_type": "backup", "step": 2},
                   {"event_type": "exit"}):
        wire = saver.CheckpointEvent(**kwargs).to_wire()
        assert wire == jsaver.CheckpointEvent(**kwargs).to_wire()
        assert jsaver.CheckpointEvent.from_wire(wire) == \
            jsaver.CheckpointEvent(**kwargs)
        assert saver.CheckpointEvent.from_wire(wire) == \
            saver.CheckpointEvent(**kwargs)
    assert saver.persist_mark(5) == "copied-5"


def _ipc_transcript(mod, path):
    """Queue, lock and dict operations through ``mod``'s clients; returns
    what each answered."""
    out = []
    q = mod.SharedQueue("q", path)
    q.put({"step": 5, "persist": True})
    q.put([1, "two"])
    out += [q.qsize(), q.get(timeout=1), q.get(timeout=1)]
    try:
        q.get(timeout=0.05)
        out.append("value")
    except queue.Empty:
        out.append("empty")
    a = mod.SharedLock("lk", path, owner="a")
    b = mod.SharedLock("lk", path, owner="b")
    out += [a.acquire(timeout=1), a.locked(), b.acquire(blocking=False),
            a.release(), b.acquire(blocking=False), b.release(),
            b.release()]
    d = mod.SharedDict("d", path)
    d.set("copied-0", 3)
    d.set("k", {"x": [1, 2]})
    out += [d.get("copied-0"), d.get("missing"), d.get(), d.pop("k"),
            d.get()]
    for client in (q, a, b, d):
        client.close()
    return out


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_ipc_clients_of_both_packages_agree(server_pkg, job):
    """Against one package's IpcServer, the port's clients and the JAX
    package's give the same answers, the expected ones."""
    name, _ = job
    mod = ipc if server_pkg == "port" else jipc
    # the JAX package's default_socket_path makes the directory
    path = mod.default_socket_path(name, 0)
    server = mod.IpcServer(path)
    server.start()
    try:
        port = _ipc_transcript(ipc, path)
        jax_ = _ipc_transcript(jipc, path)
    finally:
        server.stop()
    assert port == jax_
    assert port == [2, {"step": 5, "persist": True}, [1, "two"], "empty",
                    True, True, False, True, True, True, False,
                    3, None, {"copied-0": 3, "k": {"x": [1, 2]}},
                    {"x": [1, 2]}, {"copied-0": 3}]
    assert not os.path.exists(path)


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_lock_of_a_killed_client_is_released(server_pkg, job):
    """A port client process takes the lock and is SIGKILLed holding it:
    the server releases it, so another client gets it."""
    name, _ = job
    mod = ipc if server_pkg == "port" else jipc
    # the JAX package's default_socket_path makes the directory
    path = mod.default_socket_path(name, 0)
    server = mod.IpcServer(path)
    server.start()
    code = ("import os, signal, sys\n"
            "from dlrover_tpu_torch.common.ipc import SharedLock\n"
            "lock = SharedLock('shm-ckpt-lock', sys.argv[1],"
            " connect_timeout=5)\n"
            "assert lock.acquire(timeout=5)\n"
            "print('HELD', flush=True)\n"
            "os.kill(os.getpid(), signal.SIGKILL)\n")
    try:
        out = subprocess.run([sys.executable, "-c", code, path],
                             cwd=REPO_ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == -signal.SIGKILL, out.stderr
        assert out.stdout.strip() == "HELD"
        other = ipc.SharedLock(saver.SHM_LOCK, path, connect_timeout=5)
        assert other.acquire(timeout=10), "the dead client's lock was kept"
        assert other.release()
        other.close()
    finally:
        server.stop()


def test_missing_server_fails_within_connect_timeout(job):
    """A client whose server is gone raises after its connect timeout
    instead of hanging."""
    name, _ = job
    q = ipc.SharedQueue("q", ipc.default_socket_path(name, 0),
                        connect_timeout=0.3)
    t0 = time.time()
    with pytest.raises(FileNotFoundError):
        q.put(1)
    assert time.time() - t0 < 5


# -- savers across the packages -----------------------------------------------


@pytest.mark.parametrize("direction", ["port_engine-jax_saver",
                                       "jax_engine-port_saver"])
@pytest.mark.parametrize("persist", ["event", "breakpoint"])
def test_saver_persists_the_other_package(direction, persist, job):
    """One package's engine under the other package's saver. event: a
    storage save queues a persist event, which the saver commits.
    breakpoint: a memory save, then the saver's save_shm_to_storage.
    Either way the committed step, with the segment unlinked, restores
    from disk bitwise in both packages."""
    name, ckpt_dir = job
    jstate, tstate = _small_states()
    kw = dict(job_name=name, node_id=0, process_id=0)
    if direction == "port_engine-jax_saver":
        host = jsaver.AsyncCheckpointSaver(job_name=name, node_id=0)
        eng = CheckpointEngine(ckpt_dir, **kw)
        state = tstate
    else:
        host = AsyncCheckpointSaver(job_name=name, node_id=0)
        eng = JaxEngine(ckpt_dir, **kw)
        state = jstate
    host.start()
    try:
        if persist == "event":
            eng.save_to_storage(3, state)
            eng.wait_staging()
            if direction == "port_engine-jax_saver":
                assert eng.last_stage_stats["persist"] == "queued"
            _wait_for(lambda: eng.committed_step() == 3, "the commit")
        else:
            eng.save_to_memory(3, state)
            eng.wait_staging()
            assert eng.committed_step() == -1
            assert host.save_shm_to_storage(ckpt_dir)
            assert eng.committed_step() == 3
    finally:
        eng.close(unlink_shm=True)
        host.stop()
    want = _jax_bytes(jstate)
    jt, tt = _zeroed_targets()
    for reader, target, to_bytes in (
            (CheckpointEngine(ckpt_dir, **kw), tt, _port_bytes),
            (JaxEngine(ckpt_dir, **kw), jt, _jax_bytes)):
        try:
            step, restored = reader.load(target=target)
            assert step == 3
            assert reader.last_restore_stats["tier"] == "disk"
            assert to_bytes(restored) == want
        finally:
            reader.close(unlink_shm=True)


# -- back-pressure and the breakpoint's lock ----------------------------------


def _filled(value, n=4096):
    return {"step": int(value), "w": torch.full((n,), float(value))}


def test_back_pressure_holds_the_next_stage(job, monkeypatch):
    """While the saver has not copied a queued persist, the next stage does
    not touch the segment, though the shm lock is free: it waits for
    ``copied-<pid>``, then stages. The persisted step holds its own
    values."""
    name, ckpt_dir = job
    host = AsyncCheckpointSaver(job_name=name, node_id=0)
    gate = threading.Event()
    real_persist = host._persist

    def held_persist(event):
        # the event is taken, the lock not yet
        assert gate.wait(timeout=WAIT_S)
        return real_persist(event)

    monkeypatch.setattr(host, "_persist", held_persist)
    host.start()
    eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0, process_id=0)
    probe = SharedMemoryHandler(shm_name(name, 0, 0))
    try:
        eng.save_to_storage(1, _filled(1))
        eng.wait_staging()
        eng.save_to_memory(2, _filled(2))
        time.sleep(0.5)
        assert eng._staging_thread.is_alive()
        assert probe.read_meta().step == 1
        gate.set()
        eng.wait_staging(timeout=WAIT_S)
        stats = eng.last_stage_stats
        assert stats["step"] == 2 and stats["wait_s"] >= 0.4
        assert probe.read_meta().step == 2
        # the saver logs a persist once it has ended, commit included
        _wait_for(lambda: len(host.persist_log) == 1, "the saver's persist")
        assert host.persist_log[0]["steps"] == [1]
        assert eng.committed_step() == 1
    finally:
        gate.set()
        probe.close()
        eng.close(unlink_shm=True)
        host.stop()
    reader = CheckpointEngine(ckpt_dir, job_name=name, node_id=0,
                              process_id=0)
    try:
        target = _filled(0)
        step, restored = reader.load(target=target)
        assert step == 1 and reader.last_restore_stats["tier"] == "disk"
        assert torch.equal(restored["w"], _filled(1)["w"])
        assert restored["step"] == 1
    finally:
        reader.close(unlink_shm=True)


def test_update_topology_clears_stale_marks(job):
    """A rendezvous round is a restart boundary: the saver drops every
    ``copied-<pid>`` mark and takes the new topology."""
    name, _ = job
    host = AsyncCheckpointSaver(job_name=name, node_id=0)
    host.start()
    marks = ipc.SharedDict(saver.PERSIST_STATE_DICT, host.socket_path,
                           connect_timeout=5)
    try:
        marks.set("copied-0", 9)
        marks.set("copied-1", 9)
        host.update_topology(node_rank=1, num_nodes=2, process_ids=[0, 1])
        assert marks.get() == {}
        assert (host.persister.node_rank, host.persister.num_nodes,
                host.persister.local_process_ids) == (1, 2, [0, 1])
    finally:
        marks.close()
        host.stop()


def test_breakpoint_refuses_a_segment_it_cannot_lock(job, monkeypatch):
    """With the shm lock held elsewhere past the breakpoint's wait, the
    saver persists nothing and returns False; once it is free, the same
    call persists the staged step."""
    name, ckpt_dir = job
    monkeypatch.setattr(AsyncCheckpointSaver, "BREAKPOINT_LOCK_TIMEOUT", 0.3)
    host = AsyncCheckpointSaver(job_name=name, node_id=0)
    host.start()
    eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0, process_id=0)
    holder = ipc.SharedLock(saver.SHM_LOCK, host.socket_path,
                            connect_timeout=5)
    try:
        eng.save_to_memory(4, _filled(4))
        eng.wait_staging()
        assert holder.acquire(timeout=5)
        t0 = time.time()
        assert host.save_shm_to_storage(ckpt_dir) is False
        assert time.time() - t0 < 5
        assert eng.committed_step() == -1
        assert holder.release()
        assert host.save_shm_to_storage(ckpt_dir) is True
        assert eng.committed_step() == 4
    finally:
        holder.close()
        eng.close(unlink_shm=True)
        host.stop()


# -- save at breakpoint after a hard kill -------------------------------------


def test_breakpoint_persists_a_hard_killed_trainer(job):
    """run/llama_pretrain.py (tiny Llama, CPU) stages steps 1-2 to memory
    under a port saver and is SIGKILLed; the saver persists step 2 at the
    breakpoint; with the segment unlinked, a restore reads step 2 from
    disk with every leaf's bytes equal to what the killed process staged."""
    name, ckpt_dir = job
    host = AsyncCheckpointSaver(job_name=name, node_id=0)
    host.start()
    common = ["--device", "cpu", "--model", "tiny", "--seed", "0"]
    code = ("import sys, time\n"
            "from dlrover_tpu_torch.run import llama_pretrain\n"
            "llama_pretrain.main(sys.argv[1:])\n"
            "print('STAGED', flush=True)\n"
            "time.sleep(120)\n")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, *common, "--steps", "2",
             "--ckpt-dir", ckpt_dir, "--save-every", "0"],
            cwd=REPO_ROOT, env=dict(os.environ, DLROVER_TPU_JOB_NAME=name),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        timer = threading.Timer(120, proc.kill)
        timer.start()
        lines = []
        try:
            for line in iter(proc.stdout.readline, ""):
                lines.append(line.strip())
                if line.startswith("STAGED"):
                    proc.send_signal(signal.SIGKILL)
        finally:
            timer.cancel()
            proc.kill()
            proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL, lines
        seg = SharedMemoryHandler(shm_name(name, 0, 0))
        try:
            meta = seg.read_meta()
            assert meta.step == 2
            staged = {m.path.rsplit("#", 1)[0]:
                      seg.leaf_bytes(m).numpy().tobytes()
                      for m in meta.leaves}
        finally:
            seg.close()
        assert host.save_shm_to_storage(ckpt_dir) is True
        assert host.persister.committed_step(ckpt_dir) == 2
    finally:
        host.stop()
    h = SharedMemoryHandler(shm_name(name, 0, 0))
    assert h.attach()
    h.close(unlink=True)
    args = llama_pretrain.parse_args(
        [*common, "--steps", "2", "--ckpt-dir", ckpt_dir, "--save-every",
         "0"])
    _, _, state, next_batch, _ = llama_pretrain.build(args)
    ckpt, start, restore = llama_pretrain.open_checkpoint(
        args, state, next_batch, log=lambda m: None)
    try:
        assert start == 2
        assert restore["step"] == 2 and restore["tier"] == "disk"
        got = train_state_to_numpy(state)
        assert sorted(got) == sorted(staged)
        for leaf_name, data in staged.items():
            assert got[leaf_name].tobytes() == data, leaf_name
    finally:
        ckpt.close(unlink_shm=True)


# -- replicas -----------------------------------------------------------------


def _set_peers(savers_by_rank, token):
    peers = {r: ("127.0.0.1", s.replica_port)
             for r, s in savers_by_rank.items()}
    for r, s in savers_by_rank.items():
        s.update_replica_peers(peers, self_rank=r, world=len(peers))
        s.set_replica_token(token)


def test_replica_roundtrip_between_port_savers(job, monkeypatch):
    """Node 0's engine stages under DLROVER_TPU_CKPT_REPLICA=1; its saver
    pushes the segment to node 1's. The host dies (its segment is gone);
    a replacement with a new node id in seat 0 fetches the backup into its
    own segment and restores from shm, bitwise. Every request needs the
    token."""
    name, ckpt_dir = job
    monkeypatch.setenv("DLROVER_TPU_CKPT_REPLICA", "1")
    s0 = AsyncCheckpointSaver(job_name=name, node_id=0, replica=True)
    s1 = AsyncCheckpointSaver(job_name=name, node_id=1, replica=True)
    s2 = AsyncCheckpointSaver(job_name=name, node_id=2, replica=True)
    for s in (s0, s1, s2):
        s.start()
    try:
        # no token set yet: refused
        resp, _ = replica._rpc(("127.0.0.1", s1.replica_port),
                               {"op": "get", "token": "", "owner_rank": 0})
        assert resp == {"ok": False, "error": "unauthorized"}
        _set_peers({0: s0, 1: s1}, "tok")
        _, tstate = _small_states()
        eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0,
                               process_id=0)
        eng.save_to_memory(5, tstate)
        eng.wait_staging()
        _wait_for(lambda: s1.replica_manager.server.stored_steps() == {0: 5},
                  "the backup")
        resp, _ = replica._rpc(("127.0.0.1", s1.replica_port),
                               {"op": "get", "token": "wrong",
                                "owner_rank": 0})
        assert resp == {"ok": False, "error": "unauthorized"}
        eng.close(unlink_shm=True)
        assert not SharedMemoryHandler(shm_name(name, 0, 0)).attach()
        # the replacement host: node id 2, seat (rank) 0
        _set_peers({0: s2, 1: s1}, "tok")
        assert s2.maybe_fetch_replica() == 5
        assert s2.maybe_fetch_replica() == -1  # staged locally now
        reader = CheckpointEngine(ckpt_dir, job_name=name, node_id=2,
                                  process_id=0)
        try:
            step, restored = reader.load(target=_zeroed_targets()[1])
            assert step == 5 and reader.last_restore_stats["tier"] == "shm"
            assert _port_bytes(restored) == _port_bytes(tstate)
        finally:
            reader.close(unlink_shm=True)
    finally:
        for s in (s0, s1, s2):
            s.stop()


@pytest.mark.parametrize("manager_pkg", ["port", "jax"])
def test_replica_manager_against_the_other_package(manager_pkg, job):
    """One package's ReplicaManager pushes a staged segment to the other
    package's ReplicaServer and fetches it back under a replacement node's
    name; the port's engine restores it bitwise."""
    name, ckpt_dir = job
    _, tstate = _small_states()
    eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0, process_id=0)
    eng.save_to_memory(21, tstate)
    eng.wait_staging()
    own, other = (replica, jreplica) if manager_pkg == "port" else (
        jreplica, replica)
    handler_cls = SharedMemoryHandler if manager_pkg == "port" else JaxShm
    m0, m1 = own.ReplicaManager(), other.ReplicaManager()
    try:
        peers = {0: ("127.0.0.1", m0.port), 1: ("127.0.0.1", m1.port)}
        m0.update_peers(peers, self_rank=0, world=2)
        m1.update_peers(peers, self_rank=1, world=2)
        for m in (m0, m1):
            m.set_token("secret")
        h = handler_cls(shm_name(name, 0, 0))
        try:
            assert m0.push_backup([h])
        finally:
            h.close()
        assert m1.server.stored_steps() == {0: 21}
        eng.close(unlink_shm=True)
        assert m0.fetch_backup_into_shm([shm_name(name, 2, 0)]) == 21
        reader = CheckpointEngine(ckpt_dir, job_name=name, node_id=2,
                                  process_id=0)
        try:
            step, restored = reader.load(target=_zeroed_targets()[1])
            assert step == 21 and reader.last_restore_stats["tier"] == "shm"
            assert _port_bytes(restored) == _port_bytes(tstate)
        finally:
            reader.close(unlink_shm=True)
    finally:
        m0.server.stop()
        m1.server.stop()


# -- a host-gather stage under the lock ---------------------------------------


def test_host_gather_stage_holds_the_lock_across_threads(job, monkeypatch):
    """A host-gather stage takes the shm lock in the saving thread (the
    copy) and releases it in the staging thread (after the publish), one
    connection's lock. While it is held no one else gets it; breakpoint
    persists run concurrently with stages of steps 2-7 and every step they
    persist holds that step's values, never a torn mix."""
    name, ckpt_dir = job
    monkeypatch.setenv("DLROVER_TPU_DEVICE_SNAPSHOT", "0")
    monkeypatch.setattr(AsyncCheckpointSaver, "BREAKPOINT_LOCK_TIMEOUT", 0.3)
    host = AsyncCheckpointSaver(job_name=name, node_id=0,
                                deletion_strategy=KeepLatestStepStrategy(100))
    # each next stage starts while a persist is copying (a slow one): with
    # the stage outside the lock the persist would copy its bytes
    real_write = host.persister._write_process_ckpt
    copying = threading.Event()

    def slow_write(*args, **kwargs):
        copying.set()
        time.sleep(0.05)
        return real_write(*args, **kwargs)

    monkeypatch.setattr(host.persister, "_write_process_ckpt", slow_write)
    host.start()
    eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0, process_id=0)
    other = ipc.SharedLock(saver.SHM_LOCK, host.socket_path,
                           connect_timeout=5)
    gate = threading.Event()
    real_publish = eng._publish

    def held_publish(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            assert gate.wait(timeout=WAIT_S)
        return real_publish(*args, **kwargs)

    monkeypatch.setattr(eng, "_publish", held_publish)
    persisted, done = [], threading.Event()

    def breakpoints():
        while not done.is_set():
            if host.save_shm_to_storage(ckpt_dir):
                persisted.append(host.persister.committed_step(ckpt_dir))
            time.sleep(0.01)

    bp = threading.Thread(target=breakpoints, daemon=True)
    try:
        eng.save_to_memory(1, _filled(1, 1 << 16))
        assert eng.last_stage_mode == "host_gather"
        assert other.locked()
        assert other.acquire(blocking=False) is False
        assert host.save_shm_to_storage(ckpt_dir) is False
        gate.set()
        eng.wait_staging(timeout=WAIT_S)
        assert not other.locked()
        bp.start()
        for step in range(2, 8):
            assert copying.wait(timeout=WAIT_S)
            copying.clear()
            eng.save_to_memory(step, _filled(step, 1 << 16))
            eng.wait_staging(timeout=WAIT_S)
        done.set()
        bp.join(timeout=WAIT_S)
        assert not bp.is_alive()
    finally:
        gate.set()
        done.set()
        other.close()
        eng.close(unlink_shm=True)
        host.stop()
    assert persisted, "no breakpoint persist ran"
    for step in sorted(set(persisted)):
        reader = CheckpointEngine(ckpt_dir, job_name=name, node_id=0,
                                  process_id=0)
        try:
            pieces = reader._restore_step_tiered(step, None, None)
            assert pieces is not None, step
            assert torch.equal(pieces[1]["['w']"],
                               torch.full((1 << 16,), float(step))), step
            assert int(pieces[1]["['step']"]) == step
        finally:
            reader.close(unlink_shm=True)
