"""The port's master state store and a relaunched master, held to the JAX
package's on the CPU.

(a) The backends (memory, file, and configmap on a fake k8s client) give
    the same answers to one key script in both packages; a file or
    configmap backend either package wrote reads in the other; the key
    encoding of awkward dataset names is the JAX one; a stale job uid is
    dropped by both state managers.
(b) One dispatch/report/lease script through a task manager on a file
    backend, then each package's ``restore_from_state`` of that directory:
    the todo, doing, leases, fences and ``lease_seq`` are equal both ways,
    and the live worker's late acks complete exactly once in both.
(c) ``SpeedMonitor`` and ``StragglerDetector`` ``export_state`` in one
    package and ``import_state`` in the other, both ways, on one clock:
    ``attribution()``, ``goodput()``, ``total_downtime()`` and the
    detector's snapshot are equal afterwards.
(d) The port's ``LocalJobMaster.prepare`` restores a JAX master's state
    directory before it serves: the dataset's queue, the global step, and
    a downtime bracket backdated to the old master's last snapshot; a job
    that succeeds clears the state, after the task manager's last drain.
(e) A port master SIGKILLed mid-run and relaunched on the same port with
    the file backend, under ``elastic_run --master_addr`` and a CPU shard
    worker: every range is processed exactly once, the relaunched master
    concludes the job, and its global step and ledger carry across.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import uuid

import pytest

from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master import state_store as jstore
from dlrover_tpu.master.monitor import speed_monitor as jspeed
from dlrover_tpu.master.shard import task_manager as jtm
from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.common import messages as pmsg
from dlrover_tpu_torch.common.ipc import default_socket_path
from dlrover_tpu_torch.master import state_store as pstore
from dlrover_tpu_torch.master.local_master import LocalJobMaster
from dlrover_tpu_torch.master.monitor import speed_monitor as pspeed
from dlrover_tpu_torch.master.shard import task_manager as ptm
from dlrover_tpu_torch.utils.net import find_free_port
from tests.k8s_fakes import make_fake_client

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = {"jax": jstore, "port": pstore}
TASKS = {"jax": (jtm, jmsg), "port": (ptm, pmsg)}
SPEEDS = {"jax": jspeed, "port": pspeed}
AWKWARD = ["train", "tasks/a/b", "x.y__z", "sp ace:colon", "ünï",
           "a.2Fb", "trailing."]


class Clock:
    """A settable clock both packages' managers read."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- (a) the backends ------------------------------------------------------------


def _backend(store, kind, tmp_path, client):
    if kind == "memory":
        return store.MemoryStateBackend()
    if kind == "file":
        return store.FileStateBackend(str(tmp_path / "state"))
    return store.ConfigMapStateBackend(client, "dlrover-state-j1")


def _backend_script(b):
    out = []
    b.set("tasks/train", json.dumps({"a": 1}))
    b.set("tasks/eval", json.dumps({"b": 2}))
    b.set("speed", json.dumps({"step": 5}))
    out.append(json.loads(b.get("tasks/train")))
    out.append(sorted(b.keys("tasks/")))
    # a second write must not clobber sibling keys
    b.set("tasks/train", json.dumps({"a": 9}))
    out.append((json.loads(b.get("tasks/train")),
                json.loads(b.get("tasks/eval"))))
    b.delete("tasks/eval")
    out.append((b.get("tasks/eval"), b.get("nope"), sorted(b.keys())))
    return out


@pytest.mark.parametrize("kind", ["memory", "file", "configmap"])
def test_backend_roundtrip_matches_jax(kind, tmp_path):
    outs = {}
    for name, store in STORES.items():
        client, _ = make_fake_client()
        outs[name] = _backend_script(
            _backend(store, kind, tmp_path / name, client))
    assert outs["port"] == outs["jax"]
    assert outs["port"][-1] == (None, None, ["speed", "tasks/train"])


@pytest.mark.parametrize("kind", ["file", "configmap"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_durable_backend_reads_in_the_other_package(kind, writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    client, _ = make_fake_client()
    w = _backend(STORES[writer], kind, tmp_path, client)
    for i, name in enumerate(AWKWARD):
        w.set(f"tasks/{name}", json.dumps({"i": i}))
    w.set("speed", "{}")
    r = _backend(STORES[reader], kind, tmp_path, client)
    assert sorted(r.keys()) == sorted(w.keys())
    assert sorted(r.keys("tasks/")) == sorted(f"tasks/{n}" for n in AWKWARD)
    for i, name in enumerate(AWKWARD):
        assert json.loads(r.get(f"tasks/{name}")) == {"i": i}
    if kind == "file":
        assert sorted(os.listdir(tmp_path / "state")) == sorted(
            pstore._encode_key(k) + ".json" for k in w.keys())


@pytest.mark.parametrize("key", AWKWARD + ["", ".", "..", "%2F", "a-b_c"])
def test_key_encoding_is_the_jax_one(key):
    enc = pstore._encode_key(key)
    assert enc == jstore._encode_key(key)
    assert pstore._decode_key(enc) == key == jstore._decode_key(enc)
    assert "/" not in enc and " " not in enc


def test_create_state_backend_reads_the_jax_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "file")
    monkeypatch.setenv("DLROVER_TPU_STATE_DIR", str(tmp_path))
    pb = pstore.create_state_backend("job-a")
    jb = jstore.create_state_backend("job-a")
    assert isinstance(pb, pstore.FileStateBackend)
    pb.set("speed", "{}")
    assert jb.get("speed") == "{}"
    assert os.listdir(tmp_path / "job-a") == ["speed.json"]
    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "")
    assert isinstance(pstore.create_state_backend("job-a"),
                      pstore.MemoryStateBackend)
    client, _ = make_fake_client()
    assert isinstance(pstore.create_state_backend("job-a", client),
                      pstore.ConfigMapStateBackend)


def test_file_backend_without_a_dir_roots_in_the_temp_dir(tmp_path,
                                                        monkeypatch):
    """Without ``DLROVER_TPU_STATE_DIR`` the port's file backend roots
    under ``$TMPDIR`` (the JAX package's under ``/tmp``), as the agent's
    logs do, so two checkouts with their own ``TMPDIR`` never share a
    job's state."""
    import tempfile

    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "file")
    monkeypatch.delenv("DLROVER_TPU_STATE_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    pstore.create_state_backend("job-b").set("speed", "{}")
    assert os.listdir(tmp_path / "dlrover_tpu_state_job-b" / "job-b") == [
        "speed.json"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stale_job_uid_is_dropped(writer, tmp_path):
    store = STORES[writer]
    backend = store.FileStateBackend(str(tmp_path))
    old = store.MasterStateManager(backend, job_uid="uid-old")
    old.save_dataset("train", {"dataset_name": "train"},
                     json.dumps({"dataset_name": "train"}))
    old.save_speed({"global_step": 7})
    old.save_nodes({"budget": 1})
    old.save_planner({"cooldown": 2})
    for reader in STORES.values():
        same = reader.MasterStateManager(
            reader.FileStateBackend(str(tmp_path)), job_uid="uid-old")
        other = reader.MasterStateManager(
            reader.FileStateBackend(str(tmp_path)), job_uid="uid-new")
        assert list(same.load_datasets()) == ["train"]
        assert same.load_speed()["global_step"] == 7
        assert same.load_nodes()["budget"] == 1
        assert same.load_planner() == {"cooldown": 2}
        assert other.load_datasets() == {}
        assert other.load_speed() is None and other.load_nodes() is None
        assert other.load_planner() is None
    doc = json.loads(backend.get("speed"))
    assert doc["_format"] == "state_speed" and doc["_v"] == 2
    pstore.MasterStateManager(pstore.FileStateBackend(str(tmp_path))).clear()
    assert backend.keys() == []


# -- (b) the task manager's write-through and restore ------------------------------


DATASET = "train/shards.v1"


def _grant(g):
    return {"tasks": [(t.task_id, t.shard_start, t.shard_end)
                      for t in g.tasks], "fence": g.lease_epoch,
            "acked": list(g.acked), "idle": g.idle,
            "exhausted": g.exhausted}


def _final_flush(tm):
    """Stop a task manager and leave its final state in the backend: wait
    for its writer thread to end, then write every dataset once more (the
    JAX manager's writer thread and an explicit flush race, and the one
    that took the older checkpoint can write last)."""
    tm.stop()
    if tm._writer is not None:
        tm._writer.join(timeout=10)
    tm._dirty.update(tm._datasets)
    tm.flush_state()


def _write_state(name, root, clock):
    """A dispatch/report/lease script through one package's task manager
    on a file backend at ``root``; returns what the live workers hold when
    the master dies."""
    tm_mod, msg_mod = TASKS[name]
    store = STORES[name]
    tm = tm_mod.TaskManager(
        clock=clock, lease_ttl=30.0,
        state_manager=store.MasterStateManager(store.FileStateBackend(root)))
    tm.new_dataset(msg_mod.DatasetShardParams(
        dataset_name=DATASET, dataset_size=1000, shard_size=100,
        num_epochs=2, shuffle=True))
    tm.new_dataset(msg_mod.DatasetShardParams(
        dataset_name="stream", dataset_size=-1, shard_size=50,
        storage_type="streaming", partition_offsets={"a": 0, "b": 10}))
    legacy = tm.get_dataset_task(5, DATASET)
    g0 = tm.lease_shards(0, DATASET, 4)
    g1 = tm.lease_shards(1, DATASET, 3)
    ids0 = [t.task_id for t in g0.tasks]
    tm.lease_shards(0, DATASET, 2, done_ids=ids0[:2], failed_ids=ids0[2:3],
                    lease_epoch=g0.lease_epoch)
    g0b = tm.lease_shards(0, DATASET, 0)
    tm.report_dataset_task(DATASET, legacy.task_id, True)
    legacy2 = tm.get_dataset_task(6, DATASET)
    clock.t += 25.0
    tm.renew_node_leases(1)
    clock.t += 10.0
    tm.sweep_deadlines()  # node 0's lease expires, its shards requeue
    g2 = tm.lease_shards(2, DATASET, 3)
    st = tm.lease_shards(3, "stream", 2)
    tm.remove_node_tasks(6)
    _final_flush(tm)  # the master is "killed" here
    return {"g1": g1, "g2": g2, "g0b": g0b, "legacy2": legacy2, "st": st,
            "own": json.loads(tm.checkpoint_dataset(DATASET).to_json())}


def _restore(name, root, clock):
    tm_mod, _ = TASKS[name]
    store = STORES[name]
    tm = tm_mod.TaskManager(
        clock=clock, lease_ttl=30.0,
        state_manager=store.MasterStateManager(store.FileStateBackend(root)))
    return tm, tm.restore_from_state()


def _after_restore(tm, held):
    """The live workers' late reports against a restored manager, then
    the rest of the data drained by a new node."""
    out = {"ckpt": json.loads(tm.checkpoint_dataset(DATASET).to_json()),
           "stream": json.loads(tm.checkpoint_dataset("stream").to_json())}
    ids1 = [t.task_id for t in held["g1"].tasks]
    out["ack1"] = _grant(tm.lease_shards(1, DATASET, 0, done_ids=ids1,
                                         lease_epoch=held["g1"].lease_epoch))
    out["ack1_again"] = _grant(tm.lease_shards(
        1, DATASET, 0, done_ids=ids1, lease_epoch=held["g1"].lease_epoch))
    # node 0's zombie ack under its expired fence counts nothing
    out["zombie"] = _grant(tm.lease_shards(
        0, DATASET, 0, done_ids=[t.task_id for t in held["g0b"].tasks],
        lease_epoch=held["g0b"].lease_epoch))
    out["legacy"] = tm.report_dataset_task(DATASET, held["legacy2"].task_id,
                                           True)
    out["completed"] = tm.completed_records(DATASET)
    fence, done = -1, []
    for _ in range(40):
        g = tm.lease_shards(9, DATASET, 3, done_ids=done, lease_epoch=fence)
        fence, done = g.lease_epoch, [t.task_id for t in g.tasks]
        if not g.tasks and not done:
            break
    out["drained"] = (tm.completed_records(DATASET), tm.get_epoch(DATASET))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_task_state_restores_in_both_packages(writer, tmp_path):
    root = str(tmp_path / "state")
    held = _write_state(writer, root, Clock())
    docs = {k: json.loads(open(os.path.join(root, f)).read())
            for k, f in ((k, pstore._encode_key(k) + ".json")
                         for k in (f"tasks/{DATASET}", "tasks/stream"))}
    assert docs[f"tasks/{DATASET}"]["_format"] == "state_dataset"
    restored = {}
    for name in ("jax", "port"):
        # each relaunched master on its own copy: a restored manager
        # writes its own acks through to its directory
        copy = str(tmp_path / f"restored-by-{name}")
        shutil.copytree(root, copy)
        clock = Clock(1050.0)
        tm, n = _restore(name, copy, clock)
        assert n == 2
        restored[name] = _after_restore(tm, held)
    assert restored["port"] == restored["jax"]
    got = restored["port"]
    own = held["own"]
    # the restored queue is the dead master's: todo, doing, leases (ids,
    # fences and task sets), lease_seq (the todo shards get new task ids);
    # a restored lease gets one TTL of grace from the relaunch
    for key in ("todo", "doing", "doing_meta", "epoch", "completed_records",
                "lease_seq"):
        assert got["ckpt"][key] == own[key], key
    assert [x[:2] + x[3:4] for x in got["ckpt"]["leases"]] == \
        [x[:2] + x[3:4] for x in own["leases"]]
    assert all(x[2] >= 1050.0 + 30.0 for x in got["ckpt"]["leases"])
    assert len(got["ack1"]["acked"]) == 3 and got["ack1_again"]["acked"] == []
    # node 0's zombie acks count nothing, nor does node 6's legacy report
    # (evicted before the kill, its shard requeued)
    assert got["zombie"]["acked"] == [] and not got["legacy"]
    # everything else drains; node 2's three shards stay leased to it
    assert got["drained"] == (1700, 2)


def test_relaunched_lease_survives_exactly_once(tmp_path):
    """The JAX package's own relaunch case (a lease open across the kill,
    one ack persisted) through the port, with the JAX manager restoring
    a copy of the same directory alongside."""
    clock = Clock()
    root = str(tmp_path / "state")
    tm = ptm.TaskManager(clock=clock, lease_ttl=30.0,
                         state_manager=pstore.MasterStateManager(
                             pstore.FileStateBackend(root)))
    tm.new_dataset(pmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=600, shard_size=100))
    g = tm.lease_shards(0, "ds", 4)
    tm.lease_shards(0, "ds", 0, done_ids=[g.tasks[0].task_id],
                    lease_epoch=g.lease_epoch)
    tm.flush_state()
    for name in ("port", "jax"):
        copy = str(tmp_path / f"restored-by-{name}")
        shutil.copytree(root, copy)
        tm2, n = _restore(name, copy, clock)
        assert n == 1 and tm2.completed_records("ds") == 100
        ds2 = tm2._datasets["ds"]
        assert len(ds2._doing) == 3 and 0 in ds2._leases
        rest = [t.task_id for t in g.tasks[1:]]
        ok = tm2.lease_shards(0, "ds", 0, done_ids=rest,
                              lease_epoch=g.lease_epoch)
        assert len(ok.acked) == 3 and tm2.completed_records("ds") == 400
        again = tm2.lease_shards(0, "ds", 0, done_ids=rest,
                                 lease_epoch=g.lease_epoch)
        assert again.acked == [] and tm2.completed_records("ds") == 400


def test_write_through_marks_every_mutation(tmp_path):
    """Each dispatch, ack, failure, expiry and eviction reaches the
    backend (the flushed document is the in-memory checkpoint)."""
    clock = Clock()
    sm = pstore.MasterStateManager(pstore.FileStateBackend(str(tmp_path)))
    tm = ptm.TaskManager(clock=clock, lease_ttl=30.0, state_manager=sm)
    # the wall-clock sweep paused: this test sweeps on its own clock
    tm.start()
    tm.pause_scan()
    tm._thread.join(timeout=5)
    assert not tm._thread.is_alive()
    tm.new_dataset(pmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=600, shard_size=100))

    def persisted():
        tm.flush_state()
        return sm.load_datasets()["ds"]["ckpt"]

    def live():
        return json.loads(tm.checkpoint_dataset("ds").to_json())

    assert persisted() == live()
    g = tm.lease_shards(0, "ds", 3)
    assert persisted() == live() and len(live()["leases"]) == 1
    tm.lease_shards(0, "ds", 0, done_ids=[g.tasks[0].task_id],
                    failed_ids=[g.tasks[1].task_id],
                    lease_epoch=g.lease_epoch)
    assert persisted() == live() and live()["completed_records"] == 100
    t = tm.get_dataset_task(4, "ds")
    tm.report_dataset_task("ds", t.task_id, False)
    assert persisted() == live()
    clock.t += 31.0
    assert tm.sweep_deadlines() == 1
    assert persisted() == live() and not live()["leases"]
    tm.get_dataset_task(5, "ds")
    tm.remove_node_tasks(5)
    assert persisted() == live() and not live()["doing"]
    tm.stop()


def test_drains_never_write_a_stale_document(tmp_path):
    """The writer thread takes a checkpoint and is slow to write it while
    the dataset moves on and an explicit flush runs: the document that
    stays is the newest (the port serialises its drains)."""
    import threading

    class SlowFirstWrite(pstore.FileStateBackend):
        first = threading.Event()

        def set(self, key, value):
            if not self.first.is_set():
                self.first.set()
                time.sleep(0.3)
            super().set(key, value)

    sm = pstore.MasterStateManager(SlowFirstWrite(str(tmp_path)))
    tm = ptm.TaskManager(lease_ttl=30.0, state_manager=sm)
    tm.new_dataset(pmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=600, shard_size=100))
    assert SlowFirstWrite.first.wait(5)  # the writer holds an old copy
    g = tm.lease_shards(0, "ds", 3)
    tm.lease_shards(0, "ds", 0, done_ids=[t.task_id for t in g.tasks],
                    lease_epoch=g.lease_epoch)
    tm.flush_state()
    tm.stop()
    tm._writer.join(timeout=10)
    doc = sm.load_datasets()["ds"]["ckpt"]
    assert doc["completed_records"] == 300 and len(doc["todo"]) == 3


# -- (c) the speed ledger across packages -------------------------------------------


def _ledger(mod, clock):
    """A ledger with steps, digests from a slow rank, checkpoint blocking,
    comm links, a layout, a closed and an open downtime bracket, a
    breakdown and hang seconds."""
    sm = mod.SpeedMonitor(clock=clock)
    sm.set_target_worker_num(3)
    for node in range(3):
        sm.add_running_worker("worker", node)
    step = 0
    for w in range(5):
        clock.t += 15.0
        step += 10
        sm.collect_global_step(step)
        for node in range(3):
            p50 = 0.5 * (1.9 if node == 2 and w else 1.0) + 0.01 * w
            sm.collect_step_digest(node, {
                "count": 10, "mean_s": p50, "p50_s": p50,
                "p95_s": p50 * 1.2, "max_s": p50 * 1.4,
                "input_wait_s": 0.05 * node}, ts=clock.t)
        sm.record_ckpt_blocking(0.03 * (w + 1), node_id=w % 3)
        sm.record_comm_links(w % 3, {"ici": 100 * (w + 1)},
                             overlap_ratio=0.5)
    sm.mark_downtime_start(ts=clock.t + 1.0)
    clock.t += 20.0
    sm.record_downtime_breakdown(rendezvous_s=2.0, compile_s=3.0,
                                 state_transfer_s=4.0, restore_tier="shm")
    sm.mark_downtime_end()
    sm.record_hang(6.5)
    sm.report_layout("dp3")
    clock.t += 5.0
    sm.mark_downtime_start()  # open when the master dies
    clock.t += 2.0
    return sm


def _reading(sm, clock):
    return {"attribution": sm.attribution(), "goodput": sm.goodput(),
            "downtime": sm.total_downtime(), "step": sm.completed_global_step,
            "start": sm.start_training_time,
            "progress": sm.last_progress_ts(),
            "open": sm.downtime_in_progress(),
            "breakdown": sm.downtime_breakdown(),
            "stragglers": sm.stragglers(),
            "detector": sm.straggler_detector.snapshot(),
            "links": sm.comm_link_report(), "layout": sm.layout_spec(),
            "now": clock.t}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_speed_ledger_crosses_packages(writer):
    reader = "port" if writer == "jax" else "jax"
    clock = Clock()
    old = _ledger(SPEEDS[writer], clock)
    state = old.export_state()
    assert state == _ledger(SPEEDS[reader], Clock()).export_state()
    # the document is JSON as the state store writes it
    state = json.loads(json.dumps(state))
    clock.t += 7.0  # the relaunch gap
    readings = {}
    for name in (writer, reader):
        sm = SPEEDS[name].SpeedMonitor(clock=clock)
        sm.import_state(state)
        readings[name] = _reading(sm, clock)
        # the detector alone crosses too
        det = SPEEDS[name].SpeedMonitor(clock=clock).straggler_detector
        det.import_state(old.straggler_detector.export_state())
        assert det.export_state() == old.straggler_detector.export_state()
    assert readings[reader] == readings[writer]
    got = readings[reader]
    assert got["step"] == 50 and got["open"] and got["stragglers"] == [2]
    cats = got["attribution"]["categories"]
    assert cats["collective_hang"] == 6.5 and cats["productive"] > 0
    assert 0.0 < got["goodput"] < 1.0


# -- (d) the local master's restore ----------------------------------------------------


def test_local_master_restores_a_jax_masters_state(tmp_path, monkeypatch):
    job = f"relaunch-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "file")
    monkeypatch.setenv("DLROVER_TPU_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_HANG_WATCHDOG", "0")
    # the dead master's state, written by the JAX package
    jsm = jstore.MasterStateManager(jstore.create_state_backend(job))
    tm = jtm.TaskManager(state_manager=jsm)
    tm.new_dataset(jmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=40, shard_size=10))
    g = tm.lease_shards(0, "ds", 2)
    _final_flush(tm)
    ledger = jspeed.SpeedMonitor()
    ledger.collect_global_step(12, time.time() - 30.0)
    state = ledger.export_state()
    state["snapshot_time"] = time.time() - 3.0
    jsm.save_speed(state)
    master = LocalJobMaster(port=0)
    master.prepare()
    try:
        sm = master.speed_monitor
        assert sm.completed_global_step == 12
        assert sm.downtime_in_progress()
        assert sm._downtime_start == pytest.approx(state["snapshot_time"])
        ck = json.loads(master.task_manager.checkpoint_dataset("ds")
                        .to_json())
        assert len(ck["doing"]) == 2 and len(ck["todo"]) == 2
        assert ck["leases"][0][1] == g.lease_epoch
        assert not master.hang_watchdog._thread
        # the first step report closes the relaunch's bracket
        sm.collect_global_step(13)
        sm.mark_downtime_end()
        assert sm.total_downtime() >= 3.0
    finally:
        master.stop()
    # a job that succeeds clears the state
    master = LocalJobMaster(port=0)
    master.prepare()
    master.job_manager.all_workers_succeeded = lambda: True
    assert master.run(poll_interval=0.01) == 0
    assert os.listdir(tmp_path / job) == []


def test_a_succeeded_job_leaves_no_state_behind(tmp_path, monkeypatch):
    """A drain still writing when the job succeeds lands before the
    clear, so the state directory is empty once ``run`` returns."""
    import threading

    job = f"clear-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "file")
    monkeypatch.setenv("DLROVER_TPU_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_HANG_WATCHDOG", "0")
    master = LocalJobMaster(port=0)
    master.prepare()
    store = master.state_manager
    save_dataset, writing = store.save_dataset, threading.Event()

    def slow_save(*args, **kwargs):
        writing.set()
        time.sleep(0.5)
        save_dataset(*args, **kwargs)

    store.save_dataset = slow_save
    master.task_manager.new_dataset(pmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=40, shard_size=10))
    assert writing.wait(5)  # the writer thread is in its drain
    master.job_manager.all_workers_succeeded = lambda: True
    assert master.run(poll_interval=0.01) == 0
    master.task_manager._writer.join(timeout=10)
    assert os.listdir(tmp_path / job) == []


def test_local_master_starts_the_watchdog_under_the_flag(monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_HANG_WATCHDOG", raising=False)
    monkeypatch.setenv("DLROVER_TPU_HANG_WATCHDOG_WINDOW_S", "8")
    master = LocalJobMaster(port=0)
    assert master.hang_watchdog.window_s == 8.0
    master.prepare()
    try:
        assert master.hang_watchdog._thread.is_alive()
    finally:
        master.stop()
    assert master.hang_watchdog._stop_evt.is_set()


# -- (e) a master SIGKILLed and relaunched under a live worker ----------------------


RELAUNCH_RECORDS = 64
RELAUNCH_SHARD = 4
RELAUNCH_KILL_AFTER = 6
RELAUNCH_TIMEOUT_S = 90

# the CPU shard worker: registers the dataset, leases 4 shards a call,
# "processes" each with a short sleep, reports a step per shard, and
# prints each range
SHARD_WORKER = """\
import sys, time
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.data import ShardingClient
ctx = bootstrap.init()
sharding = ShardingClient("relaunch-ds", ctx.client, lease_count=4)
sharding.register_dataset(RECORDS, SHARD, num_epochs=1, shuffle=False)
n = 0
for task in sharding.iter_tasks():
    time.sleep(0.3)
    n += 1
    ctx.report_step(n, force=True)
    print(f"[shards] processing {task.shard_start}:{task.shard_end} "
          f"at {time.time():.3f}", flush=True)
print("[shards] done", flush=True)
"""


def _spawn_master(port, env, log_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.master.main", "--port",
         str(port)], cwd=REPO_ROOT, env=env, stdout=open(log_path, "w"),
        stderr=subprocess.STDOUT, start_new_session=True)
    deadline = time.time() + 30
    while time.time() < deadline:
        text = open(log_path).read()
        if f"serving on port {port}" in text or proc.poll() is not None:
            break
        time.sleep(0.05)
    assert f"serving on port {port}" in open(log_path).read(), \
        open(log_path).read()[-2000:]
    return proc


def test_master_sigkill_relaunch_trains_every_range_once(tmp_path):
    job = f"torch-relaunch-{uuid.uuid4().hex[:8]}"
    script = tmp_path / "shard_worker.py"
    script.write_text(SHARD_WORKER.replace("RECORDS", str(RELAUNCH_RECORDS))
                      .replace("SHARD", str(RELAUNCH_SHARD)))
    env = dict(os.environ)
    env = {k: v for k, v in env.items() if not k.startswith("DLROVER_TPU_")}
    env.update(PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), DLROVER_TPU_STATE_BACKEND="file",
        DLROVER_TPU_STATE_DIR=str(tmp_path / "state"),
        DLROVER_TPU_JOB_NAME=job, OMP_NUM_THREADS="1")
    port = find_free_port()
    m1 = _spawn_master(port, env, tmp_path / "m1.log")
    m2 = None
    agent = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
         f"--master_addr=127.0.0.1:{port}", "--nnodes=1",
         "--nproc_per_node=1", "--accelerator", "cpu",
         f"--job_name={job}", "--monitor_interval", "0.2", str(script)],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    log = os.path.join(agent_log_dir(job, 0), "worker-0-restart0.log")
    try:
        deadline = time.time() + RELAUNCH_TIMEOUT_S
        while time.time() < deadline:
            text = open(log).read() if os.path.exists(log) else ""
            if text.count("[shards] processing") >= RELAUNCH_KILL_AFTER:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"no shards processed:\n{text[-3000:]}")
        os.kill(m1.pid, signal.SIGKILL)
        kill_t = time.time()
        m1.wait(timeout=30)
        time.sleep(1.0)  # a real relaunch gap; the clients' retries ride it
        m2 = _spawn_master(port, env, tmp_path / "m2.log")
        out, _ = agent.communicate(timeout=RELAUNCH_TIMEOUT_S)
        m2.wait(timeout=60)
        text = open(log).read()
        m2_log = open(tmp_path / "m2.log").read()
        assert agent.returncode == 0, (out[-3000:], text[-2000:])
        assert "[shards] done" in text
        ranges = [(int(a), int(b)) for a, b in
                  re.findall(r"\[shards\] processing (\d+):(\d+)", text)]
        twice = sorted({r for r in ranges if ranges.count(r) > 1})
        assert not twice, f"ranges processed twice: {twice}"
        assert set(ranges) == {(i, i + RELAUNCH_SHARD) for i in
                               range(0, RELAUNCH_RECORDS, RELAUNCH_SHARD)}
        resumed = re.search(r"resumed state: 1 datasets, global_step=(\d+)",
                            m2_log)
        assert resumed and 0 < int(resumed.group(1)) <= RELAUNCH_KILL_AFTER + 1
        assert "restored dataset relaunch-ds" in m2_log
        assert "local master exiting: succeeded" in m2_log, m2_log[-2000:]
        summary = re.search(r"goodput ([0-9.]+), downtime ([0-9.]+)s, "
                            r"global step (\d+)", m2_log)
        assert summary and int(summary.group(3)) == len(ranges)
        assert 0.0 < float(summary.group(1)) <= 1.0
        brackets = json.loads(m2_log.split("downtime brackets ", 1)[1]
                              .splitlines()[0])
        assert len(brackets) == 1
        assert brackets[0][0] <= kill_t <= brackets[0][1]
        # the job succeeded: the state is cleared
        assert os.listdir(tmp_path / "state" / job) == []
    finally:
        for p in (m1, m2, agent):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
