"""The port's data plane held to the JAX package's, on the CPU.

(a) Splitters: the text, table (with sub-epochs) and streaming splitters of
    both packages give the same shards in the same seeded order, epoch after
    epoch.
(b) The shard queue: one scripted sequence (a new dataset, ``get_task``,
    leases with acks and failures, a stale fence, renewal, expiry,
    ``remove_node_tasks``, the epoch's end) goes through both packages'
    ``TaskManager`` on an injected clock; the tasks, the grants (acked, idle,
    exhausted, fence, deadline), the todo counts and the completed records
    are equal at every step.
(c) The shard checkpoint: a ``DatasetShardCheckpoint`` JSON written by
    either package, with a doing-set under leases, restores in the other to
    the same queue, and a version-less legacy payload decodes and restores
    alike in both.
(d) The input pipeline: ``pack_tokens`` (uint16, uint32, int32) writes the
    same bytes, ``TokenFileDataset`` gives the same samples, and both refuse
    the same out-of-range tokens and corpora (``validate_vocab``); the
    sampler's indices, ``state_dict`` and resumes (into a world of another
    size too); the loader's batches and its batch size from the
    parallel-config file; ``prefetch_to_device`` on the CPU yields the same
    batches in the same order; ``ShardingClient`` against each package's
    task manager takes the same shards, by the lease protocol and by the
    per-task fallback for a master that does not know it.
"""

import json

import numpy as np
import pytest
import torch

from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master.shard import dataset_manager as jdm
from dlrover_tpu.master.shard import dataset_splitter as jsplit
from dlrover_tpu.master.shard import task_manager as jtm
from dlrover_tpu.train import data as jdata
from dlrover_tpu.train import datasets as jdatasets
from dlrover_tpu_torch.common import messages as pmsg
from dlrover_tpu_torch.master.shard import dataset_manager as pdm
from dlrover_tpu_torch.master.shard import dataset_splitter as psplit
from dlrover_tpu_torch.master.shard import task_manager as ptm
from dlrover_tpu_torch.train import data as pdata
from dlrover_tpu_torch.train import datasets as pdatasets


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _task(t):
    return (t.task_id, t.task_type, t.dataset_name, t.shard_start,
            t.shard_end, list(t.shard_indices), t.epoch, t.partition)


# -- (a) splitters ------------------------------------------------------------


def _text(mod):
    return mod.TextDatasetSplitter("ds", 1003, 100, num_epochs=3,
                                   shuffle=True, seed=7)


def _text_plain(mod):
    return mod.TextDatasetSplitter("ds", 95, 10, num_epochs=2)


def _table(mod):
    return mod.TableDatasetSplitter("tbl", 1000, 30, num_epochs=2,
                                    shuffle=True, seed=3, max_shard_count=8)


def _streaming(mod):
    return mod.StreamingDatasetSplitter(
        "st", 25, mod.PartitionOffsets({"p0": 0, "p1": 100, "p2": 7}),
        max_shard_count=2)


@pytest.mark.parametrize("make", [_text, _text_plain, _table, _streaming],
                         ids=["text-shuffled", "text", "table-subepochs",
                              "streaming"])
def test_splitters_give_the_same_shards_in_the_same_order(make):
    j, p = make(jsplit), make(psplit)
    rounds = 0
    while True:
        jmade, pmade = j.create_shards(), p.create_shards()
        assert jmade == pmade
        if not jmade or rounds == 8:
            break
        rounds += 1
        js = [(s.name, s.start, s.end, s.record_indices)
              for s in j.get_shards()]
        ps = [(s.name, s.start, s.end, s.record_indices)
              for s in p.get_shards()]
        assert ps == js, rounds
        assert p.epoch == j.epoch and p.epoch_finished() == j.epoch_finished()
    assert rounds > 1


def test_splitter_factory_and_epoch_units_match():
    for kind in ("text", "", "table"):
        j = jsplit.new_dataset_splitter(kind, "d", 50, 7, 2, True)
        p = psplit.new_dataset_splitter(kind, "d", 50, 7, 2, True)
        assert type(p).__name__ == type(j).__name__
        assert p.EPOCH_UNIT == j.EPOCH_UNIT
    for mod in (jsplit, psplit):
        with pytest.raises(ValueError, match="unknown splitter type"):
            mod.new_dataset_splitter("nope", "d", 1, 1)
    # a pass-counted checkpoint restores into a sub-epoch table
    j, p = _table(jsplit), _table(psplit)
    for s in (j, p):
        s.restore_epoch(1, "pass", 1)
    assert p.epoch == j.epoch == 1 * j.EPOCH_FACTOR


# -- (b) the shard queue --------------------------------------------------------


def _grant(g):
    return {"tasks": [_task(t) for t in g.tasks], "fence": g.lease_epoch,
            "deadline": g.deadline, "acked": list(g.acked), "idle": g.idle,
            "exhausted": g.exhausted}


def _queue_script(tm_mod, msg_mod):
    """Drive one TaskManager through the scripted sequence on a virtual
    clock; return every observation in order."""
    clock = Clock()
    tm = tm_mod.TaskManager(clock=clock, lease_ttl=30.0)
    tm.stop()
    out = []

    def look(label, value=None):
        out.append((label, value, tm.todo_counts(),
                    tm.completed_records("ds"), tm.get_epoch("ds"),
                    tm.finished()))

    tm.new_dataset(msg_mod.DatasetShardParams(
        dataset_name="ds", dataset_size=1000, shard_size=100, num_epochs=2,
        shuffle=True))
    tm.new_dataset(msg_mod.DatasetShardParams(  # a second registration
        dataset_name="ds", dataset_size=5, shard_size=1))
    look("new")
    legacy = tm.get_dataset_task(5, "ds")
    look("get_task", _task(legacy))
    g0 = tm.lease_shards(0, "ds", 4)
    look("lease0", _grant(g0))
    g1 = tm.lease_shards(1, "ds", 3)
    look("lease1", _grant(g1))
    ids0 = [t.task_id for t in g0.tasks]
    # node 0 acks two, fails one, and leases two more in the same call
    g = tm.lease_shards(0, "ds", 2, done_ids=ids0[:2], failed_ids=ids0[2:3],
                        lease_epoch=g0.lease_epoch)
    look("ack+fail", _grant(g))
    look("legacy report", tm.report_dataset_task("ds", legacy.task_id, True))
    look("legacy report again", tm.report_dataset_task(
        "ds", legacy.task_id, True))
    # renewal: node 1's heartbeat keeps its lease past the first deadline,
    # while node 0, which never renewed, expires and its shards requeue
    clock.t += 25.0
    tm.renew_node_leases(1)
    clock.t += 10.0
    look("expiry", tm.sweep_deadlines())
    # node 0's late ack under the old fence is a zombie's: nothing counts
    g = tm.lease_shards(0, "ds", 0, done_ids=[ids0[3]],
                        lease_epoch=g0.lease_epoch)
    look("stale fence", _grant(g))
    # node 1 dies: every shard it held goes back in the queue
    tm.remove_node_tasks(1)
    look("remove node 1")
    g = tm.lease_shards(1, "ds", 0, done_ids=[t.task_id for t in g1.tasks],
                        lease_epoch=g1.lease_epoch)
    look("dead node's late ack", _grant(g))
    clock.t += 100.0
    look("nothing due", tm.sweep_deadlines())
    # node 2 drains both epochs, acking each batch on the next call
    fence, done = -1, []
    for _ in range(40):
        g = tm.lease_shards(2, "ds", 3, done_ids=done, lease_epoch=fence)
        look("drain", _grant(g))
        fence, done = g.lease_epoch, [t.task_id for t in g.tasks]
        if g.exhausted:
            break
    look("epoch", tm.get_epoch("ds"))
    look("checkpoint", json.loads(tm.checkpoint_dataset("ds").to_json()))
    look("unknown dataset", (_task(tm.get_dataset_task(0, "none")),
                             _grant(tm.lease_shards(0, "none", 2))))
    tm.stop()
    return out


def test_shard_queue_script_matches_jax():
    jout = _queue_script(jtm, jmsg)
    pout = _queue_script(ptm, pmsg)
    assert len(pout) == len(jout)
    for i, (p, j) in enumerate(zip(pout, jout)):
        assert p == j, (i, p, j)
    # the script reached the end of both epochs
    assert jout[-3][0] == "epoch" and jout[-3][1] == 2
    assert jout[-4][1]["exhausted"] and jout[-4][-1]


def test_streaming_queue_matches_jax():
    def drive(tm_mod, msg_mod):
        tm = tm_mod.TaskManager(clock=Clock(), lease_ttl=10.0)
        tm.new_dataset(msg_mod.DatasetShardParams(
            dataset_name="st", dataset_size=-1, shard_size=50,
            storage_type="streaming", partition_offsets={"a": 0, "b": 10}))
        g = tm.lease_shards(0, "st", 3)
        t = tm.get_dataset_task(1, "st")
        tm.report_dataset_task("st", t.task_id, False)
        g2 = tm.lease_shards(0, "st", 2, done_ids=[g.tasks[0].task_id],
                             lease_epoch=g.lease_epoch)
        tm.remove_node_tasks(0)
        return ([_grant(g), _task(t), _grant(g2)],
                json.loads(tm.checkpoint_dataset("st").to_json()),
                tm.finished())

    assert drive(ptm, pmsg) == drive(jtm, jmsg)


# -- (c) the shard checkpoint ---------------------------------------------------


def _held_queue(tm_mod, msg_mod, clock):
    """A queue with acked, leased (two nodes) and legacy-issued shards."""
    tm = tm_mod.TaskManager(clock=clock, lease_ttl=30.0)
    tm.new_dataset(msg_mod.DatasetShardParams(
        dataset_name="ds", dataset_size=700, shard_size=100, num_epochs=2))
    g = tm.lease_shards(0, "ds", 3)
    tm.lease_shards(0, "ds", 1, done_ids=[g.tasks[0].task_id],
                    lease_epoch=g.lease_epoch)
    tm.lease_shards(4, "ds", 2)
    tm.get_dataset_task(9, "ds")
    return tm


def _restored(ds_mod, split_mod, content, clock):
    """A fresh dataset manager restored from ``content``; its checkpoint
    as a dict."""
    ds = ds_mod.BatchDatasetManager(
        "train", split_mod.TextDatasetSplitter("ds", 700, 100, 2),
        clock=clock, lease_ttl=30.0)
    ds.restore_checkpoint(ds_mod.DatasetShardCheckpoint.from_json(content))
    return json.loads(ds.checkpoint().to_json())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_checkpoint_restores_across_packages(writer):
    clock = Clock()
    tm = (_held_queue(jtm, jmsg, clock) if writer == "jax"
          else _held_queue(ptm, pmsg, clock))
    content = tm.checkpoint_dataset("ds").to_json()
    doc = json.loads(content)
    assert doc["_format"] == "dataset_shard_ckpt" and doc["_v"] == 2
    assert len(doc["leases"]) == 2 and len(doc["doing_meta"]) == 6
    clock.t += 5.0
    jgot = _restored(jdm, jsplit, content, clock)
    pgot = _restored(pdm, psplit, content, clock)
    assert pgot == jgot
    # the doing-set goes back to todo, its leases dropped (a worker restart)
    assert not pgot["doing"] and not pgot["leases"]
    assert len(pgot["todo"]) == 6
    # the JSON itself: each package's to_json of one checkpoint is equal
    assert json.loads(pdm.DatasetShardCheckpoint.from_json(content)
                      .to_json()) == json.loads(
        jdm.DatasetShardCheckpoint.from_json(content).to_json())


def test_legacy_shard_checkpoint_restores_in_both():
    """A version-less payload with 5-element doing_meta entries (a writer
    older than the lease protocol) decodes alike, fences -1."""
    legacy = json.dumps({
        "dataset_name": "ds", "todo": [[300, 400]], "doing": [[100, 200]],
        "epoch": 1, "completed_records": 100,
        "doing_meta": [[3, 2, "", 100, 200]], "task_id_seq": 4})
    decoded = [json.loads(m.DatasetShardCheckpoint.from_json(legacy).to_json())
               for m in (pdm, jdm)]
    assert decoded[0] == decoded[1]
    assert decoded[0]["doing_meta"] == [[3, 2, "", 100, 200, -1]]
    clock = Clock()
    jgot = _restored(jdm, jsplit, legacy, clock)
    pgot = _restored(pdm, psplit, legacy, clock)
    assert pgot == jgot
    assert pgot["todo"] == [[100, 200], [300, 400]] and pgot["epoch"] == 1


def test_task_manager_restore_through_the_wire_format():
    """The servicer's path: restore_dataset_checkpoint of the other
    package's JSON; an unknown dataset is refused."""
    clock = Clock()
    content = _held_queue(jtm, jmsg, clock).checkpoint_dataset("ds").to_json()
    tm = ptm.TaskManager(clock=clock, lease_ttl=30.0)
    assert not tm.restore_dataset_checkpoint(content)
    tm.new_dataset(pmsg.DatasetShardParams(
        dataset_name="ds", dataset_size=700, shard_size=100, num_epochs=2))
    assert tm.restore_dataset_checkpoint(content)
    assert tm.completed_records("ds") == 100
    assert tm.todo_counts() == {"ds": 6}


# -- (d) the input pipeline -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "int32"])
def test_pack_tokens_and_dataset_match(tmp_path, dtype):
    rng = np.random.RandomState(5)
    hi = 128256 if dtype != "uint16" else 65535
    toks = rng.randint(0, hi, 1000).tolist()
    jp, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    assert (jdatasets.pack_tokens(jp, toks, dtype)
            == pdatasets.pack_tokens(pp, toks, dtype) == 1000)
    assert open(jp, "rb").read() == open(pp, "rb").read()
    for stride in (None, 7):
        j = jdatasets.TokenFileDataset(jp, 64, dtype, stride=stride)
        p = pdatasets.TokenFileDataset(pp, 64, dtype, stride=stride)
        assert len(p) == len(j) and p.n_tokens == j.n_tokens == 1000
        for i in (0, 1, len(j) - 1):
            assert p[i].dtype == np.int32
            np.testing.assert_array_equal(p[i], j[i])
        for ds in (j, p):
            with pytest.raises(IndexError):
                ds[len(ds)]
    for ds in (jdatasets.TokenFileDataset(jp, 64, dtype),
               pdatasets.TokenFileDataset(pp, 64, dtype)):
        ds.validate_vocab(hi + 1)
        with pytest.raises(ValueError, match="outside the model vocab"):
            ds.validate_vocab(max(toks))


def test_out_of_range_tokens_and_dtypes_are_refused(tmp_path):
    for mod in (jdatasets, pdatasets):
        with pytest.raises(ValueError, match="out of range for uint16"):
            mod.pack_tokens(str(tmp_path / "x.bin"), [1, 70000], "uint16")
        with pytest.raises(ValueError, match="out of range for uint32"):
            mod.pack_tokens(str(tmp_path / "y.bin"), [-1], "uint32")
        with pytest.raises(ValueError, match="dtype="):
            mod.TokenFileDataset(str(tmp_path / "y.bin"), 4, "int64")
    # a signed corpus with a negative id fails validation in both
    path = str(tmp_path / "neg.bin")
    np.asarray([3, -2, 5, 1], np.int32).tofile(path)
    for mod in (jdatasets, pdatasets):
        with pytest.raises(ValueError, match=r"\[-2, 5\]"):
            mod.TokenFileDataset(path, 2, "int32").validate_vocab(10)


def test_pack_text_file_matches(tmp_path):
    text = tmp_path / "t.txt"
    text.write_text("hello world\n" * 50 + "no newline at the end")
    for mod, name in ((jdatasets, "j.bin"), (pdatasets, "p.bin")):
        n = mod.pack_text_file(str(text), str(tmp_path / name),
                               chunk_bytes=64)
        assert n == len(text.read_bytes())
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "p.bin").read_bytes()


def _take(sampler, n):
    out = []
    for idx in sampler:
        out.append(idx)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("world,rank,shuffle,drop_last", [
    (1, 0, True, True), (2, 1, True, True), (3, 2, False, False),
    (4, 0, True, False)])
def test_sampler_indices_state_and_resume_match(world, rank, shuffle,
                                                drop_last):
    kw = dict(dataset_size=53, batch_size=3, num_replicas=world, rank=rank,
              shuffle=shuffle, seed=11, drop_last=drop_last)
    j, p = jdata.ElasticDistributedSampler(**kw), \
        pdata.ElasticDistributedSampler(**kw)
    assert list(p) == list(j)  # a whole epoch
    assert p.state_dict() == j.state_dict() == {"epoch": 1,
                                                "completed_samples": 0}
    assert _take(p, 2) == _take(j, 2)
    state = p.state_dict()
    assert state == j.state_dict()
    # resume in a world of another size: aligned to its global batch
    for new_world in (world, world + 1):
        kw2 = dict(kw, num_replicas=new_world, rank=0)
        j2, p2 = jdata.ElasticDistributedSampler(**kw2), \
            pdata.ElasticDistributedSampler(**kw2)
        j2.load_state_dict(state)
        p2.load_state_dict(state)
        assert p2.state_dict() == j2.state_dict()
        assert list(p2) == list(j2)


@pytest.fixture
def corpus(tmp_path):
    path = str(tmp_path / "c.bin")
    toks = np.random.RandomState(2).randint(0, 500, 40 * 16).tolist()
    pdatasets.pack_tokens(path, toks, "uint32")
    return path


def _loaders(path, **kw):
    out = []
    for dmod, lmod in ((jdatasets, jdata), (pdatasets, pdata)):
        ds = dmod.TokenFileDataset(path, 16, "uint32")
        sampler = lmod.ElasticDistributedSampler(
            dataset_size=len(ds), batch_size=6, num_replicas=1, rank=0,
            shuffle=True, seed=1)
        out.append(lmod.ElasticDataLoader(
            ds, batch_size=6, sampler=sampler,
            collate=lambda xs: np.stack(xs).reshape(3, 2, 16), **kw))
    return out


def test_loader_batches_and_resume_match(corpus):
    j, p = _loaders(corpus)
    for _ in range(2):  # two epochs
        jb, pb = list(j), list(p)
        assert len(pb) == len(jb) == 6
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(b, a)
    it_j, it_p = iter(j), iter(p)
    for _ in range(3):
        next(it_j), next(it_p)
    assert p.state_dict() == j.state_dict()
    j2, p2 = _loaders(corpus)
    j2.load_state_dict(j.state_dict())
    p2.load_state_dict(p.state_dict())
    for a, b in zip(j2, p2):
        np.testing.assert_array_equal(b, a)
    # the default collate stacks samples (and tuples of them) alike
    samples = [(np.arange(3) + i, np.int32(i)) for i in range(4)]
    for x, y in zip(pdata._default_collate(samples),
                    jdata._default_collate(samples)):
        np.testing.assert_array_equal(x, y)


def test_loader_batch_size_from_the_paral_config(corpus, tmp_path,
                                                 monkeypatch):
    path = tmp_path / "paral.json"
    j, p = _loaders(corpus, config_path=str(path))
    assert p.update_batch_size_from_config() == \
        j.update_batch_size_from_config() is False
    path.write_text(json.dumps({"dataloader_version": 2,
                                "dataloader_batch_size": 4}))
    assert p.update_batch_size_from_config() == \
        j.update_batch_size_from_config() is True
    assert p.batch_size == j.batch_size == 4
    # a relative adjustment through the flag's path
    path.write_text(json.dumps({"dataloader_version": 3,
                                "micro_batch_scale": 0.5}))
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_PATH", str(path))
    j, p = _loaders(corpus)
    p.update_batch_size_from_config()
    j.update_batch_size_from_config()
    assert p.batch_size == j.batch_size == 3
    path.write_text("{torn")
    from dlrover_tpu.agent.paral_config_tuner import read_paral_config as jr
    from dlrover_tpu_torch.agent.paral_config_tuner import (
        read_paral_config as pr,
    )
    assert pr(str(path)) == jr(str(path)) == {}


@pytest.mark.parametrize("size", [0, 1, 2, 5])
def test_prefetch_on_the_cpu_yields_the_batches_in_order(corpus, size):
    want = list(_loaders(corpus)[0])  # the JAX loader's batches
    _, p = _loaders(corpus)
    got = list(pdata.prefetch_to_device(p, size, device="cpu"))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), a)
    # a process's rows of each leaf's second axis; trees keep their shape
    pairs = [(w, w[0].copy()) for w in want]
    got = list(pdata.prefetch_to_device(iter(pairs), size, device="cpu",
                                        rows=slice(1, 2)))
    for (a, _), (b, c) in zip(pairs, got):
        np.testing.assert_array_equal(b.numpy(), a[:, 1:2])
        np.testing.assert_array_equal(c.numpy(), a[0][:, 1:2])


def test_prefetch_refuses_a_card_it_does_not_have():
    """A CUDA device is placed on the card or raises; no batch stays on
    the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        next(pdata.prefetch_to_device(iter([np.zeros((1, 2, 3))]), 1,
                                      device="cuda"))


class _FakeMaster:
    """A master client over one package's TaskManager, in process."""

    def __init__(self, tm, msg_mod, node_id=0, lease_supported=True):
        self._tm, self._msg, self._nid = tm, msg_mod, node_id
        self._lease_supported = lease_supported
        self.calls = []

    def report_dataset_shard_params(self, params):
        self.calls.append("params")
        self._tm.new_dataset(params)

    def lease_shards(self, name, count, done_ids=None, failed_ids=None,
                     lease_epoch=-1):
        self.calls.append("lease")
        if not self._lease_supported:
            return self._msg.SimpleResponse(success=False, reason="unknown")
        g = self._tm.lease_shards(self._nid, name, count, done_ids=done_ids,
                                  failed_ids=failed_ids,
                                  lease_epoch=lease_epoch)
        return self._msg.ShardLeaseResponse(
            tasks=g.tasks, lease_epoch=g.lease_epoch, deadline_ts=g.deadline,
            acked=g.acked, idle=g.idle, exhausted=g.exhausted)

    def get_task(self, name):
        self.calls.append("get_task")
        return self._tm.get_dataset_task(self._nid, name)

    def report_task_result(self, name, task_id, success=True,
                           lease_epoch=-1):
        self.calls.append("report")
        return self._tm.report_dataset_task(name, task_id, success,
                                            lease_epoch=lease_epoch)

    def get_shard_checkpoint(self, name):
        self.calls.append("ckpt")
        ck = self._tm.checkpoint_dataset(name)
        return ck.to_json() if ck else ""


def _client_run(tm_mod, msg_mod, data_mod, lease_supported, fail_at):
    tm = tm_mod.TaskManager(clock=Clock(), lease_ttl=30.0)
    fake = _FakeMaster(tm, msg_mod, lease_supported=lease_supported)
    client = data_mod.ShardingClient("ds", master_client=fake, lease_count=3)
    client.register_dataset(1000, 100, num_epochs=1, shuffle=True)
    spans = []
    while True:
        task = client.fetch_task()
        if task is None:
            break
        spans.append((task.task_id, task.shard_start, task.shard_end))
        client.report_task_done(success=len(spans) != fail_at)
    ckpt = json.loads(client.checkpoint_shards())
    return spans, fake.calls, ckpt, tm.completed_records("ds")


@pytest.mark.parametrize("lease_supported", [True, False],
                         ids=["leases", "per-task fallback"])
def test_sharding_client_matches_jax(lease_supported):
    pout = _client_run(ptm, pmsg, pdata, lease_supported, fail_at=4)
    jout = _client_run(jtm, jmsg, jdata, lease_supported, fail_at=4)
    assert pout == jout
    spans, calls, ckpt, completed = pout
    assert completed == 1000 and ckpt["completed_records"] == 1000
    assert len(spans) == 11  # ten shards, the failed one delivered again
    if lease_supported:
        assert "get_task" not in calls and "report" not in calls
    else:
        assert calls.count("lease") == 1 and "get_task" in calls
