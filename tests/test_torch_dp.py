"""Data parallelism and the data plane across processes, on the CPU (gloo).

(f) Two gloo processes train tiny Llama dp2 at accum 2, and at accum 1,
    for 4 steps, the ranks holding different numbers of valid targets
    (some targets -1): every loss and the final params match the JAX
    trainer on ``MeshConfig(dp=2)`` over two CPU devices, within the
    tolerances of ``tests/test_torch_trainer.py``'s trajectory test (losses
    rtol 1e-4; params rtol 2e-2, atol 1e-4), and the two ranks' params are
    bitwise equal. A trainer at dp 2 without ``loss_sums_fn``, or handed the global
    rows, refuses.
(g) ``ShardingClient`` in two gloo ranks under the port's master: both
    ranks receive the same tasks, and only the chief talks to the master.
(h) ``elastic_run --standalone --accelerator cpu --nproc_per_node 2`` runs
    ``run/llama_pretrain.py --device cpu --model tiny --data FILE --ckpt-dir
    D --save-every 2``; both workers are killed once step 3 is staged. The
    restarted pair restores step 3 (each rank's shm segment holds its half,
    the agent's breakpoint persist on disk the rest: tier disk), loads the
    sidecar of step 2 on both ranks, and trains on the batches the JAX
    sampler gives from that position (each rank its rows).
Also: a sidecar in the JAX example's JSON, written by hand, positions the
port's loader, and the port's sidecar positions the JAX loader; and the
checkpoint engine's restore gate in two gloo ranks: ranks that staged
different steps ignore shm, the committed step is the least any rank read,
a step is adopted only when every rank restored it, and a step a peer
cannot restore changes no tensor; and replica-deduplicated staging at dp2,
each rank staging half of the state, restored bitwise.

Every process group here forms on a ``TCPStore`` the test hosts on port 0,
with its own timeout.
"""

import datetime
import json
import os
import pickle
import shutil
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import MeshConfig, build_mesh
from dlrover_tpu.train import data as jdata
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common.ipc import default_socket_path
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.master.local_master import start_local_master
from dlrover_tpu_torch.run import llama_pretrain
from dlrover_tpu_torch.train.datasets import pack_tokens

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60
WAIT_S = 120

# the child's prologue: join the process group on the test's store
JOIN = """\
import datetime, json, os, pickle, sys
import torch
import torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
store = dist.TCPStore(os.environ["STORE_HOST"], int(os.environ["STORE_PORT"]),
                      world, is_master=False,
                      timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
""".replace("PG_TIMEOUT_S", str(PG_TIMEOUT_S))

TRAJECTORY = JOIN + """\
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = llama.LlamaConfig.tiny()
trainer = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg),
                         TrainConfig(**inp["tc"]),
                         lambda p, t: llama.loss_sums(p, t, cfg))
assert trainer.dp == 2
assert trainer.step_batch_shape == inp["batches"].shape[1:3]
state = trainer.init_state(params_from_jax(inp["params"], "cpu"))
losses = []
for batch in inp["batches"]:
    state, loss = trainer.step(
        state, trainer.local_rows(torch.from_numpy(batch).long()))
    losses.append(loss.item())
with open(sys.argv[2], "wb") as f:
    pickle.dump({"losses": losses,
                 "params": params_to_numpy(state["params"])}, f)
"""

SHARDS = JOIN + """\
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.train.data import ShardingClient
real = MasterClient(sys.argv[1], node_id=0)
calls = []

class Counting:
    def __getattr__(self, name):
        fn = getattr(real, name)
        def call(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return call

client = ShardingClient("ds", Counting(), lease_count=3)
client.register_dataset(100, 10, num_epochs=1, shuffle=True)
tasks = [(t.task_id, t.shard_start, t.shard_end, t.epoch)
         for t in client.iter_tasks()]
ckpt = client.checkpoint_shards()
print("RESULT " + json.dumps({"rank": rank, "tasks": tasks, "calls": calls,
                              "ckpt": json.loads(ckpt) if ckpt else None}),
      flush=True)
"""


def _run_ranks(script, args_for):
    """Run ``script`` as rank 0 and 1 of a gloo group on a store this
    process hosts (port 0); returns each rank's stdout."""
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, None, True,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
        wait_for_workers=False)
    env = dict(os.environ, STORE_HOST="127.0.0.1", STORE_PORT=str(store.port),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # the group is destroyed before the interpreter exits: gloo's threads
    # torn down at exit can abort the child
    script += "\ndist.destroy_process_group()\n"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args_for(rank)], cwd=REPO_ROOT,
        env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- (f) the dp2 trajectory ----------------------------------------------------


def _uneven_batches(cfg, accum):
    """4 steps of (accum, micro*dp = 4, seq 16) tokens, rank r's rows
    [2r, 2r + 2), the ranks holding different numbers of valid targets
    in every microbatch."""
    rng = np.random.default_rng(7)
    batches = rng.integers(0, cfg.vocab_size,
                           (4, accum, 4, 16)).astype(np.int32)
    batches[:, :, 3, 6:] = -1           # rank 1: a row mostly padding
    batches[:, -1, 2, 12:] = -1         # and a few more in the last
    batches[::2, 0, 0, 15] = -1         # rank 0: one pad in some steps
    valid = (batches[..., 1:] >= 0).sum(-1)
    assert (valid[..., :2].sum(-1) != valid[..., 2:].sum(-1)).all()
    return batches


def _dp2_matches_jax(tmp_path, global_batch):
    """Train tiny Llama 4 steps at dp 2, micro-batch 2, in two gloo ranks
    and in JAX on ``MeshConfig(dp=2)``; hold the port to JAX."""
    cfg = jllama.LlamaConfig.tiny()
    tc = dict(global_batch_size=global_batch, micro_batch_size=2,
              learning_rate=1e-2, warmup_steps=2, total_steps=4)
    accum = global_batch // 4
    np_params = jax.tree.map(
        np.asarray, jllama.init_params(cfg, jax.random.key(2)))
    batches = _uneven_batches(cfg, accum)

    mc = MeshConfig(dp=2, fsdp=1, sp=1, tp=1)
    mesh = build_mesh(mc, devices=jax.devices()[:2])
    jtr = jtrainer.ElasticTrainer(
        lambda p, t: jllama.loss_fn(p, t, cfg, mesh),
        jllama.param_specs(cfg), mesh, mc, jtrainer.TrainConfig(**tc))
    assert jtr.accum_steps == accum
    assert tuple(jtr.step_batch_shape) == (accum, 4)
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, np_params))
    j_losses = []
    for batch in batches:
        jstate, jl = jtr.step(jstate, jnp.asarray(batch))
        j_losses.append(float(jl))

    inp = tmp_path / "in.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"params": np_params, "batches": batches, "tc": tc}, f)
    _run_ranks(TRAJECTORY, lambda r: [str(inp), str(tmp_path / f"{r}.pkl")])
    outs = []
    for r in (0, 1):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    # the reduced loss and the params: the same on both ranks, bitwise
    assert outs[0]["losses"] == outs[1]["losses"]
    for (path, a), (_, b) in zip(flatten(outs[0]["params"]),
                                 flatten(outs[1]["params"])):
        assert np.array_equal(a, b), path
    np.testing.assert_allclose(outs[0]["losses"], j_losses, rtol=1e-4)
    j_final = flatten(jax.tree.map(np.asarray, jstate["params"]))
    for (path, a), (_, b) in zip(j_final, flatten(outs[0]["params"])):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)


def test_dp2_trajectory_with_uneven_valid_targets_matches_jax(tmp_path):
    _dp2_matches_jax(tmp_path, global_batch=8)  # accum 2


def test_dp2_trajectory_at_one_microbatch_matches_jax(tmp_path):
    """accum 1: the gradients are reduced in their own dtype, with no f32
    accumulator."""
    _dp2_matches_jax(tmp_path, global_batch=4)


def test_dp_needs_the_loss_sums(monkeypatch):
    """Above dp 1 the step takes the global token mean, so a trainer
    without ``loss_sums_fn`` refuses rather than average the ranks'
    means; a batch of the global rows is refused too."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.train import bootstrap
    from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    monkeypatch.setattr(bootstrap, "process_count", lambda: 2)
    monkeypatch.setattr(bootstrap, "process_index", lambda: 1)
    cfg = llama.LlamaConfig.tiny()
    tc = TrainConfig(global_batch_size=8, micro_batch_size=2)
    trainer = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg), tc)
    assert trainer.step_batch_shape == (2, 4) and trainer.rows == slice(2, 4)
    state = trainer.init_state(
        llama.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = torch.zeros((2, 4, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="this rank's micro_batch=2 rows"):
        trainer.step(state, batch)
    with pytest.raises(ValueError, match="needs a loss_sums_fn"):
        trainer.step(state, trainer.local_rows(batch))


# -- (g) the sharding client in two ranks ---------------------------------------


def test_sharding_client_two_ranks_under_the_port_master():
    master = start_local_master(node_num=1)
    try:
        outs = _run_ranks(SHARDS, lambda r: [f"127.0.0.1:{master.port}"])
    finally:
        master.stop()
    res = sorted((json.loads(line.split(" ", 1)[1]) for out in outs
                  for line in out.splitlines()
                  if line.startswith("RESULT ")), key=lambda x: x["rank"])
    assert [r["rank"] for r in res] == [0, 1]
    chief, other = res
    assert chief["tasks"] == other["tasks"]
    assert sorted(t[1:3] for t in chief["tasks"]) == [
        [s, s + 10] for s in range(0, 100, 10)]
    # only the chief spoke: params, leases, the final checkpoint
    assert other["calls"] == [] and other["ckpt"] is None
    assert chief["calls"][0] == "report_dataset_shard_params"
    assert set(chief["calls"][1:]) == {"lease_shards",
                                       "get_shard_checkpoint"}
    assert chief["ckpt"]["completed_records"] == 100
    assert master.task_manager.finished()


# -- the restore gate across ranks ------------------------------------------------

# five restores in two ranks, each from its own directory and segments:
# "disagree", the ranks staged different steps (4 and 3) over a committed
# step 2; "committed", no staged step and rank 1's read of the tracker
# raced the commit of step 4 (it read 2); "vote", both staged step 6, but
# rank 1 only the pieces it owns of a group of two (replica dedup) and
# nothing else holds the rest, so only rank 0 (dedup off) can restore it;
# "uncovered", the same staging with no committed step to fall back to,
# into a target of random values that no rank may change; "dedup", both
# ranks under the defaults (dedup on, the group's rank and size) stage and
# persist their halves of step 5 and restore it into zeroed targets
GATE = JOIN + """\
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
root, job = sys.argv[1], sys.argv[2]

def state(v):
    return {k: torch.full((4, 3), float(v)) for k in ("w", "b")}

def engine(case, **kw):
    return CheckpointEngine(os.path.join(root, case), job_name=f"{job}-{case}",
                            node_id=0, process_id=rank, async_staging=False,
                            **kw)

out = {}
def restore(eng, case):
    target = state(-1)
    got = eng.load(target)
    out[case] = {"step": None if got is None else got[0],
                 "values": sorted({float(t[0, 0]) for t in target.values()}),
                 "tier": eng.last_restore_stats.get("tier")}
    eng.close(unlink_shm=True)

eng = engine("disagree")
eng.save_to_storage(2, state(2))
dist.barrier()
eng.save_to_memory(4 - rank, state(4 - rank))
restore(eng, "disagree")

eng = engine("committed")
eng.save_to_storage(2, state(2))
dist.barrier()
eng.save_to_storage(4, state(4))
dist.barrier()
eng.close(unlink_shm=True)
eng = engine("committed")
if rank == 1:
    eng.committed_step = lambda: 2
restore(eng, "committed")

HALF = {"dedup": True, "ownership_world": (1, 2)}
eng = engine("vote", **({"dedup": False} if rank == 0 else HALF))
eng.save_to_storage(2, state(2))
dist.barrier()
eng.save_to_memory(6, state(6))
restore(eng, "vote")

eng = engine("uncovered", **({"dedup": False} if rank == 0 else HALF))
eng.save_to_memory(6, state(6))
gen = torch.Generator().manual_seed(11 + rank)
target = {k: torch.randn((4, 3), generator=gen) for k in ("w", "b")}
before = {k: t.clone() for k, t in target.items()}
got = eng.load(target)
out["uncovered"] = {
    "step": None if got is None else got[0],
    "unchanged": all(torch.equal(before[k], target[k]) for k in before)}
eng.close(unlink_shm=True)

def rich_state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 33), generator=gen),
            "b": torch.randn(7, generator=gen),
            "opt": {"mu": torch.randn((16, 16), generator=gen),
                    "nu": torch.randn((5, 3, 2), generator=gen)},
            "step": 5}

eng = engine("dedup")
saved = rich_state(3)  # the same replica on both ranks
eng.save_to_storage(5, saved)
stats = dict(eng.last_stage_stats)
dist.barrier()
target = rich_state(4)
for t in (target["w"], target["b"], *target["opt"].values()):
    t.zero_()
target["step"] = 0
got = eng.load(target)
leaves = [(saved["w"], target["w"]), (saved["b"], target["b"])] + [
    (saved["opt"][k], target["opt"][k]) for k in ("mu", "nu")]
out["dedup"] = {
    "step": None if got is None else got[0],
    "tier": eng.last_restore_stats.get("tier"),
    "staged": stats["staged_bytes"], "skipped": stats["skipped_replica_bytes"],
    "dedup": stats["dedup"],
    "tensor_bytes": sum(a.numel() * a.element_size() for a, _ in leaves),
    "bitwise": all(torch.equal(a, b) for a, b in leaves),
    "scalar": target["step"]}
eng.close(unlink_shm=True)
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def gated_restores(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    job = f"torch-gate-{uuid.uuid4().hex[:10]}"
    outs = _run_ranks(GATE, lambda r: [str(root), job])
    return [json.loads(line.split(" ", 1)[1]) for out in outs
            for line in out.splitlines() if line.startswith("RESULT ")]


def test_restore_ignores_shm_when_staged_steps_disagree(gated_restores):
    """Rank 0 staged step 4 and rank 1 step 3: neither restores its own
    segment; both take the committed step 2 from disk."""
    for res in gated_restores:
        assert res["disagree"] == {"step": 2, "values": [2.0],
                                   "tier": "disk"}


def test_restore_takes_the_least_committed_step(gated_restores):
    """Rank 1 read the tracker before the commit of step 4: both restore
    step 2, the step every rank saw committed."""
    for res in gated_restores:
        assert res["committed"]["step"] == 2
        assert res["committed"]["values"] == [2.0]


def test_restore_adopts_a_step_only_when_every_rank_restored_it(
        gated_restores):
    """Only rank 0 can restore the staged step 6: both fall back to the
    committed step 2."""
    assert len(gated_restores) == 2
    for res in gated_restores:
        assert res["vote"] == {"step": 2, "values": [2.0], "tier": "disk"}


def test_restore_a_peer_rejects_touches_no_tensor(gated_restores):
    """Both ranks staged step 6, only rank 0 can cover it, and nothing
    is committed: both restore nothing, and rank 0's target keeps every
    bit it had before ``load`` (the check is voted on before any
    placement)."""
    assert len(gated_restores) == 2
    for res in gated_restores:
        assert res["uncovered"] == {"step": None, "unchanged": True}


def test_dp_ranks_stage_half_and_restore_the_union(gated_restores):
    """Under the defaults a dp2 rank stages about half of a replicated
    state (the process group's rank and size, as the JAX engine takes
    jax's), and the two halves, one from this rank's shm and the rest
    from disk, restore every leaf bitwise on both ranks."""
    assert len(gated_restores) == 2
    # the state's bytes as the engine stages them (the tensors, and the
    # step scalar as its numpy value)
    total = {r["dedup"]["staged"] + r["dedup"]["skipped"]
             for r in gated_restores}
    assert len(total) == 1
    total = total.pop()
    staged = []
    for res in gated_restores:
        d = res["dedup"]
        assert d["dedup"] is True
        assert d["tensor_bytes"] < total <= d["tensor_bytes"] + 8
        assert 0.4 * total <= d["staged"] <= 0.6 * total, d
        assert d["step"] == 5 and d["tier"] == "disk"
        assert d["bitwise"] and d["scalar"] == 5
        staged.append(d["staged"])
    assert sum(staged) == total


# -- the sidecar ------------------------------------------------------------------


def _corpus(path, n_seq=40, seq=32):
    tokens = np.random.RandomState(3).randint(0, 256, n_seq * seq)
    pack_tokens(str(path), tokens.tolist(), "uint32")
    return tokens.reshape(n_seq, seq)


def _jax_batches(path, global_batch, seq, loader_state, n):
    """The JAX example's loader from ``loader_state``: its next ``n``
    batches, each (global_batch, seq)."""
    from dlrover_tpu.train.datasets import TokenFileDataset

    ds = TokenFileDataset(str(path), seq_len=seq, dtype="uint32")
    sampler = jdata.ElasticDistributedSampler(
        dataset_size=len(ds), batch_size=global_batch, num_replicas=1,
        rank=0, shuffle=True, seed=1)
    loader = jdata.ElasticDataLoader(ds, batch_size=global_batch,
                                     sampler=sampler)
    if loader_state is not None:
        loader.load_state_dict(loader_state)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


def test_sidecar_crosses_both_ways(tmp_path):
    corpus = tmp_path / "c.bin"
    _corpus(corpus)
    ckpt_dir = tmp_path / "ck"
    ckpt_dir.mkdir()
    args = llama_pretrain.parse_args([
        "--device", "cpu", "--model", "tiny", "--seq", "32",
        "--micro-batch", "2", "--global-batch", "4", "--data", str(corpus),
        "--data-dtype", "uint32", "--ckpt-dir", str(ckpt_dir)])
    cfg, trainer, *_ = llama_pretrain.build(args)
    # the JAX example's JSON, by hand: {"step", "loader": {...}}
    path = llama_pretrain.sidecar_path(str(ckpt_dir), 0)
    assert os.path.basename(path) == "loader_state-0.json"
    jax_side = {"step": 2, "loader": {"epoch": 0, "completed_samples": 8}}
    with open(path, "w") as f:
        json.dump(jax_side, f)
    batches, positions, restored = llama_pretrain.open_data(
        args, cfg, trainer, 32, "cpu", restored_step=3, log=lambda m: None)
    assert restored == 2
    want = _jax_batches(corpus, 4, 32, jax_side["loader"], 2)
    for w in want:
        got = next(batches)
        np.testing.assert_array_equal(got.numpy().reshape(4, 32), w)
    assert positions[0] == {"epoch": 0, "completed_samples": 12}
    # a sidecar ahead of the restored step, or a torn one, is not loaded
    assert llama_pretrain.read_sidecar(path, 1) is None
    with open(path, "w") as f:
        f.write('{"step": 2, "loa')
    assert llama_pretrain.read_sidecar(path, 3) is None
    # the port's sidecar positions the JAX example's loader
    llama_pretrain.write_sidecar(path, 4, positions[1])
    with open(path) as f:
        side = json.load(f)
    assert side == {"step": 4, "loader": {"epoch": 0,
                                          "completed_samples": 16}}
    assert not os.path.exists(path + ".tmp")
    want = _jax_batches(corpus, 4, 32, side["loader"], 1)[0]
    got = _jax_batches(corpus, 4, 32, None, 5)[4]
    np.testing.assert_array_equal(want, got)


# -- (h) two workers under the CLI, killed and restarted ----------------------------

# llama_pretrain's run, each step's batch recorded; the first life stops
# after step 3 (staged) and kills itself, the second trains on
WORKER = """\
import json, os, signal, sys
from dlrover_tpu_torch.run import llama_pretrain
batches = []
real = llama_pretrain.timed_step
def recording(trainer, state, batch):
    batches.append(batch.tolist())
    return real(trainer, state, batch)
llama_pretrain.timed_step = recording
args = llama_pretrain.parse_args(sys.argv[1:])
first = os.environ["DLROVER_TPU_RESTART_COUNT"] == "0"
if first:
    args.steps = 3
result = llama_pretrain.run(args)
print("RESULT " + json.dumps({
    "rank": int(os.environ["DLROVER_TPU_PROCESS_ID"]),
    "start_step": result["start_step"], "restore": result["restore"],
    "loader_restored": result["loader_restored"],
    "losses": result["losses"], "batches": batches}), flush=True)
if first:
    os.kill(os.getpid(), signal.SIGKILL)
"""


def _cleanup(job):
    for pid in (0, 1):
        h = SharedMemoryHandler(shm_name(job, 0, pid))
        if h.attach():
            h.close(unlink=True)
    shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)), ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(
        default_socket_path(job, 0))), ignore_errors=True)


def _result(job, pid, restart):
    with open(os.path.join(agent_log_dir(job, 0),
                           f"worker-{pid}-restart{restart}.log")) as f:
        log = f.read()
    lines = [x for x in log.splitlines() if x.startswith("RESULT ")]
    assert lines, log[-3000:]
    return json.loads(lines[-1].split(" ", 1)[1])


def test_two_workers_restart_from_shm_and_resume_the_loader(tmp_path):
    job = f"torch-dp-{uuid.uuid4().hex[:10]}"
    _cleanup(job)
    corpus = tmp_path / "c.bin"
    tokens = _corpus(corpus)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    ckpt_dir = tmp_path / "ck"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in [k for k in env if k.startswith("DLROVER_TPU_")
              and k != "DLROVER_TPU_LOG_LEVEL"]:
        del env[k]
    try:
        r = subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
             "--standalone", "--nnodes=1", "--nproc_per_node=2",
             "--accelerator", "cpu", f"--job_name={job}",
             "--max_restarts=1", "--monitor_interval", "0.2", str(worker),
             "--", "--device", "cpu", "--model", "tiny", "--seq", "32",
             "--micro-batch", "1", "--global-batch", "4", "--steps", "5",
             "--seed", "0", "--data", str(corpus), "--data-dtype", "uint32",
             "--ckpt-dir", str(ckpt_dir), "--save-every", "2"],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=WAIT_S)
        assert r.returncode == 0, r.stderr[-4000:]
        assert "breakpoint persist True" in r.stderr
        assert "local master exiting: succeeded" in r.stderr
        first = [_result(job, pid, 0) for pid in (0, 1)]
        second = [_result(job, pid, 1) for pid in (0, 1)]
    finally:
        _cleanup(job)
    # the global batch of each position, as the JAX example's sampler
    # gives it from the epoch's start: (accum 2, micro*dp 2, seq)
    want = _jax_batches(corpus, 4, 32, None, 5)
    want = [w.reshape(2, 2, 32) for w in want]
    for rank in (0, 1):
        rows = slice(rank, rank + 1)
        # the first life: positions 0-2; the reduced losses agree
        assert first[rank]["start_step"] == 0
        assert first[rank]["loader_restored"] is None
        for got, w in zip(first[rank]["batches"], want[:3]):
            np.testing.assert_array_equal(np.asarray(got), w[:, rows])
        # the second: step 3 from its shm half and the breakpoint persist
        # on disk, the loader from step 2's sidecar, so steps 4-5 replay
        # positions 2-3
        res = second[rank]
        assert res["start_step"] == 3
        assert res["restore"]["step"] == 3 and res["restore"]["tier"] == "disk"
        assert res["loader_restored"] == 2
        assert len(res["batches"]) == 2
        for got, w in zip(res["batches"], want[2:4]):
            np.testing.assert_array_equal(np.asarray(got), w[:, rows])
    assert first[0]["losses"] == first[1]["losses"]
    assert second[0]["losses"] == second[1]["losses"]
    # the file's rows, not a copy that drifted
    np.testing.assert_array_equal(want[0].reshape(4, 32),
                                  tokens[_jax_order(len(tokens))[:4]])


def _jax_order(n):
    sampler = jdata.ElasticDistributedSampler(
        dataset_size=n, batch_size=4, num_replicas=1, rank=0, shuffle=True,
        seed=1)
    return sampler._global_order()
