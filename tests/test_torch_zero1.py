"""ZeRO-1 on pure dp and the DeviceMesh, on the CPU (gloo).

The port's ``parallel/`` and ``train/zero1.py`` against the JAX package's:

- the sharding rule (``partition_spec``, ``strip_spec``, ``scatter_dim``,
  ``spec_has_dp``), ``mode_for`` and ``enabled``, and ``MeshConfig``'s
  ``resolve``/``auto``/``remesh``/``validate_divisibility``, over grids of
  specs, shapes and axis sizes, case by case;
- tiny Llama trained 4 steps at dp2 under zero-1 in two gloo ranks, at
  accum 2 and at accum 1: the losses and final params match the JAX
  trainer's zero-1 ``"scatter"`` run on a dp2 mesh of two CPU devices and
  the port's own replicated dp2 run (the dp2 tests' tolerances), and each
  rank holds half of the replicated moment bytes; at dp4, in four ranks,
  the layers' moments shard their second dim (the leading one, 2 layers,
  does not divide by 4) and hold a quarter;
- a toy tree of a dim-0 leaf, a dim-1 leaf and two leaves with no
  divisible dim, trained at dp2 under zero-1 and replicated;
- the checkpoint ownership plan of a zero-1 state, piece for piece the
  JAX ``plan_for_state`` of the JAX zero-1 state, at dp2 and dp4;
- a dp2 zero-1 checkpoint restored bitwise at dp2, into a replicated dp2
  target and at dp1; a dp4 zero-1 checkpoint and a replicated dp1 one
  restored into dp2 zero-1; across the packages both ways;
- ``WorldDescriptor.from_mesh`` on a real ``DeviceMesh``.

Every process group forms on a ``TCPStore`` the test hosts on port 0.
The batches give each rank's rows as many valid targets: the JAX scatter
step averages the ranks' local loss means, the port keeps the global
token mean of its replicated step (ROADMAP's known differences), and the
two agree there.
"""

import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dlrover_tpu.checkpoint import ownership as jownership
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.common import flags as jflags
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.parallel import sharding as jsharding
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu.train import zero1 as jzero1
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import (
    params_from_jax,
    train_state_to_numpy,
)
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import sharding as tsharding
from dlrover_tpu_torch.run import llama_pretrain
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train import zero1 as tzero1
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60
WAIT_S = 240
TC = dict(micro_batch_size=2, learning_rate=1e-2, warmup_steps=2,
          total_steps=4)
# global batch -> accum at dp2 (micro 2): 8 -> 2, 4 -> 1
GLOBAL_BATCHES = (8, 4)
SEQ = 16
CKPT_STEP = 4       # the dp2 run saves its zero-1 state after step 4
DP4_CKPT_STEP = 2   # the dp4 run saves after step 2


# -- the rule, ``mode_for`` and ``MeshConfig`` against the JAX package ---------


def _jspec(spec):
    return None if spec is None else tuple(spec)


RULE_CASES = [
    # (spec, shape, axis sizes)
    ((), (8, 4), {"dp": 2}),                      # dim 0
    ((), (2, 64, 32), {"dp": 4}),                 # dim 1: 2 % 4
    ((), (3, 5), {"dp": 2}),                      # no divisible dim
    ((), (3,), {"dp": 2}),                        # a 1-d fallback
    ((), (), {"dp": 4}),                          # a scalar
    ((), (0, 4), {"dp": 2}),                      # a zero-sized dim skipped
    ((), (8, 4), {"dp": 1}),                      # dp 1: nothing shards
    (("fsdp",), (8, 4), {"dp": 2, "fsdp": 2}),    # appended after fsdp
    (("fsdp",), (6, 4), {"dp": 2, "fsdp": 2}),    # 6/2 = 3: dim 1
    ((None, "tp"), (4, 8), {"dp": 4, "tp": 2}),   # dim 0 before tp's dim
    ((None, "tp"), (3, 8), {"dp": 2, "tp": 2}),   # tp's dim, 8/2 = 4
    (("dp",), (8, 4), {"dp": 2}),                 # idempotent
    (((("fsdp", "dp")),), (8, 4), {"dp": 2, "fsdp": 2}),
]


@pytest.mark.parametrize("spec,shape,sizes", RULE_CASES)
def test_partition_rule_matches_jax(spec, shape, sizes):
    jz = jzero1.partition_spec(P(*spec), shape, sizes)
    tz = tzero1.partition_spec(spec, shape, sizes)
    assert tz == _jspec(jz)
    assert tzero1.scatter_dim(spec, shape, sizes) == jzero1.scatter_dim(
        P(*spec), shape, sizes)
    assert tzero1.spec_has_dp(spec) == jzero1.spec_has_dp(P(*spec))
    if jz is not None:
        assert tzero1.spec_has_dp(tz) and jzero1.spec_has_dp(jz)
        assert tzero1.strip_spec(tz) == tuple(jzero1.strip_spec(jz))


class _Mesh:
    """A mesh as the JAX ``mode_for`` reads one: ``.shape`` names sizes."""

    def __init__(self, sizes):
        self.shape = sizes
        self.axis_names = tuple(sizes)


MODE_CASES = [
    {"dp": 1}, {"dp": 2}, {"dp": 4, "pp": 1, "tp": 1},
    {"dp": 1, "fsdp": 4}, {"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2},
    {"dp": 2, "sp": 2}, {"dp": 2, "ep": 2}, {"dp": 2, "pp": 2},
]


@pytest.mark.parametrize("sizes", MODE_CASES,
                         ids=lambda s: "x".join(f"{a}{n}" for a, n in
                                                s.items()))
@pytest.mark.parametrize("on", [False, True])
def test_mode_for_matches_jax_or_refuses(sizes, on):
    """Off, scatter and gspmd beside fsdp, sp or tp as the JAX package
    gives them; where the JAX package would run ``"gspmd"`` beside ep (or,
    for pp, replicated), the port raises."""
    jtc = jtrainer.TrainConfig(zero1=on)
    want = jzero1.mode_for(_Mesh(sizes), jtc, has_factory=True)
    tc = TrainConfig(zero1=on)
    full = {a: sizes.get(a, 1) for a in tmesh.AXIS_ORDER}
    beside = {a for a, n in full.items() if a != "dp" and n > 1}
    if (want == "gspmd" and not beside <= {"fsdp", "sp", "tp"}) or (
            want == "off" and on and sizes.get("dp", 1) > 1):
        with pytest.raises(ValueError, match="only pure dp"):
            tzero1.mode_for(full, tc)
    else:
        assert tzero1.mode_for(full, tc) == want
        assert tzero1.mode_for(tmesh.MeshConfig(**full), tc) == want


@pytest.mark.parametrize("flag", ["", "0", "1", "yes"])
@pytest.mark.parametrize("knob", [False, True])
def test_enabled_reads_the_flag_as_jax(flag, knob, monkeypatch):
    monkeypatch.setenv(jflags.ZERO1.name, flag)
    assert tzero1.enabled(TrainConfig(zero1=knob)) == jzero1.enabled(
        jtrainer.TrainConfig(zero1=knob))


MESH_CASES = [
    (dict(dp=-1), 8), (dict(dp=-1, tp=2), 8), (dict(dp=2, fsdp=2), 4),
    (dict(dp=-1, sp=3), 8), (dict(dp=3), 4), (dict(dp=2, pp=2, tp=2), 8),
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("raises", str(e))


def _as_tuple(cfg):
    return cfg if isinstance(cfg, tuple) else dataclasses.astuple(cfg)


@pytest.mark.parametrize("axes,n", MESH_CASES)
def test_mesh_config_matches_jax(axes, n):
    """``resolve``, ``shape``, ``data_parallel_size``, ``remesh`` onto
    several worlds and ``auto`` both ways: the same values, or the same
    refusal."""
    j, t = jmesh.MeshConfig(**axes), tmesh.MeshConfig(**axes)
    jr, tr = _outcome(lambda: j.resolve(n)), _outcome(lambda: t.resolve(n))
    assert _as_tuple(tr) == _as_tuple(jr)
    if isinstance(jr, tuple):
        return
    assert tr.shape() == jr.shape()
    assert tr.data_parallel_size == jr.data_parallel_size
    for world in (1, 2, 4, 6, 8, 16):
        assert _as_tuple(_outcome(lambda: tmesh.remesh(tr, world))) == \
            _as_tuple(_outcome(lambda: jmesh.remesh(jr, world)))
    for fsdp in (False, True):
        kw = dict(tp=t.tp, sp=t.sp, pp=t.pp, prefer_fsdp=fsdp)
        assert _as_tuple(_outcome(lambda: tmesh.MeshConfig.auto(n, **kw))) \
            == _as_tuple(_outcome(lambda: jmesh.MeshConfig.auto(n, **kw)))


@pytest.mark.parametrize("cfg", [dict(tp=2), dict(sp=4), dict(pp=3),
                                 dict(tp=4), dict()])
def test_validate_divisibility_matches_jax(cfg):
    dims = dict(n_heads=8, n_kv_heads=2, seq_len=64, vocab=256, n_layers=4)
    j = _outcome(lambda: jmesh.validate_divisibility(
        jmesh.MeshConfig(dp=1, **cfg), **dims))
    t = _outcome(lambda: tmesh.validate_divisibility(
        tmesh.MeshConfig(dp=1, **cfg), **dims))
    assert t == j


@pytest.mark.parametrize("spec,shape,sizes", [
    (("fsdp", "tp"), (8, 6), {"dp": 1, "fsdp": 4, "tp": 4}),
    ((("fsdp", "dp"), None), (8, 6), {"dp": 2, "fsdp": 2}),
    ((None, "tp"), (3, 4), {"dp": 2, "tp": 2}),
])
def test_batch_spec_and_spec_for_resize_match_jax(spec, shape, sizes):
    for seq in (False, True):
        assert tsharding.batch_spec(seq) == tuple(jsharding.batch_spec(seq))
    got = tsharding.spec_for_resize(spec, sizes, shape)
    want = jsharding.spec_for_resize(P(*spec), _Mesh(sizes), shape)
    assert got == tuple(want)


def test_pad_batch_to_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (3, 5)).astype(np.int32)
    x = rng.normal(size=(3, 2)).astype(np.float32)
    got = tsharding.pad_batch_to(
        {"ids": torch.from_numpy(ids), "x": torch.from_numpy(x)}, 4)
    want = jsharding.pad_batch_to({"ids": jnp.asarray(ids),
                                   "x": jnp.asarray(x)}, 4)
    for k in ("ids", "x"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trainer_refuses_zero1_on_a_mixed_mesh(monkeypatch):
    """No silent replicated run: zero-1 asked for on a dp2 x ep2 mesh
    (ep is a later slice; beside fsdp, sp or tp zero-1 runs "gspmd")
    raises when the state is built."""
    monkeypatch.setattr(bootstrap, "process_count", lambda: 4)
    cfg = tllama.LlamaConfig.tiny()
    tr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg),
                        TrainConfig(global_batch_size=8, zero1=True),
                        mesh={**{a: 1 for a in tmesh.AXIS_ORDER},
                              "dp": 2, "ep": 2})
    with pytest.raises(ValueError, match="only pure dp"):
        tr.init_state(tllama.init_params(cfg,
                                         torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("flag,logged", [("", True), ("0", False)])
def test_llama_pretrain_zero1_at_dp1_runs_replicated(flag, logged,
                                                     monkeypatch):
    """``--zero1`` at dp 1 runs the replicated update and says so; the
    flag overrides the option."""
    monkeypatch.setenv(jflags.ZERO1.name, flag)
    lines = []
    res = llama_pretrain.run(llama_pretrain.parse_args(
        ["--device", "cpu", "--model", "tiny", "--steps", "1", "--seq",
         "16", "--zero1"]), log=lines.append)
    assert res["zero1_mode"] == "off"
    assert ("zero-1 mode off at dp 1" in lines) == logged


# -- two and four gloo ranks -----------------------------------------------------

JOIN = """\
import datetime, os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
store = dist.TCPStore(os.environ["STORE_HOST"], int(os.environ["STORE_PORT"]),
                      world, is_master=False,
                      timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
from dlrover_tpu_torch.checkpoint import ownership
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.shm_handler import flatten_state
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.common.world import WorldDescriptor
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.parallel.sharding import spec_of
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = llama.LlamaConfig.tiny()
mesh = bootstrap.worker_mesh("cpu")
out = {"rank": rank}


def make(gb, z1, loss=None, sums=None):
    tc = TrainConfig(global_batch_size=gb, zero1=z1, **inp["tc"])
    return ElasticTrainer(loss or (lambda p, t: llama.loss_fn(p, t, cfg)), tc,
                          sums or (lambda p, t: llama.loss_sums(p, t, cfg)),
                          mesh=mesh if z1 else None)


def llama_state(gb, z1):
    tr = make(gb, z1)
    return tr, tr.init_state(params_from_jax(inp["params"], "cpu"))


def train(tr, state, batches):
    losses = []
    for batch in batches:
        state, loss = tr.step(state, tr.local_rows(torch.from_numpy(batch)
                                                   .long()))
        losses.append(loss.item())
    return state, losses


def local_bytes(tree):
    return sum(v.to_local().nbytes if hasattr(v, "to_local") else v.nbytes
               for _, v in flatten(tree))


def layout(tree):
    return {k: (spec_of(v) if hasattr(v, "to_local") else None)
            for k, v in flatten(tree)}


def np_of(t):
    return t.detach().cpu().numpy().copy()


def full_state(state):
    # every leaf's whole value by its JAX name (a DTensor gathered)
    named = {}
    for leaf in flatten_state(state):
        v = leaf.value
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        named[leaf.name] = np_of(v) if isinstance(v, torch.Tensor) \\
            else np.array(v)
    return named


def local_state(state):
    # this rank's part of every leaf: (its global ranges, its values)
    named = {}
    for leaf in flatten_state(state):
        v = leaf.value
        if hasattr(v, "to_local"):
            region = ownership.leaf_layout(v)[1]
            mine = [r for r, ranks in region.items() if rank in ranks][0]
            named[leaf.name] = (mine, np_of(v.to_local()))
        else:
            arr = np_of(v) if isinstance(v, torch.Tensor) else np.array(v)
            named[leaf.name] = (tuple((0, d) for d in arr.shape), arr)
    return named


def plan_of(state):
    plan = ownership.plan_for_state(
        [(leaf.name, leaf.value) for leaf in flatten_state(state)], world)
    ownership.validate_plan(plan)
    return {k: [(a.ranges, a.owner, a.replicas, a.parent_ranges) for a in v]
            for k, v in plan.items()}


def restore(ckpt_dir, job, z1, gb=8):
    _, target = llama_state(gb, z1)
    for _, p in flatten(target["params"]):
        p.detach().zero_()
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False)
    got = eng.load(target=target)
    tier = eng.last_restore_stats.get("tier")
    eng.close()
    return got[0], tier, target
"""

DP2 = JOIN + """\
# the trajectories: replicated, then zero-1 from the same init
for gb in GLOBAL_BATCHES:
    for z1 in (False, True):
        tr, state = llama_state(gb, z1)
        state, losses = train(tr, state, inp["batches"][gb])
        out[(gb, z1)] = {
            "losses": losses, "params": params_to_numpy(state["params"]),
            "mode": tr.zero1_mode, "moment_bytes": local_bytes(
                {"mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}),
            "layout": layout(state["opt"]["mu"]),
            "world": tr.world_descriptor().spec,
            "nu": None if z1 else params_to_numpy(state["opt"]["nu"]),
        }
        if z1 and gb == GLOBAL_BATCHES[0]:
            z1_state = state
out["plan"] = plan_of(z1_state)
out["from_mesh"] = WorldDescriptor.from_mesh(mesh).spec
WorldDescriptor.from_axis_sizes({"dp": world}).check_mesh(mesh)

# the placement helpers: a tree placed per its specs, then replicated
from dlrover_tpu_torch.parallel import sharding
tree = {"a": torch.arange(12.).reshape(4, 3),
        "b": {"c": torch.arange(8.).reshape(2, 4)}}
specs = {"a": ("dp",), "b": {"c": (None, "dp")}}
placed = sharding.shard_pytree(mesh, specs, tree)
out["placed"] = {k: (spec_of(v), np_of(v.to_local()))
                 for k, v in flatten(placed)}
out["placements"] = {k: [str(p) for p in v] for k, v in flatten(
    sharding.named_placements(mesh, specs))}
whole = sharding.with_constraints(placed, {"a": (), "b": {"c": ()}})
out["whole"] = {k: np_of(v.to_local()) for k, v in flatten(whole)}

# the toy tree: a dim-0 leaf, a dim-1 leaf, two with no divisible dim
def toy_sums(p, x):
    h = torch.tanh(x.float() / 7.0 @ p["a"]) @ p["b"].T + p["c"]
    y = h @ p["e"].T
    return (y - 1).square().sum(), torch.tensor(float(y.numel()))

for z1 in (False, True):
    g = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(6, 4, generator=g), "b": torch.randn(
        3, 4, generator=g), "c": torch.randn(3, generator=g),
        "e": torch.randn(5, 3, generator=g)}
    tr = make(8, z1, lambda p, x: toy_sums(p, x)[0], toy_sums)
    state = tr.init_state(params)
    losses = []
    for batch in inp["toy"]:
        state, loss = tr.step(state, tr.local_rows(torch.from_numpy(batch)))
        losses.append(loss.item())
    out[("toy", z1)] = {"losses": losses, "layout": layout(state["opt"]["mu"]),
                        "params": {k: np_of(v) for k, v in flatten(
                            state["params"])}}

# checkpoints: the zero-1 state after step 4, saved and restored
job = inp["job"]
eng = CheckpointEngine(inp["dp2_dir"], job_name=job, node_id=0,
                       process_id=rank, async_staging=False)
eng.save_to_storage(CKPT_STEP, z1_state)
out["staged_bytes"] = eng.last_stage_stats["staged_bytes"]
eng.close()
dist.barrier()
out["saved"] = full_state(z1_state)
out["saved_local"] = local_state(z1_state)
step, tier, target = restore(inp["dp2_dir"], job, True)
out["dp2_into_zero1"] = (step, tier, local_state(target))
step, tier, target = restore(inp["dp2_dir"], job, False)
out["dp2_into_replicated"] = (step, tier, full_state(target))
for case in ("dp4", "replicated", "jax"):
    step, tier, target = restore(*inp[case], True)
    out[case + "_into_zero1"] = (step, tier, local_state(target))
# one step on from the dp4 checkpoint's state
tr, _ = llama_state(8, True)
_, _, target = restore(*inp["dp4"], True)
_, losses = train(tr, target, inp["batches"][8][:1])
out["dp4_next_loss"] = losses[0]
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

DP4 = JOIN + """\
for z1 in (False, True):
    tr, state = llama_state(8, z1)
    # the dp2 global batches of 8 rows as dp4's: accum 1, 8 rows a step
    batches = inp["batches"][8][:DP4_CKPT_STEP]
    state, losses = train(tr, state, batches.reshape(DP4_CKPT_STEP, 1, 8, -1))
    out[z1] = {"losses": losses, "params": params_to_numpy(state["params"]),
               "nu": None if z1 else params_to_numpy(state["opt"]["nu"]),
               "moment_bytes": local_bytes({"mu": state["opt"]["mu"],
                                            "nu": state["opt"]["nu"]}),
               "layout": layout(state["opt"]["mu"])}
out["plan"] = plan_of(state)
out["saved"] = full_state(state)
ckpt_dir, job = inp["dp4"]
eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0, process_id=rank,
                       async_staging=False)
eng.save_to_storage(DP4_CKPT_STEP, state)
eng.close()
dist.barrier()
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""


def _script(body):
    for name in ("PG_TIMEOUT_S", "GLOBAL_BATCHES", "DP4_CKPT_STEP",
                 "CKPT_STEP"):
        body = body.replace(name, repr(globals()[name]))
    return body + "\ndist.destroy_process_group()\n"


def _run_ranks(body, world, inp, out):
    """Run ``body`` as ranks 0..world-1 of a gloo group on a store this
    process hosts; returns each rank's pickled ``out``."""
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, None, True,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S),
        wait_for_workers=False)
    env = dict(os.environ, STORE_HOST="127.0.0.1", STORE_PORT=str(store.port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(jflags.ZERO1.name, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _script(body), str(inp), str(out)],
        cwd=REPO_ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=WAIT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _jax_named(state):
    """{keystr: numpy array} of a JAX state, in flatten order."""
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(state))[0]
    }


def _as_np(want):
    return want.astype(np.float32) if want.dtype == ml_dtypes.bfloat16 \
        else want


def _jax_trainer(world, gb, zero1_on):
    cfg = jllama.LlamaConfig.tiny()
    mc = jmesh.MeshConfig(dp=world)
    mesh = jmesh.build_mesh(mc, devices=jax.devices()[:world])
    return jtrainer.ElasticTrainer(
        None, jllama.param_specs(cfg), mesh, mc,
        jtrainer.TrainConfig(global_batch_size=gb, zero1=zero1_on, **TC),
        loss_factory=lambda m: (lambda p, t: jllama.loss_fn(p, t, cfg, m)))


def _jax_init(tr, np_params):
    """The JAX trainer's state around ``np_params`` placed on its mesh."""
    specs = jllama.param_specs(jllama.LlamaConfig.tiny())
    return tr.init_state(jax.device_put(
        jax.tree.map(jnp.asarray, np_params),
        jsharding.named_shardings(tr.mesh, specs)))


def _jax_plan(state, world):
    plan = jownership.plan_for_state(state, proc_of=lambda d: d.id,
                                     world=world)
    return {k: [(a.ranges, a.owner, a.replicas, a.parent_ranges) for a in v]
            for k, v in plan.items()}


class _Runs:
    """Both packages' runs, once for the module: the JAX dp2 zero-1
    trajectories and checkpoint, the port's replicated dp1 checkpoint,
    the dp4 ranks, then the dp2 ranks (which restore every checkpoint)."""

    def __init__(self):
        self.jobs = []

    def run(self, root):
        cfg = jllama.LlamaConfig.tiny()
        self.np_params = jax.tree.map(
            np.asarray, jllama.init_params(cfg, jax.random.key(2)))
        rng = np.random.default_rng(7)
        self.batches = {gb: rng.integers(0, cfg.vocab_size, (
            4, gb // 4, 4, SEQ)).astype(np.int32) for gb in GLOBAL_BATCHES}
        toy = np.random.default_rng(9).integers(0, 10, (3, 2, 4, 6))
        # the JAX zero-1 runs (dp2 on two CPU devices, "scatter")
        self.jax = {}
        for gb in GLOBAL_BATCHES:
            tr = _jax_trainer(2, gb, True)
            assert tr._zero1_mode(tr.mesh) == "scatter"
            state = _jax_init(tr, self.np_params)
            losses = []
            for i, batch in enumerate(self.batches[gb]):
                state, loss = tr.step(state, jnp.asarray(batch))
                losses.append(float(loss))
                if gb == GLOBAL_BATCHES[0] and i == 1:
                    # saved before the next step donates the state
                    self.jax_saved = _jax_named(state)
                    jdir, jjob = self._job(root, "jax")
                    eng = JaxEngine(jdir, job_name=jjob, node_id=0,
                                    process_id=0)
                    eng.save_to_storage(2, state)
                    eng.wait_staging()
                    eng.close(unlink_shm=True)
            self.jax[gb] = {"losses": losses,
                            "params": jax.device_get(state["params"]),
                            "nu": jax.device_get(state["opt"][1][0].nu)}
        self.jax_plans = {w: _jax_plan(_jax_init(
            _jax_trainer(w, 8, True), self.np_params), w) for w in (2, 4)}
        # the port's replicated state at dp1, saved after 2 steps
        rdir, rjob = self._job(root, "replicated")
        tr = ElasticTrainer(
            lambda p, t: tllama.loss_fn(p, t, tllama.LlamaConfig.tiny()),
            TrainConfig(global_batch_size=4, **TC))
        state = tr.init_state(params_from_jax(self.np_params, "cpu"))
        for batch in self.batches[4][:2]:
            state, _ = tr.step(state, torch.from_numpy(
                batch.reshape(2, 2, SEQ)).long())
        self.replicated_saved = train_state_to_numpy(state)
        eng = CheckpointEngine(rdir, job_name=rjob, node_id=0, process_id=0,
                               async_staging=False)
        eng.save_to_storage(2, state)
        eng.close()
        inp = {"params": self.np_params, "batches": self.batches, "tc": TC,
               "toy": toy, "dp4": self._job(root, "dp4"),
               "replicated": (rdir, rjob), "jax": (jdir, jjob)}
        self.dp2_dir, self.dp2_job = self._job(root, "dp2")
        inp["job"] = self.dp2_job
        inp["dp2_dir"] = self.dp2_dir
        with open(root / "in.pkl", "wb") as f:
            pickle.dump(inp, f)
        self.dp4 = _run_ranks(DP4, 4, root / "in.pkl", root / "dp4.pkl")
        self.dp2 = _run_ranks(DP2, 2, root / "in.pkl", root / "dp2.pkl")

    def _job(self, root, label):
        job = f"tz1-{label}-{uuid.uuid4().hex[:8]}"
        self.jobs.append(job)
        return str(root / label), job

    def cleanup(self):
        for job in self.jobs:
            for pid in range(4):
                h = SharedMemoryHandler(shm_name(job, 0, pid))
                if h.attach():
                    h.close(unlink=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.delenv(jflags.ZERO1.name, raising=False)
    # no speculative neighbour-world compiles behind the JAX runs
    monkeypatch_module.setenv(jflags.WARM_COMPILE.name, "0")
    r = _Runs()
    try:
        r.run(tmp_path_factory.mktemp("zero1"))
        yield r
    finally:
        r.cleanup()  # the segments, also after a failed run


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


# adam's denominator sqrt(nu) below this: the gradient is at the level of
# f32 noise (eps = 1e-8 sets the update's size and the noise its sign)
NOISE_DENOM = 1e-7


def _close(got, want, nu, msg=""):
    """The dp2 tests' tolerances, params within rtol 2e-2 and atol 1e-4 of
    ``want`` (adam amplifies small gradient differences), except where the
    reference's last ``nu`` says the gradient is f32 noise: the two runs'
    noise differs, and adam's update there, from 0 to about the learning
    rate, with it, so those elements are held to one step at the peak
    learning rate."""
    lr = TC["learning_rate"]
    for (path, a), (_, b), (_, v) in zip(flatten(want), flatten(got),
                                         flatten(nu)):
        noise = np.sqrt(np.asarray(v, np.float64)) < NOISE_DENOM
        np.testing.assert_allclose(b[~noise], a[~noise], rtol=2e-2,
                                   atol=1e-4, err_msg=f"{msg} {path}")
        assert np.abs(b[noise] - a[noise]).max(initial=0.0) <= lr, \
            (msg, path)


@pytest.mark.parametrize("gb", GLOBAL_BATCHES, ids=["accum2", "accum1"])
def test_dp2_zero1_trajectory_matches_jax(runs, gb):
    """Four steps of tiny Llama at dp2 under zero-1: both ranks' losses and
    params equal, the losses within rtol 1e-4 of the JAX scatter run's
    and the params within the dp2 tests' tolerances."""
    r0, r1 = (r[(gb, True)] for r in runs.dp2)
    assert r0["mode"] == "scatter" and r0["world"] == "dp2+zero1"
    assert r0["losses"] == r1["losses"]
    for (path, a), (_, b) in zip(flatten(r0["params"]),
                                 flatten(r1["params"])):
        assert np.array_equal(a, b), path
    np.testing.assert_allclose(r0["losses"], runs.jax[gb]["losses"],
                               rtol=1e-4)
    _close(r0["params"], runs.jax[gb]["params"], runs.jax[gb]["nu"],
           "vs JAX")


@pytest.mark.parametrize("gb", GLOBAL_BATCHES, ids=["accum2", "accum1"])
def test_dp2_zero1_matches_the_replicated_run(runs, gb):
    """The same four steps replicated in the same ranks: the losses
    within rtol 1e-4 and the params within the dp2 tolerances; the
    replicated run keeps whole moments and says ``dp2``."""
    for r in runs.dp2:
        z, rep = r[(gb, True)], r[(gb, False)]
        assert rep["mode"] == "off" and rep["world"] == "dp2"
        np.testing.assert_allclose(z["losses"], rep["losses"], rtol=1e-4)
        _close(z["params"], rep["params"], rep["nu"], "vs replicated")


def test_each_rank_holds_its_share_of_the_moments(runs):
    """dp2: every moment shards its leading dim and a rank holds half the
    replicated bytes; dp4: the layers' leading dim (2) does not divide by
    4, so they shard their second, and a rank holds a quarter."""
    for r in runs.dp2:
        z, rep = r[(8, True)], r[(8, False)]
        assert z["moment_bytes"] * 2 == rep["moment_bytes"]
        assert set(z["layout"].values()) == {("dp",)}
        assert set(rep["layout"].values()) == {None}
    for r in runs.dp4:
        assert r[True]["moment_bytes"] * 4 == r[False]["moment_bytes"]
        lay = r[True]["layout"]
        assert {lay[k] for k in lay if k.startswith("layers/")} == {
            (None, "dp")}
        assert {lay[k] for k in lay if "/" not in k} == {("dp",)}


def test_dp4_zero1_matches_the_replicated_run(runs):
    """Two steps at dp4 under zero-1 and replicated: the same losses on
    every rank, within rtol 1e-4 of each other, params within the dp2
    tolerances, every rank's params bitwise equal."""
    first = runs.dp4[0]
    for r in runs.dp4:
        assert r[True]["losses"] == first[True]["losses"]
        for (path, a), (_, b) in zip(flatten(r[True]["params"]),
                                     flatten(first[True]["params"])):
            assert np.array_equal(a, b), path
    np.testing.assert_allclose(first[True]["losses"], first[False]["losses"],
                               rtol=1e-4)
    _close(first[True]["params"], first[False]["params"],
           first[False]["nu"], "dp4")


def test_toy_leaves_dim0_dim1_and_fallback(runs):
    """A dim-0 leaf (6 x 4), a dim-1 leaf (3 x 4) and two with no
    divisible dim (3, and 5 x 3), three steps at accum 2: the moments'
    layouts, and the zero-1 losses and params against the replicated
    run's (the fallbacks' gradients all-reduced whole, their norms
    counted once)."""
    for r in runs.dp2:
        z, rep = r[("toy", True)], r[("toy", False)]
        assert z["layout"] == {"a": ("dp",), "b": (None, "dp"), "c": None,
                               "e": None}
        np.testing.assert_allclose(z["losses"], rep["losses"], rtol=1e-5)
        for k in "abce":
            np.testing.assert_allclose(z["params"][k], rep["params"][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert runs.dp2[0][("toy", True)]["params"]["b"].tobytes() == \
        runs.dp2[1][("toy", True)]["params"]["b"].tobytes()


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_ownership_plan_matches_jax(runs, world):
    """The port's plan of its zero-1 state (the moments' regions from the
    DTensors, one owner a region, the counter untouched by them; the
    replicated params and scalars split round-robin) equals the JAX
    ``plan_for_state`` of the JAX zero-1 state, piece for piece."""
    ranks = runs.dp2 if world == 2 else runs.dp4
    assert all(r["plan"] == ranks[0]["plan"] for r in ranks)
    assert ranks[0]["plan"] == runs.jax_plans[world]


def test_world_from_a_device_mesh(runs):
    """``WorldDescriptor.from_mesh`` reads a real ``DeviceMesh``'s
    ``mesh_dim_names`` with its ``shape``; ``check_mesh`` accepts it."""
    assert {r["from_mesh"] for r in runs.dp2} == {"dp2"}


def test_specs_place_a_tree_on_the_mesh(runs):
    """``shard_pytree`` puts each rank's block of a dim-0 and a dim-1
    spec on it, ``spec_of`` reads the specs back, ``named_placements``
    names one placement a mesh dim, and ``with_constraints`` to the empty
    spec makes each leaf whole again."""
    a = np.arange(12.0).reshape(4, 3)
    c = np.arange(8.0).reshape(2, 4)
    for r in runs.dp2:
        k = r["rank"]
        assert r["placed"]["a"][0] == ("dp",)
        assert r["placed"]["b/c"][0] == (None, "dp")
        np.testing.assert_array_equal(r["placed"]["a"][1], a[2 * k:2 * k + 2])
        np.testing.assert_array_equal(r["placed"]["b/c"][1],
                                      c[:, 2 * k:2 * k + 2])
        assert r["placements"]["b/c"] == ["S(1)"] + ["R"] * 5
        np.testing.assert_array_equal(r["whole"]["a"], a)
        np.testing.assert_array_equal(r["whole"]["b/c"], c)


def _assert_local(got, full, label):
    """Each leaf's local part bitwise the same region of ``full``."""
    assert set(got) == set(full), label
    for name, (region, values) in got.items():
        want = _as_np(full[name])[tuple(slice(s, e) for s, e in region)]
        assert values.dtype == want.dtype and values.shape == want.shape, \
            (label, name)
        assert values.tobytes() == want.tobytes(), (label, name)


def test_dp2_zero1_checkpoint_restores_at_dp2(runs):
    """Every rank staged its own moments' half and half of the replicated
    leaves, and restores each local shard bitwise into a zero-1 target
    (its half from shm, the rest from disk), and whole leaves into a
    replicated target."""
    total = sum(v.nbytes for v in runs.dp2[0]["saved"].values())
    assert sum(r["staged_bytes"] for r in runs.dp2) == total
    for r in runs.dp2:
        step, tier, got = r["dp2_into_zero1"]
        assert step == CKPT_STEP and tier == "disk"
        _assert_local(got, r["saved"], "dp2 zero-1")
        _assert_local(r["saved_local"], r["saved"], "saved")
        step, tier, got = r["dp2_into_replicated"]
        assert step == CKPT_STEP
        assert {k: v.tobytes() for k, v in got.items()} == {
            k: v.tobytes() for k, v in r["saved"].items()}


def test_dp4_and_replicated_checkpoints_restore_into_dp2_zero1(runs):
    """A dp4 zero-1 checkpoint (each dp2 rank's region is two dp4 ranks'
    shards) and a replicated dp1 one restore bitwise into dp2 zero-1
    targets, and the dp4 state trains on."""
    dp4_saved = runs.dp4[0]["saved"]
    for r in runs.dp2:
        step, _, got = r["dp4_into_zero1"]
        assert step == DP4_CKPT_STEP
        _assert_local(got, dp4_saved, "dp4 -> dp2")
        step, tier, got = r["replicated_into_zero1"]
        assert step == 2 and tier == "disk"
        _assert_local(got, runs.replicated_saved, "dp1 -> dp2")
        assert np.isfinite(r["dp4_next_loss"])
    assert runs.dp2[0]["dp4_next_loss"] == runs.dp2[1]["dp4_next_loss"]


def test_dp2_zero1_checkpoint_restores_at_dp1(runs):
    """One process, no group: the dp2 checkpoint fills a replicated target
    from rank 0's shm pieces and the disk tier, bitwise."""
    cfg = tllama.LlamaConfig.tiny()
    tr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg),
                        TrainConfig(global_batch_size=4, **TC))
    target = tr.init_state(params_from_jax(runs.np_params, "cpu"))
    eng = CheckpointEngine(runs.dp2_dir, job_name=runs.dp2_job, node_id=0,
                           process_id=0, async_staging=False)
    try:
        step, restored = eng.load(target=target)
        assert step == CKPT_STEP
        assert eng.last_restore_stats["tiers_read"] == ["shm", "disk"]
    finally:
        eng.close()
    got = train_state_to_numpy(restored)
    assert {k: v.tobytes() for k, v in got.items()} == {
        k: v.tobytes() for k, v in runs.dp2[0]["saved"].items()}


def test_zero1_checkpoint_crosses_packages(runs):
    """The port's dp2 zero-1 checkpoint restores bitwise in the JAX
    package into its dp2 zero-1 state; the JAX package's dp2 zero-1
    checkpoint restores bitwise into the port's dp2 zero-1 ranks."""
    for r in runs.dp2:
        step, _, got = r["jax_into_zero1"]
        assert step == 2
        _assert_local(got, runs.jax_saved, "JAX -> port")
    target = _jax_init(_jax_trainer(2, 8, True), runs.np_params)
    eng = JaxEngine(runs.dp2_dir, job_name=runs.dp2_job + "-jax", node_id=0,
                    process_id=0)
    try:
        step, restored = eng.load(target=target)
    finally:
        eng.close(unlink_shm=True)
    assert step == CKPT_STEP
    got = _jax_named(restored)
    want = runs.dp2[0]["saved"]
    assert list(got) == list(want)
    for name in want:
        assert _as_np(got[name]).tobytes() == want[name].tobytes(), name
