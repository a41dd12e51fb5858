"""Tensor parallelism and the "gspmd" zero-1 beside it on the CPU (gloo),
against the JAX package.

- the lookup on a mesh embeds an id outside the vocabulary as zeros, as
  the JAX one-hot form does, and wraps without one, as the JAX gather
  does; the fsdp2 and tp2 losses of a batch with a ``-1`` before a valid
  target equal the JAX losses on a mesh of the same shape;
- the f/g Functions' forward and backward on known tensors; the lm-head's
  tp gather gives each rank its own columns of the gradient, not tp times
  them; a tp rank's local heads attend to the kv heads of the whole layer
  (the GQA group is the same locally); ``remat_policy="mlp"`` keeps the
  two local ffn products and recomputes ``w_down``'s;
- tiny Llama trained 4 steps at tp2, dp2 x tp2, fsdp2 x tp2, dp2 x tp2
  under zero-1 (``"gspmd"``) and, in eight ranks, dp2 x fsdp2 x tp2 under
  zero-1 matches the JAX trainer on a mesh of the same shape fed the same
  numpy weights and batches (losses rtol 1e-4, params after every step);
  each rank holds its share of every leaf and of its moments, and every
  region equals the JAX ``devices_indices_map``; the init born sharded is
  the one-process init cut;
- the checkpoint: the ownership plan of a tp state equals the JAX one;
  tp2 restores from each rank's own shm segment and into dp2 x tp2,
  fsdp2 x tp2 and dp2 x tp2 under zero-1; fsdp2 x tp2 into tp2, dp2 and
  fsdp2; a JAX tp2 checkpoint into the port and the port's back, bitwise;
- ``llama_pretrain --tp 2`` under ``elastic_run --nproc_per_node 2
  --accelerator cpu`` trains and logs its mesh.

Every process group forms on a ``TCPStore`` the test hosts on port 0.
"""

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from dlrover_tpu.checkpoint import ownership as jownership
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.common import flags as jflags
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops.embedding import embed_lookup as j_embed_lookup
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common.ipc import default_socket_path
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import flash_attention
from dlrover_tpu_torch.ops.embedding import embed_lookup

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60
WAIT_S = 300
TC = dict(micro_batch_size=1, learning_rate=1e-2, warmup_steps=2,
          total_steps=4)
GB = 8          # global batch: accum 8 at a data size of 1, 4 at 2, 2 at 4
SEQ = 16
STEPS = 4
CKPT_STEP = 4   # the tp2 and fsdp2 x tp2 runs save their state after step 4
JAX_CKPT_STEP = 2
# label -> (ranks, fsdp, tp, zero-1); tp 0 is the port's replicated dp step
# (no mesh), kept for restores
LAYOUTS = {
    "tp2": (2, 1, 2, False),
    "dp2xtp2": (4, 1, 2, False),
    "fsdp2xtp2": (4, 2, 2, False),
    "dp2xtp2+zero1": (4, 1, 2, True),
    "dp2xfsdp2xtp2+zero1": (8, 2, 2, True),
    "dp2": (2, 1, 0, False),
    "fsdp2": (2, 2, 1, False),
}
TRAINED = ["tp2", "dp2xtp2", "fsdp2xtp2", "dp2xtp2+zero1",
           "dp2xfsdp2xtp2+zero1"]


def _batches(vocab):
    """The steps' global batches, with a ``-1`` before valid targets in
    some rows (the lookup on a mesh embeds it as zeros in both
    packages)."""
    rng = np.random.default_rng(11)
    batches = rng.integers(0, vocab, (STEPS, GB, SEQ)).astype(np.int32)
    batches[:, ::3, 5] = -1
    return batches


# -- the lookup of an id outside the vocabulary -------------------------------


@pytest.mark.parametrize("on_mesh", [False, True])
def test_embed_lookup_of_negative_ids_matches_jax(on_mesh):
    """ids with ``-1``: on a one-device mesh the JAX one-hot form embeds
    zeros, without a mesh its gather wraps to the last row; the port's
    lookup gives the same values and gradients either way."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((6, 3)).astype(np.float32)
    toks = np.array([[1, -1, 2], [5, 0, -1]], np.int32)
    cot = rng.standard_normal((2, 3, 3)).astype(np.float32)
    jm = (jmesh.build_mesh(jmesh.MeshConfig(dp=1), devices=jax.devices()[:1])
          if on_mesh else None)

    def jloss(t):
        return jnp.sum(j_embed_lookup(t, jnp.asarray(toks), jm, jnp.float32)
                       * cot)

    want = np.asarray(j_embed_lookup(jnp.asarray(table), jnp.asarray(toks),
                                     jm, jnp.float32))
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = embed_lookup(tt, torch.from_numpy(toks).long(), torch.float32,
                       {"dp": 1} if on_mesh else None)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(tt.grad.numpy(), want_grad, rtol=1e-6)
    assert (want[0, 1] == 0).all() == on_mesh


# -- the GQA mapping at the local head count ----------------------------------


@pytest.mark.parametrize("h,hkv,tp", [(4, 2, 2), (8, 4, 2), (8, 2, 2),
                                      (16, 4, 4)])
def test_local_heads_attend_to_their_kv_heads(h, hkv, tp):
    """A tp rank's contiguous query heads ``[r·h/tp, (r+1)·h/tp)`` and kv
    heads ``[r·hkv/tp, ...)`` through the attention at the local head
    count give exactly its heads of the whole layer's attention: the
    group ``h/hkv`` is the same locally, so local head ``j`` reads local
    kv head ``j // group``, the whole layer's kv head of its global
    head."""
    g = torch.Generator().manual_seed(h * 31 + hkv)
    b, s, d = 2, 12, 8
    q, k, v = (torch.randn(b, s, n, d, generator=g)
               for n in (h, hkv, hkv))
    whole = flash_attention(q, k, v, causal=True)
    hl, kl = h // tp, hkv // tp
    for r in range(tp):
        local = flash_attention(q[:, :, r * hl:(r + 1) * hl],
                                k[:, :, r * kl:(r + 1) * kl],
                                v[:, :, r * kl:(r + 1) * kl], causal=True)
        assert torch.equal(local, whole[:, :, r * hl:(r + 1) * hl])
        for j in range(hl):
            assert (r * hl + j) // (h // hkv) == r * kl + j // (hl // kl)


# -- the mlp remat policy under tp --------------------------------------------


class _Ctx:
    def __init__(self, is_recompute):
        self.is_recompute = is_recompute


@pytest.mark.parametrize("tp", [1, 2])
def test_mlp_policy_keeps_the_two_local_ffn_products(tp):
    """One layer's matmuls in order (tiny: dim 64, heads 64 wide, kv 32,
    ffn 128): the policy keeps gate's and up's products, whose local
    weight is ``(dim, ffn/tp)``, in the forward and in the recompute, and
    recomputes ``w_down``'s, whose local ``(ffn/tp, dim)`` weight has the
    same shape at tp2."""
    from torch.utils.checkpoint import CheckpointPolicy

    cfg = tllama.LlamaConfig.tiny()
    d, f = cfg.dim, cfg.ffn_dim // tp
    hq, hkv = cfg.n_heads * cfg.head_dim // tp, \
        cfg.n_kv_heads * cfg.head_dim // tp
    weights = [(d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (d, f), (f, d)]
    mm = torch.ops.aten.mm.default
    policy = tllama._mlp_policy(cfg, tp)
    for recompute in (False, True):
        kept = [i for i, w in enumerate(weights)
                if policy(_Ctx(recompute), mm, torch.empty(4, w[0]),
                          torch.empty(w)) == CheckpointPolicy.MUST_SAVE]
        assert kept == [4, 5]
    assert policy(_Ctx(False), torch.ops.aten.add.Tensor, torch.empty(1),
                  torch.empty(d, f)) == CheckpointPolicy.PREFER_RECOMPUTE


# -- the gloo ranks -----------------------------------------------------------

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
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.parallel.sharding import shard_regions
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = llama.LlamaConfig.tiny()
out = {"rank": rank}


def np_of(t):
    return t.detach().cpu().numpy().copy()


def held(t):
    return t.to_local().detach() if hasattr(t, "to_local") else t.detach()


def mesh_of(fsdp, tp):
    # tp 0: the replicated dp step, no mesh
    return (bootstrap.worker_mesh("cpu", MeshConfig(fsdp=fsdp, tp=tp))
            if tp else None)


def make(label, cfg=cfg):
    _, fsdp, tp, z1 = inp["layouts"][label]
    mesh = mesh_of(fsdp, tp)
    tc = TrainConfig(global_batch_size=GB, zero1=z1, **inp["tc"])
    tr = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg, mesh), tc,
                        lambda p, t: llama.loss_sums(p, t, cfg, mesh),
                        mesh=mesh)
    params = params_from_jax(
        inp["params"], "cpu", mesh=llama.sharded_mesh(mesh),
        specs=llama.param_specs(cfg))
    return tr, tr.init_state(params)


def counts(tree):
    return {k: (int(v.numel()), int(held(v).numel()))
            for k, v in flatten(tree)}


def regions(tree):
    return {k: (shard_regions(v) if hasattr(v, "to_local") else None)
            for k, v in flatten(tree)}


def full_state(state):
    named = {}
    for leaf in flatten_state(state):
        v = leaf.value
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        named[leaf.name] = np_of(v) if isinstance(v, torch.Tensor) \\
            else np.array(v)
    return named


def local_state(state):
    named = {}
    for leaf in flatten_state(state):
        v = leaf.value
        if hasattr(v, "to_local"):
            mine = [r for r, ranks in ownership.leaf_layout(v)[1].items()
                    if rank in ranks][0]
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


def run(label):
    tr, state = make(label)
    a, b = tr.step_batch_shape
    rec = {"losses": [], "params": [], "mode": tr.zero1_mode,
           "world": tr.world_descriptor().spec,
           "params_held": counts(state["params"]),
           "moments_held": counts({"mu": state["opt"]["mu"],
                                   "nu": state["opt"]["nu"]}),
           "regions": regions({"params": state["params"],
                               "mu": state["opt"]["mu"]})}
    for batch in inp["batches"]:
        batch = torch.from_numpy(batch.reshape(a, b, -1)).long()
        state, loss = tr.step(state, tr.local_rows(batch))
        rec["losses"].append(loss.item())
        rec["params"].append(params_to_numpy(state["params"]))
    rec["nu"] = params_to_numpy(state["opt"]["nu"])
    out[label] = rec
    return state


def restore(ckpt, label, dedup=None):
    ckpt_dir, job = ckpt
    _, target = make(label)
    with torch.no_grad():
        for _, p in flatten(target["params"]):
            held(p).zero_()
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False, dedup=dedup)
    got = eng.load(target=target)
    tier = eng.last_restore_stats.get("tier")
    eng.close()
    return got[0], tier, local_state(target)


def save(ckpt, state):
    # every rank stages what it holds, and the staged state is the saved
    ckpt_dir, job = ckpt
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False, dedup=False)
    eng.save_to_storage(CKPT_STEP, state)
    staged = eng.last_stage_stats["staged_bytes"]
    eng.close()
    dist.barrier()
    return staged, full_state(state), local_state(state)


def cut_init(fsdp, tp):
    # the init born sharded: each rank's shard of every leaf is the same
    # slice of the one-process init from the same seed
    mesh = mesh_of(fsdp, tp)
    sharded = llama.init_params(cfg, torch.Generator().manual_seed(5), mesh)
    whole = dict(flatten(llama.init_params(
        cfg, torch.Generator().manual_seed(5))))
    return [path for path, t in flatten(sharded)
            if not torch.equal(held(t), whole[path][tuple(
                slice(a, b) for a, b in [r for r, ranks in shard_regions(
                    t).items() if rank in ranks][0])])]


def mesh_losses(batch):
    # the loss of a batch with -1 before valid targets on each mesh
    toks = torch.from_numpy(batch).long()
    got = {}
    for label in inp["loss_layouts"]:
        _, fsdp, tp, _ = inp["layouts"][label]
        mesh = mesh_of(fsdp, tp)
        params = params_from_jax(inp["params"], "cpu", mesh=mesh,
                                 specs=llama.param_specs(cfg))
        with torch.no_grad():
            got[label] = llama.loss_fn(params, toks, cfg, mesh).item()
    return got
"""

TWO = JOIN + """\
tp_mesh = mesh_of(1, 2)
group = tp_mesh.get_group("tp")
# the f/g pair on known tensors: f forward is x, backward the ranks' sum;
# g forward the ranks' sum, backward the gradient itself
x = (torch.arange(6.0).reshape(2, 3) * (rank + 1)).requires_grad_(True)
y = llama._tp_region_in(x, tp_mesh)
y.backward(torch.full((2, 3), float(rank + 1)))
out["f"] = (np_of(y), np_of(x.grad))
x.grad = None
z = llama._tp_region_out(x, tp_mesh)
z.backward(torch.full((2, 3), float(rank + 1)))
out["g"] = (np_of(z), np_of(x.grad))
# the lm-head's tp gather: this rank's columns of a (3, 4) whole; every rank
# sends back the same gradient of the whole, and gets its own columns of it
full = torch.arange(12.0).reshape(3, 4)
shard = full[:, 2 * rank:2 * rank + 2].clone().requires_grad_(True)
whole = llama._gather_lm_head(shard, tp_mesh)
whole.backward(full * 10)
out["lm_gather"] = (np_of(whole), np_of(shard.grad))
out["init"] = {"tp2": cut_init(1, 2), "fsdp2": cut_init(2, 1)}
out["mesh_losses"] = mesh_losses(inp["loss_batch"])

# bf16 compute at tp2 against one process: the row-parallel products round
# to bf16 before the tp sum, so the losses part a little (the four-card tp
# leg's step-1 loss bound rests on this)
drift = []
for layers in (2, 8):
    for seed in range(4):
        bcfg = llama.LlamaConfig.tiny(
            dtype=torch.bfloat16, n_layers=layers, vocab_size=1024, dim=128,
            n_heads=8, n_kv_heads=4, ffn_dim=384)
        toks = torch.randint(0, bcfg.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            split = llama.loss_fn(llama.init_params(
                bcfg, torch.Generator().manual_seed(seed), mesh_of(1, 2)),
                toks, bcfg, mesh_of(1, 2)).item()
            whole = llama.loss_fn(llama.init_params(
                bcfg, torch.Generator().manual_seed(seed)), toks, bcfg,
                {"dp": 1}).item()
        drift.append(abs(split - whole) / whole)
out["bf16_drift"] = drift

# tp2 under each remat policy, two steps; the mlp policy's kept products
kept = []
real_policy = llama._mlp_policy


def counting_policy(cfg, tp=1):
    inner = real_policy(cfg, tp)

    def policy(ctx, op, *args, **kwargs):
        got = inner(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and got.name == "MUST_SAVE":
            kept.append(tuple(args[1].shape))
        return got
    return policy


llama._mlp_policy = counting_policy
for policy in ("all", "mlp"):
    rcfg = llama.LlamaConfig.tiny(remat=True, remat_policy=policy)
    tr, state = make("tp2", rcfg)
    a, b = tr.step_batch_shape
    losses = []
    for batch in inp["batches"][:2]:
        batch = torch.from_numpy(batch.reshape(a, b, -1)).long()
        state, loss = tr.step(state, tr.local_rows(batch))
        losses.append(loss.item())
    out[("remat", policy)] = (losses, params_to_numpy(state["params"]))
out["mlp_kept"] = kept
llama._mlp_policy = real_policy

state = run("tp2")
out["tp2_plan"] = plan_of(state)
out["staged_bytes"], out["saved"], out["saved_local"] = save(
    inp["ckpt"]["tp2"], state)
out["tp2_into_tp2"] = restore(inp["ckpt"]["tp2"], "tp2", dedup=False)
out["jax_into_tp2"] = restore(inp["ckpt"]["jax"], "tp2")
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

FOUR = JOIN + """\
saved = {label: run(label) for label in ("dp2xtp2", "fsdp2xtp2",
                                         "dp2xtp2+zero1")}
out["init"] = {"dp2xtp2": cut_init(1, 2), "fsdp2xtp2": cut_init(2, 2)}
out["plans"] = {label: plan_of(saved[label])
                for label in ("fsdp2xtp2", "dp2xtp2+zero1")}
_, out["saved"], _ = save(inp["ckpt"]["fsdp2xtp2"], saved["fsdp2xtp2"])
for label in ("dp2xtp2", "fsdp2xtp2", "dp2xtp2+zero1"):
    out[f"tp2_into_{label}"] = restore(inp["ckpt"]["tp2"], label)
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

TWO_RESTORE = JOIN + """\
for label in ("tp2", "dp2", "fsdp2"):
    out[f"fsdp2xtp2_into_{label}"] = restore(inp["ckpt"]["fsdp2xtp2"], label)
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

EIGHT = JOIN + """\
run("dp2xfsdp2xtp2+zero1")
out["init"] = {"dp2xfsdp2xtp2": cut_init(2, 2)}
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""


def _script(body):
    for name in ("PG_TIMEOUT_S", "GB", "CKPT_STEP"):
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
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(state))[0]
    }


def _as_np(want):
    return want.astype(np.float32) if want.dtype == ml_dtypes.bfloat16 \
        else want


def _jax_mesh(label):
    """The JAX mesh of a layout: its first devices in a row-major reshape,
    so device ``i`` is the port's rank ``i``."""
    world, fsdp, tp, _ = LAYOUTS[label]
    mc = jmesh.MeshConfig(dp=-1, fsdp=fsdp, tp=max(tp, 1)).resolve(world)
    shape = tuple(mc.shape()[a] for a in jmesh.AXIS_ORDER)
    return mc, Mesh(np.array(jax.devices()[:world]).reshape(shape),
                    jmesh.AXIS_ORDER)


def _jax_trainer(label):
    cfg = jllama.LlamaConfig.tiny()
    mc, mesh = _jax_mesh(label)
    return jtrainer.ElasticTrainer(
        None, jllama.param_specs(cfg), mesh, mc,
        jtrainer.TrainConfig(global_batch_size=GB, zero1=LAYOUTS[label][3],
                             **TC),
        loss_factory=lambda m: (lambda p, t: jllama.loss_fn(p, t, cfg, m)))


def _jax_place(mesh, np_params):
    specs = jllama.param_specs(jllama.LlamaConfig.tiny())
    return jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
        np_params, specs, is_leaf=lambda x: isinstance(x, P))


def _jax_regions(sharding, shape):
    """``{ranges: device ids}`` of a JAX sharding's ``devices_indices_map``
    (a rank is a device id: the meshes are plain row-major reshapes)."""
    out = {}
    for dev, index in sharding.devices_indices_map(tuple(shape)).items():
        ranges = tuple(
            (0 if s.start is None else s.start, d if s.stop is None
             else s.stop) for s, d in zip(index, shape))
        out.setdefault(ranges, []).append(dev.id)
    return {k: tuple(sorted(v)) for k, v in out.items()}


def _region_tree(tree):
    """``{path: regions}`` of a JAX tree's arrays, ``flatten``'s paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)
        out[name] = _jax_regions(leaf.sharding, leaf.shape)
    return out


class _Runs:
    """Both packages' runs, once for the module."""

    def __init__(self):
        self.jobs = []

    def run(self, root):
        cfg = jllama.LlamaConfig.tiny()
        self.np_params = jax.tree.map(
            np.asarray, jllama.init_params(cfg, jax.random.key(3)))
        self.batches = _batches(cfg.vocab_size)
        self.loss_batch = self.batches[0]
        self.jax, self.jax_regions, self.jax_plans = {}, {}, {}
        self.jax_losses = {}
        for label in ("fsdp2", "tp2"):
            _, mesh = _jax_mesh(label)
            self.jax_losses[label] = float(jllama.loss_fn(
                _jax_place(mesh, self.np_params),
                jnp.asarray(self.loss_batch), cfg, mesh))
        ckpts = {label: self._job(root, label)
                 for label in ("tp2", "fsdp2xtp2", "jax")}
        for label in TRAINED:
            tr = _jax_trainer(label)
            state = tr.init_state(_jax_place(tr.mesh, self.np_params))
            assert tr._zero1_mode(tr.mesh) == (
                "gspmd" if LAYOUTS[label][3] else "off")
            self.jax_regions[label] = _region_tree(
                {"params": state["params"], "mu": state["opt"][1][0].mu})
            a, b = tr.step_batch_shape
            losses, params = [], []
            for i, batch in enumerate(self.batches):
                state, loss = tr.step(state, jnp.asarray(
                    batch.reshape(a, b, SEQ)))
                losses.append(float(loss))
                params.append(jax.device_get(state["params"]))
                if label == "tp2" and i + 1 == JAX_CKPT_STEP:
                    # saved before the next step donates the state
                    self.jax_saved = _jax_named(state)
                    jdir, jjob = ckpts["jax"]
                    eng = JaxEngine(jdir, job_name=jjob, node_id=0,
                                    process_id=0)
                    eng.save_to_storage(JAX_CKPT_STEP, state)
                    eng.wait_staging()
                    eng.close(unlink_shm=True)
            if label in ("fsdp2xtp2", "dp2xtp2+zero1"):
                self.jax_plans[label] = {
                    k: [(a.ranges, a.owner, a.replicas, a.parent_ranges)
                        for a in v]
                    for k, v in jownership.plan_for_state(
                        state, proc_of=lambda d: d.id,
                        world=LAYOUTS[label][0]).items()}
            self.jax[label] = {"losses": losses, "params": params,
                               "nu": jax.device_get(state["opt"][1][0].nu)}
        self.ckpts = ckpts
        inp = {"params": self.np_params, "batches": self.batches, "tc": TC,
               "layouts": LAYOUTS, "ckpt": ckpts,
               "loss_batch": self.loss_batch,
               "loss_layouts": ["fsdp2", "tp2"]}
        with open(root / "in.pkl", "wb") as f:
            pickle.dump(inp, f)
        self.two = _run_ranks(TWO, 2, root / "in.pkl", root / "two.pkl")
        self.four = _run_ranks(FOUR, 4, root / "in.pkl", root / "four.pkl")
        self.two_restore = _run_ranks(TWO_RESTORE, 2, root / "in.pkl",
                                      root / "two_restore.pkl")
        self.eight = _run_ranks(EIGHT, 8, root / "in.pkl", root / "eight.pkl")

    def ranks(self, label):
        return {2: self.two, 4: self.four, 8: self.eight}[LAYOUTS[label][0]]

    def _job(self, root, label):
        job = f"ttp-{label}-{uuid.uuid4().hex[:8]}"
        self.jobs.append(job)
        return str(root / label), job

    def cleanup(self):
        for job in self.jobs:
            for pid in range(8):
                h = SharedMemoryHandler(shm_name(job, 0, pid))
                if h.attach():
                    h.close(unlink=True)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.delenv(jflags.ZERO1.name, raising=False)
    # no speculative neighbour-world compiles behind the JAX runs
    monkeypatch_module.setenv(jflags.WARM_COMPILE.name, "0")
    r = _Runs()
    try:
        r.run(tmp_path_factory.mktemp("tp"))
        yield r
    finally:
        r.cleanup()


# adam's denominator sqrt(nu) below this: the gradient is at the level of
# f32 noise (eps = 1e-8 sets the update's size and the noise its sign)
NOISE_DENOM = 1e-7


def _close(got, want, nu, msg=""):
    """Params within rtol 1e-4 (atol 1e-6) of ``want``, except where the
    reference's last ``nu`` says the gradient is f32 noise: the two runs'
    noise differs, and adam's update there, from 0 to about the learning
    rate, with it, so those elements are held to one step at the peak
    learning rate."""
    lr = TC["learning_rate"]
    for (path, a), (_, b), (_, v) in zip(flatten(want), flatten(got),
                                         flatten(nu)):
        noise = np.sqrt(np.asarray(v, np.float64)) < NOISE_DENOM
        np.testing.assert_allclose(b[~noise], a[~noise], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{msg} {path}")
        assert np.abs(b[noise] - a[noise]).max(initial=0.0) <= lr, \
            (msg, path)


@pytest.mark.parametrize("label", ["fsdp2", "tp2"])
def test_mesh_loss_of_a_negative_id_matches_jax(runs, label):
    """A batch with ``-1`` before valid targets: the loss on an fsdp2 and
    a tp2 mesh equals the JAX loss on a mesh of the same shape, whose
    one-hot lookup embeds the ``-1`` as zeros."""
    for r in runs.two:
        np.testing.assert_allclose(r["mesh_losses"][label],
                                   runs.jax_losses[label], rtol=1e-5)


@pytest.mark.parametrize("label", TRAINED)
def test_trajectory_matches_jax(runs, label):
    """Four steps: every rank's losses and params equal, the losses within
    rtol 1e-4 of the JAX run's on a mesh of the same shape and the params
    close after every step."""
    ranks = runs.ranks(label)
    first = ranks[0][label]
    assert first["mode"] == ("gspmd" if LAYOUTS[label][3] else "off")
    assert first["world"] == label
    for r in ranks[1:]:
        assert r[label]["losses"] == first["losses"]
        for step in range(STEPS):
            for (path, a), (_, b) in zip(flatten(first["params"][step]),
                                         flatten(r[label]["params"][step])):
                assert np.array_equal(a, b), (step, path)
    want = runs.jax[label]
    np.testing.assert_allclose(first["losses"], want["losses"], rtol=1e-4)
    for step in range(STEPS):
        _close(first["params"][step], want["params"][step], want["nu"],
               f"{label} step {step + 1} vs JAX")


@pytest.mark.parametrize("policy", ["all", "mlp"])
def test_tp2_under_remat_matches(runs, policy):
    """Two tp2 steps with the layers rematerialized (the f/g all-reduces
    run again in the recomputed forward): the losses and params of the run
    without remat; under "mlp" each layer's forward kept exactly its two
    local ffn products, ``(dim, ffn/tp)`` weights."""
    cfg = tllama.LlamaConfig.tiny()
    for r in runs.two:
        losses, params = r[("remat", policy)]
        want = r["tp2"]
        np.testing.assert_allclose(losses, want["losses"][:2], rtol=1e-6)
        for (path, a), (_, b) in zip(flatten(want["params"][1]),
                                     flatten(params)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=path)
        # 2 steps x 8 microbatches x 2 layers, two products each
        assert r["mlp_kept"] == [(cfg.dim, cfg.ffn_dim // 2)] * (
            2 * 8 * cfg.n_layers * 2)


@pytest.mark.parametrize("label", TRAINED)
def test_each_rank_holds_its_share(runs, label):
    """Every matrix (and its moments) 1/(fsdp·tp) a rank, the norms whole;
    under zero-1 the moments a further 1/dp, the norms' too."""
    world, fsdp, tp, z1 = LAYOUTS[label]
    for r in runs.ranks(label):
        rec = r[label]
        for path, (total, held) in rec["params_held"].items():
            split = 1 if "norm" in path else fsdp * tp
            assert held * split == total, (path, held, total)
        for path, (total, held) in rec["moments_held"].items():
            split = 1 if "norm" in path else fsdp * tp
            if z1:
                split *= world // (fsdp * tp)
            assert held * split == total, (path, held, total)


@pytest.mark.parametrize("label", TRAINED)
def test_regions_match_devices_indices_map(runs, label):
    """Every param's and moment's regions, read back from the DTensors the
    ranks hold, equal the JAX state's ``devices_indices_map`` on the same
    mesh (the embedding's zero-1 moments tile dim 0 tp-major)."""
    want = runs.jax_regions[label]
    for r in runs.ranks(label):
        got = r[label]["regions"]
        assert set(got) == set(want)
        for path in want:
            assert got[path] == want[path], path


@pytest.mark.parametrize("label", ["fsdp2xtp2", "dp2xtp2+zero1"])
def test_ownership_plan_matches_jax(runs, label):
    """The checkpoint plan of a state split over tp (the norms replicated
    over the tp group) equals the JAX ``plan_for_state``, piece for
    piece."""
    plans = [r["plans"][label] for r in runs.four]
    assert all(p == plans[0] for p in plans)
    assert plans[0] == runs.jax_plans[label]


@pytest.mark.parametrize("label", ["tp2", "fsdp2", "dp2xtp2", "fsdp2xtp2",
                                   "dp2xfsdp2xtp2"])
def test_sharded_init_is_the_one_process_init_cut(runs, label):
    """``init_params`` on a tp mesh: every rank's shard of every leaf
    equals the same region of the one-process init from the same seed."""
    world = {"tp2": 2, "fsdp2": 2, "dp2xtp2": 4, "fsdp2xtp2": 4,
             "dp2xfsdp2xtp2": 8}[label]
    for r in {2: runs.two, 4: runs.four, 8: runs.eight}[world]:
        assert r["init"][label] == []


def test_bf16_tp2_loss_is_within_the_card_bound(runs):
    """bf16 compute at tp2 against one process, 2 and 8 layers, four seeds
    each: the losses part by less than a tenth of the four-card tp leg's
    step-1 bound (``chip_smoke.TP_LOSS_RTOL``), and by something: the
    row-parallel products round to bf16 before the tp sum."""
    sys.path.insert(0, REPO_ROOT)
    import chip_smoke

    for r in runs.two:
        drift = r["bf16_drift"]
        print(f"bf16 tp2 drift: max {max(drift):.3e} over {len(drift)}")
        assert 0 < max(drift) < chip_smoke.TP_LOSS_RTOL / 10, drift


def test_region_functions_on_known_tensors(runs):
    """f: forward the tensor itself, backward the sum of the ranks'
    gradients; g: forward the sum of the ranks' tensors, backward the
    gradient itself."""
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    for r in runs.two:
        k = r["rank"] + 1
        y, gx = r["f"]
        np.testing.assert_array_equal(y, x * k)
        np.testing.assert_array_equal(gx, np.full((2, 3), 3.0))
        z, gz = r["g"]
        np.testing.assert_array_equal(z, x * 3)
        np.testing.assert_array_equal(gz, np.full((2, 3), float(k)))


def test_lm_head_tp_gather_has_no_tp_fold_gradient(runs):
    """The lm-head's tp gather: forward the whole head; backward, given
    the same gradient of the whole on every rank (each rank's CE is the
    total), this rank's columns of it, once, not summed over tp."""
    full = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    for r in runs.two:
        whole, grad = r["lm_gather"]
        np.testing.assert_array_equal(whole, full)
        c = 2 * r["rank"]
        np.testing.assert_array_equal(grad, full[:, c:c + 2] * 10)


def _assert_local(got, full, label):
    """Each leaf's local part bitwise the same region of ``full``."""
    assert set(got) == set(full), label
    for name, (region, values) in got.items():
        want = _as_np(full[name])[tuple(slice(s, e) for s, e in region)]
        assert values.dtype == want.dtype and values.shape == want.shape, \
            (label, name)
        assert values.tobytes() == want.tobytes(), (label, name)


def test_tp2_checkpoint_restores_from_each_ranks_own_segment(runs):
    """Dedup off: each rank staged all it holds (its shards, the whole
    norms and scalars), and a same-layout restore reads only its own shm
    segment, bitwise."""
    per_rank = sum(v.nbytes for v in runs.two[0]["saved"].values())
    for r in runs.two:
        assert r["staged_bytes"] < per_rank
        step, tier, got = r["tp2_into_tp2"]
        assert step == CKPT_STEP and tier == "shm"
        _assert_local(got, r["saved"], "tp2 -> tp2")
        _assert_local(r["saved_local"], r["saved"], "saved")


@pytest.mark.parametrize("source,target", [
    ("tp2", "dp2xtp2"), ("tp2", "fsdp2xtp2"), ("tp2", "dp2xtp2+zero1"),
    ("fsdp2xtp2", "tp2"), ("fsdp2xtp2", "dp2"), ("fsdp2xtp2", "fsdp2"),
])
def test_checkpoint_restores_across_layouts(runs, source, target):
    """A tp2 checkpoint fills dp2 x tp2, fsdp2 x tp2 and dp2 x tp2 under
    zero-1 targets, and an fsdp2 x tp2 one tp2, a replicated dp2 and an
    fsdp2 target, bitwise from the union of the pieces."""
    saved = (runs.two if source == "tp2" else runs.four)[0]["saved"]
    ranks = runs.four if source == "tp2" else runs.two_restore
    for r in ranks:
        step, _, got = r[f"{source}_into_{target}"]
        assert step == CKPT_STEP
        _assert_local(got, saved, f"{source} -> {target}")


def test_tp2_checkpoint_crosses_packages(runs):
    """The JAX package's tp2 checkpoint restores bitwise into the port's
    tp2 ranks, and the port's into the JAX package's tp2 state."""
    for r in runs.two:
        step, _, got = r["jax_into_tp2"]
        assert step == JAX_CKPT_STEP
        _assert_local(got, runs.jax_saved, "JAX -> port")
    tr = _jax_trainer("tp2")
    target = tr.init_state(_jax_place(tr.mesh, runs.np_params))
    ckpt_dir, job = runs.ckpts["tp2"]
    eng = JaxEngine(ckpt_dir, job_name=job + "-jax", node_id=0, process_id=0)
    try:
        step, restored = eng.load(target=target)
    finally:
        eng.close(unlink_shm=True)
    assert step == CKPT_STEP
    got = _jax_named(restored)
    want = runs.two[0]["saved"]
    assert list(got) == list(want)
    for name in want:
        assert _as_np(got[name]).tobytes() == want[name].tobytes(), name


def test_trainer_refuses_tp_params_that_are_not_placed():
    """No silent replicated run: a tp mesh with whole params raises when
    the state is built."""
    from dlrover_tpu_torch.parallel import mesh as tmesh
    from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    cfg = tllama.LlamaConfig.tiny()
    mesh = {**{a: 1 for a in tmesh.AXIS_ORDER}, "tp": 2}
    tr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg),
                        TrainConfig(global_batch_size=8), mesh=mesh)
    with pytest.raises(ValueError, match="not DTensors"):
        tr.init_state(tllama.init_params(
            cfg, torch.Generator().manual_seed(0)))


def test_llama_pretrain_tp2_under_elastic_run(tmp_path):
    """``llama_pretrain --tp 2`` in two CPU workers of the launcher: both
    log the mesh and the same losses."""
    job = f"torch-tp-{uuid.uuid4().hex[:10]}"
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
             "--monitor_interval", "0.2",
             os.path.join(REPO_ROOT, "dlrover_tpu_torch", "run",
                          "llama_pretrain.py"),
             "--", "--device", "cpu", "--model", "tiny", "--seq", "32",
             "--micro-batch", "1", "--global-batch", "4", "--steps", "3",
             "--tp", "2"],
            cwd=REPO_ROOT, env=env, capture_output=True, text=True,
            timeout=WAIT_S)
        assert r.returncode == 0, r.stderr[-4000:]
        logs = []
        for pid in (0, 1):
            with open(os.path.join(agent_log_dir(job, 0),
                                   f"worker-{pid}-restart0.log")) as f:
                logs.append(f.read())
    finally:
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    losses = []
    for log in logs:
        assert "mesh tp2" in log, log[-2000:]
        losses.append([x.split(" loss ")[1].split()[0]
                       for x in log.splitlines() if " loss " in x
                       and x.startswith("step ")])
        assert len(losses[-1]) == 3, log[-2000:]
    assert losses[0] == losses[1]
