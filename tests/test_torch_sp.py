"""Sequence parallelism (sp) on the CPU (gloo), against the JAX package,
and the two trainer repairs that came with it.

- ring attention (sp2 and sp4, causal and not) and ulysses attention (sp2,
  and sp4 on h 8 / hkv 2, which repeats the kv heads) equal the JAX
  ``ring_attention`` / ``ulysses_attention`` under ``shard_map`` in their
  values and their q, k and v gradients, and ring's ``lse`` the whole
  sequence's; ulysses raises on ``h % lcm(hkv, sp)`` pointing at ring;
- positions and targets on a chunk: a batch with ``-1`` on the chunks'
  borders gives the JAX loss on an sp2 and an sp4 mesh;
- tiny Llama trained 4 steps at sp2 (ring), sp4 (ring), sp2 (ulysses),
  dp2 x sp2, fsdp2 x sp2, sp2 x tp2 (ulysses: the local kv heads repeat)
  and dp2 x sp2 under zero-1 (``"gspmd"``) matches the JAX trainer on a
  mesh of the same shape fed the same numpy weights and batches (losses
  rtol 1e-4, params after every step); every rank holds its share and
  every region equals the JAX ``devices_indices_map``; sp4 ring under
  remat "all" and sp2 ulysses under remat "mlp" train as without remat;
- ``check_ported_axes`` and ``zero1.mode_for`` on sp meshes, against the
  JAX ``mode_for``;
- the checkpoint: the ownership plan of an sp state equals the JAX one;
  sp2 restores into sp2, dp2 and fsdp2 and back, fsdp2 x sp2 into fsdp2,
  a JAX sp2 checkpoint into the port and the port's back, bitwise;
- bf16 compute at sp2 and sp4 against one process, the losses and the
  params after two steps (the four-card sp leg's tolerances rest on it);
- the device timer's flops at tp2 and sp2 are half the one-process value,
  at fsdp2 the same; the planner's speculation hint on fsdp2 x tp2, dp2 x
  tp2, dp2 x fsdp2 and dp2 x sp2 gives the JAX trainer's descriptor and
  "already there" verdict;
- ``llama_pretrain --sp 2`` under ``elastic_run --nproc_per_node 2
  --accelerator cpu`` trains and logs its mesh.

Every process group forms on a ``TCPStore`` the test hosts on port 0.
"""

import datetime
import os
import pickle
import shutil
import subprocess
import sys
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_tp import (
    _as_np,
    _assert_local,
    _close,
    _jax_named,
    _region_tree,
)

from dlrover_tpu.checkpoint import ownership as jownership
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.common import flags as jflags
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops.attention import mha_reference_with_lse as j_mha_lse
from dlrover_tpu.ops.ring_attention import ring_attention as j_ring
from dlrover_tpu.ops.shard_map_compat import shard_map
from dlrover_tpu.ops.ulysses import ulysses_attention as j_ulysses
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu.train import zero1 as jzero1
from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common.ipc import default_socket_path
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.train import zero1 as tzero1
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60
WAIT_S = 300
TC = dict(micro_batch_size=1, learning_rate=1e-2, warmup_steps=2,
          total_steps=4)
GB = 4          # global batch: accum 4 at a data size of 1, 2 at 2
SEQ = 16        # sp4: chunks of 4 positions
STEPS = 4
CKPT_STEP = 4   # the sp2 and fsdp2 x sp2 runs save their state after step 4
JAX_CKPT_STEP = 2
# label -> (ranks, fsdp, sp, tp, attn_impl, zero-1, the world's spec); fsdp,
# sp and tp all 1 is the port's replicated dp step (no mesh)
LAYOUTS = {
    "sp2": (2, 1, 2, 1, "ring", False, "sp2"),
    "sp4": (4, 1, 4, 1, "ring", False, "sp4"),
    "sp2+ulysses": (2, 1, 2, 1, "ulysses", False, "sp2"),
    "dp2xsp2": (4, 1, 2, 1, "ring", False, "dp2xsp2"),
    "fsdp2xsp2": (4, 2, 2, 1, "auto", False, "fsdp2xsp2"),
    "sp2xtp2+ulysses": (4, 1, 2, 2, "ulysses", False, "sp2xtp2"),
    "dp2xsp2+zero1": (4, 1, 2, 1, "ring", True, "dp2xsp2+zero1"),
    "dp2": (2, 1, 1, 1, "auto", False, "dp2"),
    "fsdp2": (2, 2, 1, 1, "auto", False, "fsdp2"),
}
TRAINED = ["sp2", "sp4", "sp2+ulysses", "dp2xsp2", "fsdp2xsp2",
           "sp2xtp2+ulysses", "dp2xsp2+zero1"]
# the ops' cases: label -> (sp, h, hkv, causal, impl)
OPS = {
    "ring-sp2-causal": (2, 4, 2, True, "ring"),
    "ring-sp2-full": (2, 4, 2, False, "ring"),
    "ring-sp4-causal": (4, 4, 2, True, "ring"),
    "ring-sp4-full": (4, 4, 2, False, "ring"),
    "ulysses-sp2": (2, 4, 2, True, "ulysses"),
    "ulysses-sp4-repeat": (4, 8, 2, True, "ulysses"),
}
OPS_SHAPE = dict(b=2, s=32, d=16)
# bf16 drift at sp against one process: the seeds, and a small model of the
# main path's head ratio (group 4; ulysses at sp4 repeats its kv heads)
DRIFT_SEEDS = 3
DRIFT_CFG = dict(dtype=torch.bfloat16, n_layers=2, vocab_size=1024, dim=128,
                 n_heads=8, n_kv_heads=2, ffn_dim=384)


def _batches(vocab):
    """The steps' global batches, with a ``-1`` on the sp chunks' borders
    in some rows (the lookup on a mesh embeds it as zeros in both
    packages; the target before it is invalid, the shift made on the
    whole row)."""
    rng = np.random.default_rng(11)
    batches = rng.integers(0, vocab, (STEPS, GB, SEQ)).astype(np.int32)
    batches[:, ::2, SEQ // 2] = -1
    batches[:, 1::2, SEQ // 4 - 1] = -1
    return batches


def _ops_inputs():
    """Each ops case's whole q, k, v and output cotangent, f32 numpy."""
    out = {}
    for i, (label, (_, h, hkv, _, _)) in enumerate(OPS.items()):
        rng = np.random.default_rng(100 + i)
        b, s, d = OPS_SHAPE["b"], OPS_SHAPE["s"], OPS_SHAPE["d"]
        out[label] = tuple(rng.standard_normal(shape).astype(np.float32)
                           for shape in ((b, s, h, d), (b, s, hkv, d),
                                         (b, s, hkv, d), (b, s, h, d)))
    return out


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
from dlrover_tpu_torch.ops import ulysses_attention
from dlrover_tpu_torch.ops.ring_attention import ring_attention_with_lse
from dlrover_tpu_torch.parallel.mesh import MeshConfig
from dlrover_tpu_torch.parallel.sharding import shard_regions
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {"rank": rank}


def np_of(t):
    return t.detach().cpu().float().numpy().copy()


def held(t):
    return t.to_local().detach() if hasattr(t, "to_local") else t.detach()


def mesh_of(fsdp, sp, tp):
    # all 1: the replicated dp step, no mesh
    if fsdp == sp == tp == 1:
        return None
    return bootstrap.worker_mesh("cpu", MeshConfig(fsdp=fsdp, sp=sp, tp=tp))


def make(label, **cfg_kw):
    _, fsdp, sp, tp, impl, z1, _ = inp["layouts"][label]
    cfg = llama.LlamaConfig.tiny(attn_impl=impl, **cfg_kw)
    mesh = mesh_of(fsdp, sp, tp)
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
        named[leaf.name] = v.detach().numpy().copy() \\
            if isinstance(v, torch.Tensor) else np.array(v)
    return named


def local_state(state):
    named = {}
    for leaf in flatten_state(state):
        v = leaf.value
        if hasattr(v, "to_local"):
            mine = [r for r, ranks in ownership.leaf_layout(v)[1].items()
                    if rank in ranks][0]
            named[leaf.name] = (mine, v.to_local().detach().numpy().copy())
        else:
            arr = v.detach().numpy().copy() if isinstance(v, torch.Tensor) \\
                else np.array(v)
            named[leaf.name] = (tuple((0, d) for d in arr.shape), arr)
    return named


def plan_of(state):
    plan = ownership.plan_for_state(
        [(leaf.name, leaf.value) for leaf in flatten_state(state)], world)
    ownership.validate_plan(plan)
    return {k: [(a.ranges, a.owner, a.replicas, a.parent_ranges) for a in v]
            for k, v in plan.items()}


def train(label, batches, **cfg_kw):
    tr, state = make(label, **cfg_kw)
    a, b = tr.step_batch_shape
    losses, params = [], []
    for batch in batches:
        batch = torch.from_numpy(batch.reshape(a, b, -1)).long()
        state, loss = tr.step(state, tr.local_rows(batch))
        losses.append(loss.item())
        params.append(params_to_numpy(state["params"]))
    return tr, state, losses, params


def run(label):
    tr, state = make(label)
    rec = {"mode": tr.zero1_mode, "world": tr.world_descriptor().spec,
           "params_held": counts(state["params"]),
           "moments_held": counts({"mu": state["opt"]["mu"],
                                   "nu": state["opt"]["nu"]}),
           "regions": regions({"params": state["params"],
                               "mu": state["opt"]["mu"]})}
    tr, state, rec["losses"], rec["params"] = train(label, inp["batches"])
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
    return got[0], tier, local_state(target), target


def save(ckpt, state):
    # every rank stages what it holds, and the staged state is the saved
    ckpt_dir, job = ckpt
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False, dedup=False)
    eng.save_to_storage(CKPT_STEP, state)
    eng.close()
    dist.barrier()
    return full_state(state)


def ops(sp):
    # this rank's chunk of each case's whole inputs through the port's op
    group = mesh_of(1, sp, 1).get_group("sp")
    for label, (n, _, _, causal, impl) in inp["ops_cases"].items():
        if n != sp:
            continue
        q, k, v, cot = inp["ops"][label]
        s = q.shape[1] // sp

        def chunk(a):
            return torch.from_numpy(a[:, rank * s:(rank + 1) * s]).clone()

        qc, kc, vc = (chunk(a).requires_grad_(True) for a in (q, k, v))
        lse = None
        if impl == "ring":
            o, lse = ring_attention_with_lse(qc, kc, vc, group, causal)
            lse = np_of(lse)
        else:
            o = ulysses_attention(qc, kc, vc, group, causal)
        (o * chunk(cot)).sum().backward()
        out[("ops", label)] = (np_of(o), lse, np_of(qc.grad), np_of(kc.grad),
                               np_of(vc.grad))


def mesh_loss(label, batch):
    # the loss of a batch with -1 on the chunks' borders: every sp rank
    # gets the whole rows' mean
    tr, state = make(label)
    with torch.no_grad():
        return tr.loss_fn(state["params"], torch.from_numpy(batch).long()
                          ).item()


def remat_run(label, policy):
    # two steps with the layers rematerialized: the hops, the all-to-alls
    # and the sp sums run again in the recompute
    _, _, losses, params = train(label, inp["batches"][:2], remat=True,
                                 remat_policy=policy)
    out[("remat", label, policy)] = (losses, params[-1])


def drift(label):
    # bf16 at sp against one process: each seed's loss at steps 1 and 2,
    # and each sampled param's change from init after step 2, in both
    _, fsdp, sp, tp, impl, _, _ = inp["layouts"][label]
    mesh = mesh_of(fsdp, sp, tp)
    got = []
    for seed in range(inp["drift_seeds"]):
        runs = []
        for m, imp in ((mesh, impl), ({"dp": 1}, "auto")):
            cfg = llama.LlamaConfig.tiny(attn_impl=imp, **inp["drift_cfg"])
            tc = TrainConfig(global_batch_size=2, micro_batch_size=1,
                             learning_rate=3e-4, warmup_steps=0,
                             total_steps=2)
            tr = ElasticTrainer(
                lambda p, t: llama.loss_fn(p, t, cfg, m), tc,
                lambda p, t: llama.loss_sums(p, t, cfg, m), mesh=m)
            state = tr.init_state(llama.init_params(
                cfg, torch.Generator().manual_seed(seed)))
            init = params_to_numpy(state["params"])
            gen = torch.Generator().manual_seed(100 + seed)
            losses = []
            for _ in range(2):
                toks = torch.randint(0, cfg.vocab_size, (2, 1, 64),
                                     generator=gen)
                state, loss = tr.step(state, toks)
                losses.append(loss.item())
            runs.append((losses, init, params_to_numpy(state["params"])))
        got.append(runs)
    out[("drift", label)] = got
"""

TWO = JOIN + """\
ops(2)
out["loss"] = {"sp2": mesh_loss("sp2", inp["loss_batch"])}
state = run("sp2")
out["sp2_plan"] = plan_of(state)
out["saved"] = save(inp["ckpt"]["sp2"], state)
run("sp2+ulysses")
remat_run("sp2+ulysses", "mlp")
drift("sp2")
drift("sp2+ulysses")
for label in ("sp2", "dp2", "fsdp2"):
    step, tier, got, target = restore(inp["ckpt"]["sp2"], label,
                                      dedup=False if label == "sp2" else None)
    out[f"sp2_into_{label}"] = (step, tier, got)
    if label != "sp2":
        # and back: the restored state saved, then restored into sp2
        save(inp["ckpt"][label], target)
        out[f"{label}_into_sp2"] = restore(inp["ckpt"][label], "sp2")[:3]
out["jax_into_sp2"] = restore(inp["ckpt"]["jax"], "sp2")[:3]
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

FOUR = JOIN + """\
ops(4)
try:
    q = torch.zeros(1, 8, 4, 8)
    kv = torch.zeros(1, 8, 3, 8)
    ulysses_attention(q, kv, kv, mesh_of(1, 4, 1).get_group("sp"))
    out["ulysses_raise"] = None
except ValueError as e:
    out["ulysses_raise"] = str(e)
out["loss"] = {"sp4": mesh_loss("sp4", inp["loss_batch"])}
saved = {label: run(label) for label in (
    "sp4", "dp2xsp2", "fsdp2xsp2", "sp2xtp2+ulysses", "dp2xsp2+zero1")}
out["plans"] = {label: plan_of(saved[label])
                for label in ("fsdp2xsp2", "dp2xsp2+zero1")}
out["saved_fsdp2xsp2"] = save(inp["ckpt"]["fsdp2xsp2"], saved["fsdp2xsp2"])
remat_run("sp4", "all")
drift("sp4")
drift("sp4+ulysses")
with open(sys.argv[2] + f".{rank}", "wb") as f:
    pickle.dump(out, f)
"""

TWO_RESTORE = JOIN + """\
out["fsdp2xsp2_into_fsdp2"] = restore(inp["ckpt"]["fsdp2xsp2"], "fsdp2")[:3]
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


def _jax_cfg(label):
    return jllama.LlamaConfig.tiny(attn_impl=LAYOUTS[label][4])


def _jax_mesh(world, fsdp=1, sp=1, tp=1, dp=-1):
    """A JAX mesh config and mesh: its first devices in a row-major
    reshape, so device ``i`` is the port's rank ``i``."""
    mc = jmesh.MeshConfig(dp=dp, fsdp=fsdp, sp=sp, tp=tp).resolve(world)
    shape = tuple(mc.shape()[a] for a in jmesh.AXIS_ORDER)
    return mc, Mesh(np.array(jax.devices()[:world]).reshape(shape),
                    jmesh.AXIS_ORDER)


def _layout_mesh(label):
    world, fsdp, sp, tp = LAYOUTS[label][:4]
    return _jax_mesh(world, fsdp, sp, tp)


def _jax_trainer(label):
    cfg = _jax_cfg(label)
    mc, mesh = _layout_mesh(label)
    return jtrainer.ElasticTrainer(
        None, jllama.param_specs(cfg), mesh, mc,
        jtrainer.TrainConfig(global_batch_size=GB, zero1=LAYOUTS[label][5],
                             **TC),
        loss_factory=lambda m: (lambda p, t: jllama.loss_fn(p, t, cfg, m)))


def _jax_place(mesh, np_params):
    specs = jllama.param_specs(jllama.LlamaConfig.tiny())
    return jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
        np_params, specs, is_leaf=lambda x: isinstance(x, P))


def _jax_ops(label, inputs):
    """The JAX op of an ops case under ``shard_map`` on ``sp`` devices:
    ``(out, lse of the whole sequence or None, dq, dk, dv)``."""
    sp, _, _, causal, impl = OPS[label]
    q, k, v, cot = (jnp.asarray(a) for a in inputs)
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, "sp", None, None)
    op = j_ring if impl == "ring" else j_ulysses
    fn = shard_map(lambda q, k, v: op(q, k, v, axis_name="sp",
                                      causal=causal),
                   mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                   check_vma=False)
    o = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * cot),
                             argnums=(0, 1, 2)))(q, k, v)
    lse = (np.asarray(j_mha_lse(q, k, v, causal=causal)[1])
           if impl == "ring" else None)
    return (np.asarray(o), lse) + tuple(np.asarray(g) for g in grads)


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
        self.ops_inputs = _ops_inputs()
        self.jax_ops = {label: _jax_ops(label, inputs)
                        for label, inputs in self.ops_inputs.items()}
        self.jax_losses = {}
        for label in ("sp2", "sp4"):
            _, mesh = _layout_mesh(label)
            self.jax_losses[label] = float(jllama.loss_fn(
                _jax_place(mesh, self.np_params),
                jnp.asarray(self.loss_batch), _jax_cfg(label), mesh))
        ckpts = {label: self._job(root, label)
                 for label in ("sp2", "dp2", "fsdp2", "fsdp2xsp2", "jax")}
        self.jax, self.jax_regions, self.jax_plans = {}, {}, {}
        for label in TRAINED:
            tr = _jax_trainer(label)
            state = tr.init_state(_jax_place(tr.mesh, self.np_params))
            assert tr._zero1_mode(tr.mesh) == (
                "gspmd" if LAYOUTS[label][5] else "off")
            self.jax_regions[label] = _region_tree(
                {"params": state["params"], "mu": state["opt"][1][0].mu})
            a, b = tr.step_batch_shape
            losses, params = [], []
            for i, batch in enumerate(self.batches):
                state, loss = tr.step(state, jnp.asarray(
                    batch.reshape(a, b, SEQ)))
                losses.append(float(loss))
                params.append(jax.device_get(state["params"]))
                if label == "sp2" and i + 1 == JAX_CKPT_STEP:
                    # saved before the next step donates the state
                    self.jax_saved = _jax_named(state)
                    jdir, jjob = ckpts["jax"]
                    eng = JaxEngine(jdir, job_name=jjob, node_id=0,
                                    process_id=0)
                    eng.save_to_storage(JAX_CKPT_STEP, state)
                    eng.wait_staging()
                    eng.close(unlink_shm=True)
            if label in ("sp2", "fsdp2xsp2", "dp2xsp2+zero1"):
                self.jax_plans[label] = {
                    k: [(a.ranges, a.owner, a.replicas, a.parent_ranges)
                        for a in v]
                    for k, v in jownership.plan_for_state(
                        state, proc_of=lambda d: d.id,
                        world=LAYOUTS[label][0]).items()}
            self.jax[label] = {"losses": losses, "params": params,
                               "nu": jax.device_get(state["opt"][1][0].nu)}
        self.ckpts = ckpts
        layouts = dict(LAYOUTS, **{"sp4+ulysses": (4, 1, 4, 1, "ulysses",
                                                   False, "sp4")})
        inp = {"params": self.np_params, "batches": self.batches, "tc": TC,
               "layouts": layouts, "ckpt": ckpts,
               "loss_batch": self.loss_batch, "ops": self.ops_inputs,
               "ops_cases": OPS, "drift_seeds": DRIFT_SEEDS,
               "drift_cfg": DRIFT_CFG}
        with open(root / "in.pkl", "wb") as f:
            pickle.dump(inp, f)
        self.two = _run_ranks(TWO, 2, root / "in.pkl", root / "two.pkl")
        self.four = _run_ranks(FOUR, 4, root / "in.pkl", root / "four.pkl")
        self.two_restore = _run_ranks(TWO_RESTORE, 2, root / "in.pkl",
                                      root / "two_restore.pkl")

    def ranks(self, label):
        return {2: self.two, 4: self.four}[LAYOUTS[label][0]]

    def _job(self, root, label):
        job = f"tsp-{label}-{uuid.uuid4().hex[:8]}"
        self.jobs.append(job)
        return str(root / label), job

    def cleanup(self):
        for job in self.jobs:
            for pid in range(4):
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
        r.run(tmp_path_factory.mktemp("sp"))
        yield r
    finally:
        r.cleanup()


# -- the ops ------------------------------------------------------------------


@pytest.mark.parametrize("label", list(OPS))
def test_sp_attention_matches_jax(runs, label):
    """Each rank's chunk of the output and of the q, k and v gradients,
    joined in rank order, equals the JAX op's under ``shard_map`` (f32,
    atol 2e-5); ring's ``lse`` equals the whole sequence's."""
    sp = OPS[label][0]
    ranks = runs.two if sp == 2 else runs.four
    want = runs.jax_ops[label]
    got = [r[("ops", label)] for r in ranks]
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        if want[i] is None:
            assert all(g[i] is None for g in got)
            continue
        axis = 2 if name == "lse" else 1
        np.testing.assert_allclose(
            np.concatenate([g[i] for g in got], axis=axis), want[i],
            atol=2e-5, rtol=1e-5, err_msg=f"{label} {name}")


def test_ulysses_raises_on_an_ungroupable_head_count(runs):
    """h 4, hkv 3 at sp4: lcm(3, 4) = 12 does not divide h, so no
    repetition of the kv heads groups them; the port raises, pointing at
    ring attention, as the JAX op does."""
    for r in runs.four:
        assert r["ulysses_raise"] is not None
        assert "ring" in r["ulysses_raise"]
        assert "lcm" in r["ulysses_raise"]


# -- positions and targets on a chunk -----------------------------------------


@pytest.mark.parametrize("label", ["sp2", "sp4"])
def test_chunk_loss_matches_jax(runs, label):
    """A batch with ``-1`` on the chunks' borders: every sp rank's loss is
    the JAX loss on a mesh of the same shape (global positions for RoPE,
    the next-token shift made on the whole row)."""
    for r in runs.ranks(label):
        np.testing.assert_allclose(r["loss"][label],
                                   runs.jax_losses[label], rtol=1e-5)


def test_chunk_positions_and_targets():
    """One process, a mapping mesh: ``sp_chunk`` takes rank ``i``'s
    contiguous chunk; the targets shift on the whole row, so a chunk's
    last target is the next chunk's first token and only the last chunk
    ends with ``-1``."""
    toks = torch.arange(8).reshape(1, 8)
    targets = tllama._shift_targets(toks)
    chunks = []
    for i in range(4):
        mesh = types.SimpleNamespace(
            mesh_dim_names=tmesh.AXIS_ORDER, shape=(1, 1, 1, 1, 4, 1),
            get_local_rank=lambda axis, i=i: i)
        chunks.append((tllama.sp_chunk(toks, mesh).tolist(),
                       tllama.sp_chunk(targets, mesh).tolist()))
    assert chunks == [([[0, 1]], [[1, 2]]), ([[2, 3]], [[3, 4]]),
                      ([[4, 5]], [[5, 6]]), ([[6, 7]], [[7, -1]])]


# -- training against the JAX trainer -----------------------------------------


@pytest.mark.parametrize("label", TRAINED)
def test_trajectory_matches_jax(runs, label):
    """Four steps: every rank's losses and params equal, the losses within
    rtol 1e-4 of the JAX run's on a mesh of the same shape and the params
    close after every step."""
    ranks = runs.ranks(label)
    first = ranks[0][label]
    assert first["mode"] == ("gspmd" if LAYOUTS[label][5] else "off")
    assert first["world"] == LAYOUTS[label][6]
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


@pytest.mark.parametrize("label", TRAINED)
def test_each_rank_holds_its_share(runs, label):
    """sp splits no param: every matrix (and its moments) 1/(fsdp·tp) a
    rank, the norms whole; under zero-1 the moments a further 1/dp."""
    world, fsdp, sp, tp, _, z1, _ = LAYOUTS[label]
    for r in runs.ranks(label):
        rec = r[label]
        for path, (total, held) in rec["params_held"].items():
            split = 1 if "norm" in path else fsdp * tp
            assert held * split == total, (path, held, total)
        for path, (total, held) in rec["moments_held"].items():
            split = 1 if "norm" in path else fsdp * tp
            if z1:
                split *= world // (fsdp * sp * tp)
            assert held * split == total, (path, held, total)


@pytest.mark.parametrize("label", TRAINED)
def test_regions_match_devices_indices_map(runs, label):
    """Every param's and moment's regions equal the JAX state's
    ``devices_indices_map`` on the same mesh; a whole tensor (sp splits no
    param) is JAX's leaf replicated on every device."""
    world = LAYOUTS[label][0]
    want = runs.jax_regions[label]
    for r in runs.ranks(label):
        got = r[label]["regions"]
        assert set(got) == set(want)
        for path in want:
            if got[path] is None:
                (ranges, devices), = want[path].items()
                assert devices == tuple(range(world)), path
            else:
                assert got[path] == want[path], path


@pytest.mark.parametrize("label,policy", [("sp4", "all"),
                                          ("sp2+ulysses", "mlp")])
def test_sp_under_remat_matches(runs, label, policy):
    """Two steps with the layers rematerialized (the ring hops or the
    all-to-alls and the sp sums run again in the recompute; rank 0 of sp4
    skips three chunks): the losses and params of the run without
    remat."""
    for r in runs.ranks(label):
        losses, params = r[("remat", label, policy)]
        want = r[label]
        np.testing.assert_allclose(losses, want["losses"][:2], rtol=1e-6)
        for (path, a), (_, b) in zip(flatten(want["params"][1]),
                                     flatten(params)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=path)


# -- the axis checks ----------------------------------------------------------


def _sizes(**kw):
    return {a: kw.get(a, 1) for a in tmesh.AXIS_ORDER}


@pytest.mark.parametrize("sizes", [
    _sizes(sp=2), _sizes(dp=2, sp=2), _sizes(fsdp=2, sp=2),
    _sizes(sp=2, tp=2), _sizes(dp=2, fsdp=2, sp=2, tp=2)])
def test_sp_meshes_pass_the_axis_check(sizes):
    """sp trains: ``check_ported_axes`` lets every sp mesh through."""
    tmesh.check_ported_axes(sizes)


@pytest.mark.parametrize("sizes", [_sizes(pp=2), _sizes(ep=2, sp=2)])
def test_ep_and_pp_still_raise(sizes):
    with pytest.raises(ValueError, match="not ported"):
        tmesh.check_ported_axes(sizes)


@pytest.mark.parametrize("sizes", [
    _sizes(sp=2), _sizes(dp=2, sp=2), _sizes(dp=2, fsdp=2, sp=2),
    _sizes(dp=2, sp=2, tp=2), _sizes(dp=4, sp=2), _sizes(dp=2)])
@pytest.mark.parametrize("on", [False, True])
def test_zero1_mode_on_sp_meshes_matches_jax(sizes, on):
    """``mode_for`` on an sp mesh: off at dp 1 or with zero-1 off, gspmd
    beside sp above 1, as the JAX ``mode_for`` (the loss factory given)
    says; scatter on pure dp."""
    tc = TrainConfig(zero1=on)
    jmode = jzero1.mode_for(types.SimpleNamespace(shape=sizes),
                            jtrainer.TrainConfig(zero1=on), True,
                            enabled_override=on)
    assert tzero1.mode_for(sizes, tc) == jmode


# -- the two trainer repairs --------------------------------------------------


@pytest.mark.parametrize("sizes,share", [
    (None, 1.0), (_sizes(tp=2), 0.5), (_sizes(sp=2), 0.5),
    (_sizes(fsdp=2), 1.0), (_sizes(dp=2, tp=2), 0.5),
    (_sizes(sp=2, tp=2), 0.25)])
def test_step_flops_are_this_ranks_share(sizes, share):
    """The device timer's cost of a step at the same rows: 6·params·tokens
    in one process; half that at tp2 (a rank does half of each row's work)
    and at sp2 (it sees half of each row's positions); unchanged at fsdp2
    (a rank gathers the whole model for its own rows)."""
    cfg = tllama.LlamaConfig.tiny()
    tensors = [p for _, p in flatten(tllama.init_params(
        cfg, torch.Generator().manual_seed(0)))]
    batch = torch.zeros((2, 1, 32), dtype=torch.long)
    tr = ElasticTrainer(lambda p, t: 0, TrainConfig(global_batch_size=2),
                        mesh=sizes)
    whole = 6.0 * tllama.param_count(cfg) * batch.numel()
    assert tr._step_flops(tensors, batch) == whole * share
    assert tr._step_flops(tensors, batch.float()) == 0.0


HINT_MESHES = {
    "fsdp2xtp2": dict(fsdp=2, tp=2),
    "dp2xtp2": dict(dp=2, tp=2),
    "dp2xfsdp2": dict(dp=2, fsdp=2),
    "dp2xsp2": dict(dp=2, sp=2),
}


@pytest.mark.parametrize("name", list(HINT_MESHES))
def test_speculation_hint_matches_jax(name):
    """Hints of 2, 4 and 8 processes on a four-rank mesh: the port's
    descriptor (its mesh config refitted by ``remesh``) and its "already
    there" verdict (the hint against the world's size) equal the JAX
    trainer's on a mesh of the same shape."""
    kw = HINT_MESHES[name]
    mc, mesh = _jax_mesh(4, dp=kw.get("dp", 1), fsdp=kw.get("fsdp", 1),
                         sp=kw.get("sp", 1), tp=kw.get("tp", 1))
    cfg = jllama.LlamaConfig.tiny()
    jtr = jtrainer.ElasticTrainer(
        None, jllama.param_specs(cfg), mesh, mc,
        jtrainer.TrainConfig(global_batch_size=8, micro_batch_size=1),
        loss_factory=lambda m: (lambda p, t: jllama.loss_fn(p, t, cfg, m)))
    tr = ElasticTrainer(lambda p, t: 0,
                        TrainConfig(global_batch_size=8, micro_batch_size=1),
                        mesh=_sizes(**kw))
    for hint in (2, 4, 8):
        want = jtr._descriptor_for_world(hint)
        got = tr._descriptor_for_world(hint)
        assert (got and got.spec) == (want and want.spec), (name, hint)
        jtr.set_speculation_hint(hint)
        tr.set_speculation_hint(hint)
        want = jtr._speculation_hint
        got = tr.speculation_hint
        assert (got and got.spec) == (want and want.spec), (name, hint)
    tr.set_speculation_hint(None)
    assert tr.speculation_hint is None


def test_speculation_hint_without_a_mesh_stays_pure_dp(monkeypatch):
    """The replicated step (no mesh) runs pure dp at any world, so a hint
    refits dp alone: at world 1 a hint of 2 is ``dp2`` (where the JAX
    ``remesh`` of a resolved dp1 config gives fsdp2), at world 2 a hint of
    4 is ``dp4``, 2 is already there and 3 breaks the global batch."""
    from dlrover_tpu_torch.train import bootstrap

    tc = TrainConfig(global_batch_size=8, micro_batch_size=1)
    for world, hints in ((1, {2: "dp2", 1: None}),
                         (2, {4: "dp4", 2: None, 3: None})):
        monkeypatch.setattr(bootstrap, "process_count", lambda: world)
        tr = ElasticTrainer(lambda p, t: 0, tc)
        for hint, want in hints.items():
            tr.set_speculation_hint(hint)
            got = tr.speculation_hint
            assert (got and got.spec) == want, (world, hint)


# -- the checkpoint -----------------------------------------------------------


@pytest.mark.parametrize("label", ["sp2", "fsdp2xsp2", "dp2xsp2+zero1"])
def test_ownership_plan_matches_jax(runs, label):
    """The checkpoint plan of a state replicated over sp (whole params on
    sp2; fsdp shards and dp-sharded moments beside sp) equals the JAX
    ``plan_for_state`` on the same mesh, piece for piece: each
    sp-replicated region is split among its replicas."""
    if label == "sp2":
        plans = [r["sp2_plan"] for r in runs.two]
    else:
        plans = [r["plans"][label] for r in runs.four]
    assert all(p == plans[0] for p in plans)
    assert plans[0] == runs.jax_plans[label]


@pytest.mark.parametrize("source,target", [
    ("sp2", "sp2"), ("sp2", "dp2"), ("sp2", "fsdp2"), ("dp2", "sp2"),
    ("fsdp2", "sp2"), ("fsdp2xsp2", "fsdp2"), ("jax", "sp2"),
])
def test_checkpoint_restores_across_layouts(runs, source, target):
    """An sp2 checkpoint restores into sp2 (each rank's own segment), a
    replicated dp2 and an fsdp2 target, and those states saved again
    restore into sp2; an fsdp2 x sp2 checkpoint restores into fsdp2; the
    JAX package's sp2 checkpoint into the port's sp2: all bitwise from the
    union of the pieces."""
    saved = {"fsdp2xsp2": runs.four[0]["saved_fsdp2xsp2"],
             "jax": runs.jax_saved}.get(source, runs.two[0]["saved"])
    ranks = runs.two_restore if source == "fsdp2xsp2" else runs.two
    for r in ranks:
        step, tier, got = r[f"{source}_into_{target}"]
        assert step == (JAX_CKPT_STEP if source == "jax" else CKPT_STEP)
        if source == target:
            assert tier == "shm"
        _assert_local(got, saved, f"{source} -> {target}")


def test_sp2_checkpoint_restores_into_jax(runs):
    """The port's sp2 checkpoint restores bitwise into the JAX package's
    sp2 state."""
    tr = _jax_trainer("sp2")
    target = tr.init_state(_jax_place(tr.mesh, runs.np_params))
    ckpt_dir, job = runs.ckpts["sp2"]
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


# -- bf16 against one process: the card's tolerances --------------------------


def _drift(runs_of_seed):
    """(the largest relative loss difference at steps 1 and 2, the largest
    relative error of a leaf's change from init after step 2: the norm of
    the difference of the two changes over the norm of one process's)
    over the seeds."""
    loss_rel, rel_fro = [0.0, 0.0], 0.0
    for (got_l, got_i, got_p), (ref_l, ref_i, ref_p) in runs_of_seed:
        for i in range(2):
            loss_rel[i] = max(loss_rel[i], abs(got_l[i] - ref_l[i])
                              / abs(ref_l[i]))
        for (_, gi), (_, gp), (_, ri), (_, rp) in zip(
                flatten(got_i), flatten(got_p), flatten(ref_i),
                flatten(ref_p)):
            want, got = rp - ri, gp - gi
            rel_fro = max(rel_fro, float(np.linalg.norm(got - want)
                                         / np.linalg.norm(want)))
    return loss_rel, rel_fro


@pytest.mark.parametrize("label", ["sp2", "sp2+ulysses", "sp4",
                                   "sp4+ulysses"])
def test_bf16_sp_is_within_the_card_bounds(runs, label):
    """bf16 compute at sp against one process, three seeds, two steps: the
    step-1 and step-2 losses part by less than a tenth of the four-card sp
    leg's bound (``chip_smoke.SP_LOSS_RTOL``), and each leaf's change
    after step 2 by less than half of the leg's (``chip_smoke.
    SP_DELTA_REL_FRO``)."""
    sys.path.insert(0, REPO_ROOT)
    import chip_smoke

    ranks = runs.two if label.startswith("sp2") else runs.four
    for r in ranks:
        loss_rel, rel_fro = _drift(r[("drift", label)])
        print(f"bf16 {label} drift: loss {loss_rel}, leaf change {rel_fro}")
        assert max(loss_rel) < chip_smoke.SP_LOSS_RTOL / 10, loss_rel
        assert rel_fro < chip_smoke.SP_DELTA_REL_FRO / 2, rel_fro


# -- the config across the packages, and the CLI ------------------------------


def llama_config_from_jax(jcfg, **overrides):
    """The port's ``LlamaConfig`` of a JAX package's one: every field the
    port has, ``attn_impl`` included, the dtypes mapped by their numpy
    names (``jnp.bfloat16`` is ml_dtypes' "bfloat16"); the JAX-only
    fields (the pipeline's, the flash tile sizes) are dropped.
    ``overrides`` replace fields after the copy."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(tllama.LlamaConfig):
        if hasattr(jcfg, f.name):
            value = getattr(jcfg, f.name)
            if f.name in ("dtype", "param_dtype"):
                value = getattr(torch, np.dtype(value).name)
            kw[f.name] = value
    kw.update(overrides)
    return tllama.LlamaConfig(**kw)


@pytest.mark.parametrize("impl", list(tllama.ATTN_IMPLS))
def test_config_carries_attn_impl(impl):
    """``llama_config_from_jax`` carries ``attn_impl`` and every shared
    field; a bad value raises in both packages."""
    got = llama_config_from_jax(jllama.LlamaConfig.tiny(attn_impl=impl))
    assert got == tllama.LlamaConfig.tiny(attn_impl=impl)
    assert llama_config_from_jax(jllama.LlamaConfig.llama3_8b()) == \
        tllama.LlamaConfig.llama3_8b()
    with pytest.raises(ValueError):
        tllama.LlamaConfig.tiny(attn_impl="sdpa")


def test_attention_switch_on_one_process():
    """Without sp, "auto" and "flash" run the flash path and "reference"
    the plain attention (the same values on CPU tensors); "ring" and
    "ulysses" at sp 1 are the flash path too. On a mapping mesh with sp2,
    "flash" and "reference" raise: each rank holds a chunk."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, n, 16, generator=g) for n in (4, 2, 2))
    outs = {impl: tllama._attention(tllama.LlamaConfig.tiny(attn_impl=impl),
                                    None, q, k, v)
            for impl in ("auto", "flash", "reference")}
    assert torch.allclose(outs["auto"], outs["reference"], atol=1e-6)
    assert torch.equal(outs["auto"], outs["flash"])
    mesh = _sizes(sp=2)
    for impl in ("flash", "reference"):
        with pytest.raises(ValueError, match="chunk"):
            tllama._attention(tllama.LlamaConfig.tiny(attn_impl=impl), mesh,
                              q, k, v)


def test_llama_pretrain_sp2_under_elastic_run(tmp_path):
    """``llama_pretrain --sp 2`` in two CPU workers of the launcher: both
    log the mesh and the same losses."""
    job = f"torch-sp-{uuid.uuid4().hex[:10]}"
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
             "--micro-batch", "1", "--global-batch", "2", "--steps", "3",
             "--sp", "2"],
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
        assert "mesh sp2" in log, log[-2000:]
        losses.append([x.split(" loss ")[1].split()[0]
                       for x in log.splitlines() if " loss " in x
                       and x.startswith("step ")])
        assert len(losses[-1]) == 3, log[-2000:]
    assert losses[0] == losses[1]
