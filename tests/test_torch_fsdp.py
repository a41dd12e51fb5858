"""fsdp (ZeRO-3) and the "gspmd" zero-1 on the CPU (gloo), against the
JAX package.

- ``param_specs`` equal ``tuple(P)`` of the JAX package's for ``tiny``,
  ``llama3_8b`` and ``llama3_70b``; ``validate_for_mesh`` refuses the
  meshes the JAX one refuses (and, for pp, every mesh: not ported);
- every leaf's regions, params and zero-1 moments on fsdp2, fsdp4 and
  dp2 x fsdp2 (``lm_head``'s moments on the nested ``("fsdp", "dp")``
  tiling included), equal the JAX ``NamedSharding``'s
  ``devices_indices_map``, from the DTensors the ranks hold and from the
  spec alone; the zero-1 state's ownership plan equals the JAX one;
- the gather Function: forward the whole tensor, backward the ranks'
  summed gradient sliced to the rank's shard, on dims 0 and 1, f32 and a
  bf16 cast;
- tiny Llama trained 4 steps at fsdp2, fsdp4, dp2 x fsdp2 and dp2 x fsdp2
  under zero-1 (``"gspmd"``) matches the JAX trainer on a mesh of the same
  shape fed the same numpy weights and batches (losses rtol 1e-4, params
  each step) and the port's replicated run in the same ranks; each rank
  holds ``1/fsdp`` of each sharded leaf and of its moments;
- an fsdp2 checkpoint restores at fsdp2 from each rank's own shm segment
  (dedup off), at dp2, at fsdp4 and at dp2 x fsdp2 with and without
  zero-1; a JAX fsdp2 checkpoint crosses into the port and the port's
  back into the JAX package, bitwise;
- ``llama_pretrain --fsdp 2`` under ``elastic_run --nproc_per_node 2
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dlrover_tpu.checkpoint import ownership as jownership
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.common import flags as jflags
from dlrover_tpu.models import llama as jllama
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
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import sharding as tsharding
from dlrover_tpu_torch.run import llama_pretrain

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60
WAIT_S = 300
TC = dict(micro_batch_size=1, learning_rate=1e-2, warmup_steps=2,
          total_steps=4)
GB = 8          # global batch: accum 4 at a data size of 2, 2 at 4
SEQ = 16
STEPS = 4
CKPT_STEP = 4   # the fsdp2 run saves its state after step 4
JAX_CKPT_STEP = 2
# label -> (ranks, fsdp, zero-1); fsdp 0 is the port's replicated dp run
LAYOUTS = {
    "fsdp2": (2, 2, False),
    "fsdp4": (4, 4, False),
    "dp2xfsdp2": (4, 2, False),
    "dp2xfsdp2+zero1": (4, 2, True),
    "dp2": (2, 0, False),
    "dp4": (4, 0, False),
}


def _outcome(fn):
    try:
        fn()
        return None
    except ValueError as e:
        return str(e)


# -- the specs and the mesh check ------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "llama3_8b", "llama3_70b"])
@pytest.mark.parametrize("pp", [1, 2])
def test_param_specs_match_jax(preset, pp):
    want = getattr(jllama.LlamaConfig, preset)()
    got = getattr(tllama.LlamaConfig, preset)()
    jspecs = jllama.param_specs(want, pp)
    tspecs = tllama.param_specs(got, pp)
    assert set(flatten(tspecs)) == {
        (path, tuple(spec)) for path, spec in flatten(jspecs)}


class _Mesh:
    """A mesh as the JAX ``validate_for_mesh`` reads one."""

    def __init__(self, sizes):
        self.shape = sizes
        self.axis_names = tuple(sizes)


MESH_CHECK_CASES = [
    {"dp": 2}, {"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"tp": 2}, {"tp": 3},
    {"sp": 2}, {"sp": 5}, {"ep": 2}, {"pp": 2}, {"pp": 3},
    {"dp": 2, "pp": 2, "sp": 2},
]


@pytest.mark.parametrize("sizes", MESH_CHECK_CASES,
                         ids=lambda s: "x".join(f"{a}{n}" for a, n in
                                                s.items()))
@pytest.mark.parametrize("seq_len", [0, 48])
def test_validate_for_mesh_refuses_as_jax(sizes, seq_len):
    """The same refusals, message for message, on every mesh without pp;
    with pp the JAX refusals, and a refusal of its own for every other
    mesh (the pipeline is not ported)."""
    full = {a: sizes.get(a, 1) for a in tmesh.AXIS_ORDER}
    want = _outcome(lambda: jllama.validate_for_mesh(
        jllama.LlamaConfig.tiny(), _Mesh(full), seq_len=seq_len))
    got = _outcome(lambda: tllama.validate_for_mesh(
        tllama.LlamaConfig.tiny(), full, seq_len=seq_len))
    if full["pp"] == 1 or want is not None:
        assert got == want
    else:
        assert got is not None and "not ported" in got


# -- regions from the spec alone ---------------------------------------------------


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


def _jax_mesh(fsdp, world):
    mc = jmesh.MeshConfig(dp=-1, fsdp=fsdp)
    return jmesh.build_mesh(mc, devices=jax.devices()[:world])


def _spec_regions(spec, shape, sizes):
    """The port's regions of a spec on a mesh of ``sizes``, coordinate by
    coordinate in row-major rank order."""
    names = list(sizes)
    out = {}
    for rank in range(int(np.prod(list(sizes.values())))):
        coord = dict(zip(names, np.unravel_index(rank, tuple(sizes.values()))))
        region = tsharding.region_at(spec, shape, sizes,
                                     {a: int(c) for a, c in coord.items()})
        out.setdefault(region, []).append(rank)
    return {k: tuple(v) for k, v in out.items()}


REGION_CASES = [
    # (spec, shape)
    ((("fsdp", "dp"), "tp"), (8, 6)),
    ((("dp", "fsdp"),), (8, 6)),
    (("tp", "fsdp"), (8, 6)),
    ((None, "fsdp", "tp"), (2, 8, 6)),
    (("dp", "fsdp", "tp"), (2, 8, 6)),
    ((None, None), (2, 8)),
    ((("fsdp", "dp"), "tp"), (12, 4)),
]


@pytest.mark.parametrize("spec,shape", REGION_CASES)
def test_spec_regions_match_devices_indices_map(spec, shape):
    sizes = {a: 1 for a in tmesh.AXIS_ORDER}
    sizes.update(dp=2, fsdp=2)
    want = _jax_regions(NamedSharding(_jax_mesh(2, 4), P(*spec)), shape)
    assert _spec_regions(spec, shape, sizes) == want


# -- the gloo ranks --------------------------------------------------------------

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
from dlrover_tpu_torch.parallel.sharding import shard_regions, spec_of
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


def make(fsdp, z1, cfg=cfg):
    # fsdp 0: the replicated dp step, no mesh
    mesh = (bootstrap.worker_mesh("cpu", MeshConfig(fsdp=fsdp)) if fsdp
            else None)
    tc = TrainConfig(global_batch_size=GB, zero1=z1, **inp["tc"])
    tr = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg, mesh), tc,
                        lambda p, t: llama.loss_sums(p, t, cfg, mesh),
                        mesh=mesh)
    params = params_from_jax(
        inp["params"], "cpu", mesh=mesh if fsdp else None,
        specs=llama.param_specs(cfg) if fsdp else None)
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


def run(label, fsdp, z1):
    tr, state = make(fsdp, z1)
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


def restore(ckpt_dir, job, fsdp, z1, dedup=None):
    _, target = make(fsdp, z1)
    with torch.no_grad():
        for _, p in flatten(target["params"]):
            held(p).zero_()
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False, dedup=dedup)
    got = eng.load(target=target)
    tier = eng.last_restore_stats.get("tier")
    eng.close()
    return got[0], tier, local_state(target)


# the init born sharded: each rank's shard of every leaf is the same slice
# of the one-process init from the same seed
for fsdp in (2, world):
    mesh = bootstrap.worker_mesh("cpu", MeshConfig(fsdp=fsdp))
    sharded = llama.init_params(cfg, torch.Generator().manual_seed(5), mesh)
    whole = dict(flatten(llama.init_params(cfg,
                                           torch.Generator().manual_seed(5))))
    out[("init", fsdp)] = [
        path for path, t in flatten(sharded)
        if not torch.equal(held(t), whole[path][tuple(
            slice(a, b) for a, b in [r for r, ranks in shard_regions(
                t).items() if rank in ranks][0])])]

# the gather Function: each rank's shard of a known tensor, gathered whole,
# and a gradient of (rank + 1) times a known pattern sent back
group_mesh = bootstrap.worker_mesh("cpu", MeshConfig(fsdp=world))
for dim in (0, 1):
    shape = [3, 3]
    shape[dim] = 2 * world
    full = torch.arange(float(np.prod(shape))).reshape(shape)
    for dtype in (torch.float32, torch.bfloat16):
        shard = full.narrow(dim, 2 * rank, 2).clone().requires_grad_(True)
        got = llama.fsdp_gather(shard, group_mesh, dim, dtype)
        grad = full * (rank + 1)
        got.backward(grad.to(got.dtype))
        out[("gather", dim, str(dtype))] = (str(got.dtype), np_of(got.float()),
                                            np_of(shard.grad))
"""

TRAIN = JOIN + """\
saved = {}
for label in inp["layouts"][world]:
    ranks, fsdp, z1 = inp["all_layouts"][label]
    saved[label] = run(label, fsdp, z1)
if world == 4:
    state = saved["dp2xfsdp2+zero1"]
    plan = ownership.plan_for_state(
        [(leaf.name, leaf.value) for leaf in flatten_state(state)], world)
    ownership.validate_plan(plan)
    out["plan"] = {k: [(a.ranges, a.owner, a.replicas, a.parent_ranges)
                       for a in v] for k, v in plan.items()}
ckpt_dir, job = inp["fsdp2_ckpt"]
if world == 2:
    # the fsdp2 run's first two steps under each remat policy: the gathers
    # run again in the recomputed forward
    for policy in ("all", "mlp"):
        tr, state = make(2, False, llama.LlamaConfig.tiny(
            remat=True, remat_policy=policy))
        a, b = tr.step_batch_shape
        losses = []
        for batch in inp["batches"][:2]:
            batch = torch.from_numpy(batch.reshape(a, b, -1)).long()
            state, loss = tr.step(state, tr.local_rows(batch))
            losses.append(loss.item())
        out[("remat", policy)] = (losses, params_to_numpy(state["params"]))
    # the fsdp2 state after step 4: every rank stages what it holds
    state = saved["fsdp2"]
    eng = CheckpointEngine(ckpt_dir, job_name=job, node_id=0,
                           process_id=rank, async_staging=False, dedup=False)
    eng.save_to_storage(CKPT_STEP, state)
    out["staged_bytes"] = eng.last_stage_stats["staged_bytes"]
    eng.close()
    dist.barrier()
    out["saved"] = full_state(state)
    out["saved_local"] = local_state(state)
    out["fsdp2_into_fsdp2"] = restore(ckpt_dir, job, 2, False, dedup=False)
    out["fsdp2_into_dp2"] = restore(ckpt_dir, job, 0, False)
    out["jax_into_fsdp2"] = restore(*inp["jax_ckpt"], 2, False)
else:
    out["fsdp2_into_fsdp4"] = restore(ckpt_dir, job, 4, False)
    out["fsdp2_into_dp2xfsdp2"] = restore(ckpt_dir, job, 2, False)
    out["fsdp2_into_dp2xfsdp2+zero1"] = restore(ckpt_dir, job, 2, True)
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


def _jax_trainer(fsdp, world, zero1_on):
    cfg = jllama.LlamaConfig.tiny()
    mc = jmesh.MeshConfig(dp=-1, fsdp=fsdp)
    return jtrainer.ElasticTrainer(
        None, jllama.param_specs(cfg), _jax_mesh(fsdp, world), mc,
        jtrainer.TrainConfig(global_batch_size=GB, zero1=zero1_on, **TC),
        loss_factory=lambda m: (lambda p, t: jllama.loss_fn(p, t, cfg, m)))


def _jax_init(tr, np_params):
    specs = jllama.param_specs(jllama.LlamaConfig.tiny())
    placed = jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a),
                                    NamedSharding(tr.mesh, s)),
        np_params, specs, is_leaf=lambda x: isinstance(x, P))
    return tr.init_state(placed)


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
        rng = np.random.default_rng(11)
        self.batches = rng.integers(
            0, cfg.vocab_size, (STEPS, GB, SEQ)).astype(np.int32)
        self.jax = {}
        self.jax_regions = {}
        for label, (world, fsdp, z1) in LAYOUTS.items():
            if not fsdp:
                continue
            tr = _jax_trainer(fsdp, world, z1)
            state = _jax_init(tr, self.np_params)
            assert tr._zero1_mode(tr.mesh) == ("gspmd" if z1 else "off")
            self.jax_regions[label] = _region_tree(
                {"params": state["params"], "mu": state["opt"][1][0].mu})
            if label == "dp2xfsdp2+zero1":
                self.jax_plan = {
                    k: [(a.ranges, a.owner, a.replicas, a.parent_ranges)
                        for a in v]
                    for k, v in jownership.plan_for_state(
                        state, proc_of=lambda d: d.id, world=4).items()}
            a, b = tr.step_batch_shape
            losses, params = [], []
            for i, batch in enumerate(self.batches):
                state, loss = tr.step(state, jnp.asarray(
                    batch.reshape(a, b, SEQ)))
                losses.append(float(loss))
                params.append(jax.device_get(state["params"]))
                if label == "fsdp2" and i + 1 == JAX_CKPT_STEP:
                    # saved before the next step donates the state
                    self.jax_saved = _jax_named(state)
                    jdir, jjob = self._job(root, "jax")
                    eng = JaxEngine(jdir, job_name=jjob, node_id=0,
                                    process_id=0)
                    eng.save_to_storage(JAX_CKPT_STEP, state)
                    eng.wait_staging()
                    eng.close(unlink_shm=True)
            self.jax[label] = {"losses": losses, "params": params,
                               "nu": jax.device_get(state["opt"][1][0].nu)}
        self.fsdp2_dir, self.fsdp2_job = self._job(root, "fsdp2")
        inp = {"params": self.np_params, "batches": self.batches, "tc": TC,
               "all_layouts": LAYOUTS,
               "layouts": {w: [k for k, v in LAYOUTS.items() if v[0] == w]
                           for w in (2, 4)},
               "fsdp2_ckpt": (self.fsdp2_dir, self.fsdp2_job),
               "jax_ckpt": (jdir, jjob)}
        with open(root / "in.pkl", "wb") as f:
            pickle.dump(inp, f)
        self.two = _run_ranks(TRAIN, 2, root / "in.pkl", root / "two.pkl")
        self.four = _run_ranks(TRAIN, 4, root / "in.pkl", root / "four.pkl")

    def ranks(self, label):
        return self.two if LAYOUTS[label][0] == 2 else self.four

    def _job(self, root, label):
        job = f"tfsdp-{label}-{uuid.uuid4().hex[:8]}"
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
        r.run(tmp_path_factory.mktemp("fsdp"))
        yield r
    finally:
        r.cleanup()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


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


SHARDED = [k for k in LAYOUTS if LAYOUTS[k][1]]


@pytest.mark.parametrize("label", SHARDED)
def test_trajectory_matches_jax(runs, label):
    """Four steps: every rank's losses and params equal, the losses within
    rtol 1e-4 of the JAX run's on a mesh of the same shape and the params
    close after every step."""
    ranks = runs.ranks(label)
    first = ranks[0][label]
    world, fsdp, z1 = LAYOUTS[label]
    assert first["mode"] == ("gspmd" if z1 else "off")
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
def test_fsdp2_under_remat_matches(runs, policy):
    """Two fsdp2 steps with the layers rematerialized (the gathers run
    again in the recomputed forward, and their backward once): the losses
    and params of the run without remat."""
    for r in runs.two:
        losses, params = r[("remat", policy)]
        want = r["fsdp2"]
        np.testing.assert_allclose(losses, want["losses"][:2], rtol=1e-6)
        for (path, a), (_, b) in zip(flatten(want["params"][1]),
                                     flatten(params)):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7,
                                       err_msg=path)


@pytest.mark.parametrize("label", SHARDED)
def test_matches_the_replicated_run(runs, label):
    """The same steps replicated in the same ranks (the port's dp step)."""
    world = LAYOUTS[label][0]
    for r in runs.ranks(label):
        got, rep = r[label], r[f"dp{world}"]
        assert rep["mode"] == "off" and rep["world"] == f"dp{world}"
        np.testing.assert_allclose(got["losses"], rep["losses"], rtol=1e-4)
        for step in range(STEPS):
            _close(got["params"][step], rep["params"][step], rep["nu"],
                   f"{label} step {step + 1} vs replicated")


@pytest.mark.parametrize("label", SHARDED)
def test_each_rank_holds_its_share(runs, label):
    """Every matrix (and its moments) 1/fsdp a rank, the norms whole; under
    zero-1 the moments a further 1/dp: a quarter, the norms' half."""
    world, fsdp, z1 = LAYOUTS[label]
    for r in runs.ranks(label):
        rec = r[label]
        for path, (total, held) in rec["params_held"].items():
            split = 1 if "norm" in path else fsdp
            assert held * split == total, (path, held, total)
        for path, (total, held) in rec["moments_held"].items():
            split = 1 if "norm" in path else fsdp
            if z1:
                split *= world // fsdp
            assert held * split == total, (path, held, total)


@pytest.mark.parametrize("label", SHARDED)
def test_regions_match_devices_indices_map(runs, label):
    """Every param's and moment's regions, read back from the DTensors the
    ranks hold, equal the JAX state's ``devices_indices_map`` on the same
    mesh; under zero-1 ``lm_head``'s moments tile dim 0 fsdp-major."""
    want = runs.jax_regions[label]
    for r in runs.ranks(label):
        got = r[label]["regions"]
        assert set(got) == set(want)
        for path in want:
            assert got[path] == want[path], path
    if LAYOUTS[label][2]:
        rows = runs.np_params["lm_head"].shape[0] // 4
        regions = runs.ranks(label)[0][label]["regions"]["mu/lm_head"]
        # rank (dp, fsdp) holds block fsdp * 2 + dp of the rows
        for region, ranks in regions.items():
            dp, fsdp = divmod(ranks[0], 2)
            block = fsdp * 2 + dp
            assert region[0] == (block * rows, (block + 1) * rows)


def test_zero1_ownership_plan_matches_jax(runs):
    """The dp2 x fsdp2 zero-1 state's checkpoint plan equals the JAX
    ``plan_for_state`` of the JAX one, piece for piece."""
    assert all(r["plan"] == runs.four[0]["plan"] for r in runs.four)
    assert runs.four[0]["plan"] == runs.jax_plan


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_init_is_the_one_process_init_cut(runs, world):
    """``init_params`` on an fsdp mesh: every rank's shard of every leaf
    equals the same region of the one-process init from the same seed."""
    for r in (runs.two if world == 2 else runs.four):
        for fsdp in {2, world}:
            assert r[("init", fsdp)] == []


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_gather_function(runs, dim, dtype, world):
    """Forward: the whole tensor in the asked dtype; backward: the sum of
    every rank's gradient, this rank's shard of it, in the shard's f32."""
    ranks = runs.two if world == 2 else runs.four
    shape = [3, 3]
    shape[dim] = 2 * world
    full = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    total = sum(r + 1 for r in range(world))
    for r in ranks:
        got_dtype, got, grad = r[("gather", dim, dtype)]
        assert got_dtype == dtype
        np.testing.assert_array_equal(got, full)
        want = np.take(full * total, range(2 * r["rank"], 2 * r["rank"] + 2),
                       axis=dim)
        assert grad.dtype == np.float32
        np.testing.assert_array_equal(grad, want)


def _assert_local(got, full, label):
    """Each leaf's local part bitwise the same region of ``full``."""
    assert set(got) == set(full), label
    for name, (region, values) in got.items():
        want = _as_np(full[name])[tuple(slice(s, e) for s, e in region)]
        assert values.dtype == want.dtype and values.shape == want.shape, \
            (label, name)
        assert values.tobytes() == want.tobytes(), (label, name)


def test_fsdp2_checkpoint_restores_from_each_ranks_own_segment(runs):
    """Dedup off: each rank staged all it holds (its shards and the whole
    norms and scalars), and a same-layout restore reads only its own shm
    segment, bitwise."""
    per_rank = sum(v.nbytes for k, v in runs.two[0]["saved"].items())
    for r in runs.two:
        assert r["staged_bytes"] < per_rank
        step, tier, got = r["fsdp2_into_fsdp2"]
        assert step == CKPT_STEP and tier == "shm"
        _assert_local(got, r["saved"], "fsdp2 -> fsdp2")
        _assert_local(r["saved_local"], r["saved"], "saved")


@pytest.mark.parametrize("target", ["dp2", "fsdp4", "dp2xfsdp2",
                                    "dp2xfsdp2+zero1"])
def test_fsdp2_checkpoint_restores_across_layouts(runs, target):
    """The fsdp2 checkpoint fills a replicated dp2 target, fsdp4 shards,
    and dp2 x fsdp2 targets with and without zero-1 (nested lm_head
    moments) bitwise from the union of the pieces, the disk tier
    included."""
    saved = runs.two[0]["saved"]
    for r in runs.ranks(target):
        step, tier, got = r[f"fsdp2_into_{target}"]
        assert step == CKPT_STEP and tier == "disk"
        _assert_local(got, saved, f"fsdp2 -> {target}")


def test_fsdp2_checkpoint_crosses_packages(runs):
    """The JAX package's fsdp2 checkpoint restores bitwise into the port's
    fsdp2 ranks, and the port's into the JAX package's fsdp2 state."""
    for r in runs.two:
        step, _, got = r["jax_into_fsdp2"]
        assert step == JAX_CKPT_STEP
        _assert_local(got, runs.jax_saved, "JAX -> port")
    target = _jax_init(_jax_trainer(2, 2, False), runs.np_params)
    eng = JaxEngine(runs.fsdp2_dir, job_name=runs.fsdp2_job + "-jax",
                    node_id=0, process_id=0)
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


def test_trainer_refuses_fsdp_params_that_are_not_placed(monkeypatch):
    """No silent replicated run: an fsdp mesh with whole params raises
    when the state is built."""
    from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    cfg = tllama.LlamaConfig.tiny()
    mesh = {**{a: 1 for a in tmesh.AXIS_ORDER}, "fsdp": 2}
    tr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg),
                        TrainConfig(global_batch_size=8), mesh=mesh)
    with pytest.raises(ValueError, match="not DTensors"):
        tr.init_state(tllama.init_params(
            cfg, torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("axis", ["tp", "sp", "ep"])
def test_later_axes_raise(axis):
    """ep is a later slice: the model and the trainer refuse it rather
    than run replicated. tp and sp are ported: they pass the check."""
    sizes = {**{a: 1 for a in tmesh.AXIS_ORDER}, "dp": 2, axis: 2}
    if axis in ("tp", "sp"):
        tmesh.check_ported_axes(sizes)
        return
    with pytest.raises(ValueError, match="not ported"):
        tmesh.check_ported_axes(sizes)


def test_fsdp_needs_a_process_group():
    """``--fsdp 2`` in a world of one process raises."""
    with pytest.raises(ValueError, match="needs a process group"):
        llama_pretrain.build(llama_pretrain.parse_args(
            ["--device", "cpu", "--model", "tiny", "--fsdp", "2"]))


def test_llama_pretrain_fsdp2_under_elastic_run(tmp_path):
    """``llama_pretrain --fsdp 2`` in two CPU workers of the launcher: both
    log the mesh and the same losses."""
    job = f"torch-fsdp-{uuid.uuid4().hex[:10]}"
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
             "--fsdp", "2"],
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
        assert "mesh fsdp2" in log, log[-2000:]
        losses.append([x.split(" loss ")[1].split()[0]
                       for x in log.splitlines() if " loss " in x
                       and x.startswith("step ")])
        assert len(losses[-1]) == 3, log[-2000:]
    assert losses[0] == losses[1]


@pytest.mark.parametrize("dim", [0, 1])
def test_zero1_reduce_scatter_hands_a_contiguous_buffer(dim, monkeypatch):
    """The zero-1 reduce-scatter of a dense but strided gradient (an fsdp
    gather's along dim 1 arrives transposed in memory) passes the
    collective a contiguous leading-dim buffer, which NCCL cuts in storage
    order (gloo copies a strided input itself, so the gloo ranks cannot
    show it): each rank's shard is its rows of the logical tensor."""
    import torch.distributed as dist

    from dlrover_tpu_torch.train import zero1 as tzero1

    def reduce_scatter(out, src, group=None):
        assert src.is_contiguous()
        k = out.shape[0]
        out.copy_(src.reshape(-1)[:out.numel()].view(out.shape) * 2)
        assert k * 2 == src.shape[0]

    class _Mesh:
        def get_group(self, axis):
            return None

    monkeypatch.setattr(dist, "reduce_scatter_tensor", reduce_scatter)
    full = torch.arange(48.0).reshape(6, 8)
    held = full.t().contiguous().t()   # (6, 8) with transposed strides
    assert not held.is_contiguous()
    layout = tzero1.Layout(mesh=_Mesh(), dp=2, rank=0,
                           leaves={"w": (dim, ("dp",))})
    got = layout.reduce_scatter("w", held)
    want = full.narrow(dim, 0, full.shape[dim] // 2) * 2
    assert torch.equal(got, want)
