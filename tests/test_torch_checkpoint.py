"""Flash checkpoint across the two packages, on the CPU.

The port's ``dlrover_tpu_torch.checkpoint`` against the JAX package's
``dlrover_tpu.checkpoint``: one shm segment layout and one tiered,
CRC-verified storage layout, so a checkpoint either package writes
restores bitwise in the other, through shm and through disk, and training
goes on to the same losses. Also: the port's memory save survives its
in-place optimizer step; the two engines take the same tier in the same
scenario; the ownership plans agree piece for piece; deduplicated staging
over a simulated data-parallel world; and a SIGKILLed run resumes from
shm with the trajectory of an uninterrupted one.

Every test uses its own job name (the shm segments' key) and unlinks its
segments at teardown.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import uuid

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrover_tpu.checkpoint import ownership as jownership
from dlrover_tpu.checkpoint.engine import CheckpointEngine as JaxEngine
from dlrover_tpu.checkpoint.saver import local_tier_dir, step_dir
from dlrover_tpu.checkpoint.shm_handler import SharedMemoryHandler as JaxShm
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import MeshConfig, build_mesh
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu_torch.checkpoint import ownership
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    as_bytes,
    flatten_state,
    shm_name,
)
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import (
    params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from dlrover_tpu_torch.run import llama_pretrain
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def job(tmp_path, monkeypatch):
    """A job name of this test's own and a checkpoint dir; the local disk
    tier under it; every segment of the job unlinked at teardown."""
    name = f"tport-{uuid.uuid4().hex[:12]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.delenv("DLROVER_TPU_CKPT_LOCAL_DIR", raising=False)
    yield name, str(tmp_path / "ckpt")
    for suffix in ("", "-jax", "-port"):
        for k in range(4):
            h = SharedMemoryHandler(shm_name(name + suffix, k, k))
            if h.attach():
                h.close(unlink=True)


# -- the tiny-Llama train state in both packages ------------------------------


def _jax_tc(tc: TrainConfig) -> jtrainer.TrainConfig:
    return jtrainer.TrainConfig(**{
        k: getattr(tc, k) for k in TrainConfig.__dataclass_fields__})


class _Pair:
    """Both trainers over tiny Llama (accum 2), the same numpy weights and
    4 steps of tokens, and each package's uninterrupted 4-step run."""

    def __init__(self):
        self.cfg_j = jllama.LlamaConfig.tiny()
        self.cfg_t = tllama.LlamaConfig.tiny()
        self.tc = TrainConfig(global_batch_size=4, micro_batch_size=2,
                              learning_rate=1e-2, warmup_steps=2,
                              total_steps=8)
        self.np_params = jax.tree.map(
            np.asarray, jllama.init_params(self.cfg_j, jax.random.key(0)))
        self.batches = np.random.default_rng(3).integers(
            0, self.cfg_j.vocab_size, (4, 2, 2, 16)).astype(np.int32)
        mc = MeshConfig(dp=1, fsdp=1, sp=1, tp=1)
        mesh = build_mesh(mc, devices=jax.devices()[:1])
        cfg_j, cfg_t = self.cfg_j, self.cfg_t
        self.jtr = jtrainer.ElasticTrainer(
            lambda p, t: jllama.loss_fn(p, t, cfg_j, mesh),
            jllama.param_specs(cfg_j), mesh, mc, _jax_tc(self.tc),
        )
        self.ttr = ElasticTrainer(
            lambda p, t: tllama.loss_fn(p, t, cfg_t), self.tc)
        self.j_state, self.j_losses = self.jax_run(self.jax_init(),
                                                   self.batches)
        self.t_state, self.t_losses = self.port_run(self.port_init(),
                                                    self.batches)

    def jax_init(self):
        # fresh device arrays: the jitted step donates its state
        return self.jtr.init_state(jax.tree.map(jnp.asarray, self.np_params))

    def port_init(self):
        return self.ttr.init_state(params_from_jax(self.np_params, "cpu"))

    def jax_run(self, state, batches):
        losses = []
        for batch in batches:
            state, loss = self.jtr.step(state, jnp.asarray(batch))
            losses.append(float(loss))
        return state, losses

    def port_run(self, state, batches):
        losses = []
        for batch in batches:
            state, loss = self.ttr.step(state, torch.from_numpy(batch).long())
            losses.append(loss.item())
        return state, losses


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _jax_named(state):
    """{keystr: numpy array} of a JAX state, in flatten order."""
    return {
        jax.tree_util.keystr(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(
            jax.device_get(state))[0]
    }


def _assert_bitwise(got, want):
    """Same names in the same order, each leaf bit for bit (a bf16 leaf
    of the port's numpy view comes as float32, which holds it exactly)."""
    assert list(got) == list(want)
    for name in want:
        w = want[name]
        if w.dtype == ml_dtypes.bfloat16 and got[name].dtype == np.float32:
            w = w.astype(np.float32)
        assert got[name].dtype == w.dtype, name
        assert got[name].shape == w.shape, name
        assert got[name].tobytes() == w.tobytes(), name


def _assert_continues(params_np, losses, want_params, want_losses):
    """test_torch_trainer.py's tolerances: losses to f32 rounding, params
    to adam's amplification of near-zero gradients."""
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for (path, a), (_, b) in zip(flatten(want_params), flatten(params_np)):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)


# -- shm segments -------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port_writes", "jax_writes"])
def test_shm_segment_reads_in_the_other_package(writer, job):
    """One package's SharedMemoryHandler writes a segment; the other's
    reads the same meta fields and the same leaf bytes (f32, bf16 through
    its bits, an int32 scalar, a piece with its index)."""
    name, ckpt_dir = job
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    bits = rng.integers(-2**15, 2**15, (4,)).astype(np.int16)
    count = np.asarray(9, np.int32)
    paths = ["['a']#s0", "['b']#s0", "['c']#s0"]
    shard_info = {"['a']#s0": ((6, 5), ((3, 6), (0, 5)))}
    kwargs = dict(shard_info=shard_info, world_size=1, process_id=0,
                  ckpt_dir=ckpt_dir, leaf_paths=["['a']", "['b']", "['c']"])
    seg = shm_name(name, 0, 0)
    if writer == "port_writes":
        w = SharedMemoryHandler(seg, create=True)
        w.save_state(7, list(zip(paths, [
            torch.from_numpy(a), torch.from_numpy(bits).view(torch.bfloat16),
            count])), **kwargs)
        r = JaxShm(seg)
    else:
        w = JaxShm(seg, create=True)
        w.save_state(7, list(zip(paths, [
            a, bits.view(ml_dtypes.bfloat16), count])), b"", **kwargs)
        r = SharedMemoryHandler(seg)
    try:
        wm, rm = w.read_meta(), r.read_meta()
        for field in ("step", "world_size", "process_id", "ckpt_dir",
                      "leaf_paths", "total_bytes", "treedef_hex"):
            assert getattr(rm, field) == getattr(wm, field), field
        assert rm.step == 7 and rm.treedef_hex == ""
        assert [m.to_dict() for m in rm.leaves] == [
            m.to_dict() for m in wm.leaves]
        assert [m.dtype for m in rm.leaves] == ["float32", "bfloat16",
                                                "int32"]
        assert rm.leaves[0].global_shape == (6, 5)
        assert rm.leaves[0].index == ((3, 6), (0, 5))
        for m, want in zip(rm.leaves, [a, bits, count]):
            if writer == "jax_writes":
                got = as_bytes(r.read_leaf(m)).numpy()
            else:
                got = r.read_leaf(m, copy=True)
            assert got.tobytes() == want.tobytes(), m.path
    finally:
        r.close()
        w.close(unlink=True)


def test_refused_registration_raises(job, monkeypatch):
    """A segment CUDA refuses to register raises (no quiet pageable copy);
    an accepted one is registered once and unregistered at close."""
    name, _ = job
    calls = []

    class FakeCudart:
        def __init__(self, err):
            self.err = err

        def cudaHostRegister(self, ptr, size, flags):
            calls.append(("register", size))
            return self.err

        def cudaHostUnregister(self, ptr):
            calls.append(("unregister", ptr))
            return 0

    h = SharedMemoryHandler(shm_name(name, 0, 0), create=True)
    try:
        h.reserve(1024)
        monkeypatch.setattr(torch.cuda, "cudart", lambda: FakeCudart(2))
        with pytest.raises(RuntimeError, match="cudaHostRegister.*cudaError 2"):
            h.pin()
        monkeypatch.setattr(torch.cuda, "cudart", lambda: FakeCudart(0))
        assert h.pin() >= 0.0 and h.pin() == 0.0  # once a mapping
        assert [c[0] for c in calls] == ["register", "register"]
    finally:
        h.close(unlink=True)
    assert [c[0] for c in calls] == ["register", "register", "unregister"]


# -- checkpoints across the packages ------------------------------------------


@pytest.mark.parametrize("direction,tier", [
    ("jax_to_port", "shm"), ("jax_to_port", "disk"),
    ("port_to_jax", "shm"), ("port_to_jax", "disk"),
], ids=["jax_to_port-shm", "jax_to_port-disk", "port_to_jax-shm",
        "port_to_jax-disk"])
def test_checkpoint_crosses_packages(direction, tier, pair, job):
    """Tiny Llama's train state after 2 steps in one package, saved to
    storage, restored by target in the other from shm (or, with the
    segment unlinked, from disk): every leaf bitwise (params, mu, nu,
    both counts, step, lr_scale). Then 2 more steps there, against the
    saving package's uninterrupted steps 3-4."""
    name, ckpt_dir = job
    kw = dict(job_name=name, node_id=0, process_id=0)
    if direction == "jax_to_port":
        state, _ = pair.jax_run(pair.jax_init(), pair.batches[:2])
        saved = _jax_named(state)
        writer = JaxEngine(ckpt_dir, **kw)
    else:
        state, _ = pair.port_run(pair.port_init(), pair.batches[:2])
        saved = train_state_to_numpy(state)
        writer = CheckpointEngine(ckpt_dir, **kw)
    writer.save_to_storage(2, state)
    writer.wait_staging()
    writer.close(unlink_shm=tier == "disk")
    assert sorted(saved) == sorted(_jax_named(pair.j_state))

    if direction == "jax_to_port":
        reader = CheckpointEngine(ckpt_dir, **kw)
        target = pair.port_init()
        params_before = [id(p) for _, p in flatten(target["params"])]
        step, restored = reader.load(target=target)
        assert restored is target  # in place: the same tensors
        assert [id(p) for _, p in flatten(target["params"])] == params_before
        assert all(p.requires_grad for _, p in flatten(target["params"]))
        got = train_state_to_numpy(restored)
    else:
        reader = JaxEngine(ckpt_dir, **kw)
        step, restored = reader.load(target=pair.jax_init())
        got = _jax_named(restored)
    try:
        assert step == 2
        assert reader.last_restore_stats["tier"] == tier
        _assert_bitwise(got, saved)
        if direction == "jax_to_port":
            state, losses = pair.port_run(restored, pair.batches[2:])
            _assert_continues(params_to_numpy(state["params"]), losses,
                              jax.device_get(pair.j_state["params"]),
                              pair.j_losses[2:])
        else:
            state, losses = pair.jax_run(restored, pair.batches[2:])
            _assert_continues(jax.device_get(state["params"]), losses,
                              params_to_numpy(pair.t_state["params"]),
                              pair.t_losses[2:])
    finally:
        reader.close(unlink_shm=True)


def test_train_state_crosses_through_numpy(pair):
    """train_state_from_jax and train_state_to_numpy: the JAX state as the
    port's and back under the JAX names, bitwise; the counts are the
    port's one count."""
    named = _jax_named(pair.j_state)
    state = train_state_from_jax(jax.device_get(pair.j_state), "cpu")
    assert state["opt"]["count"] == state["step"] == 4
    assert isinstance(state["lr_scale"], float)
    assert all(p.requires_grad for _, p in flatten(state["params"]))
    _assert_bitwise(train_state_to_numpy(state), named)


@pytest.mark.parametrize("snapshot", [True, False],
                         ids=["device_snapshot", "host_gather"])
def test_async_snapshot_survives_the_in_place_step(snapshot, pair, job,
                                                   monkeypatch):
    """save_to_memory(k), then the port's in-place step k + 1 while the
    background stage is held back, then load: the state at k, bitwise."""
    name, ckpt_dir = job
    monkeypatch.setenv("DLROVER_TPU_DEVICE_SNAPSHOT", "1" if snapshot
                       else "0")
    state, _ = pair.port_run(pair.port_init(), pair.batches[:1])
    want = train_state_to_numpy(state)
    eng = CheckpointEngine(ckpt_dir, job_name=name, node_id=0, process_id=0)
    # hold the background thread's copy until the next step has run
    release = threading.Event()
    real_write = eng._write_stages

    def held_write(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            assert release.wait(timeout=60)
        return real_write(*args, **kwargs)

    monkeypatch.setattr(eng, "_write_stages", held_write)
    try:
        eng.save_to_memory(1, state)
        assert eng.last_stage_mode == ("device_snapshot" if snapshot
                                       else "host_gather")
        state, _ = pair.port_run(state, pair.batches[1:2])
        assert state["step"] == 2
        assert train_state_to_numpy(state)["['params']['embed']"].tobytes() \
            != want["['params']['embed']"].tobytes()
        release.set()
        step, restored = eng.load(target=state)
        assert step == 1
        assert eng.last_restore_stats["tier"] == "shm"
        _assert_bitwise(train_state_to_numpy(restored), want)
    finally:
        release.set()
        eng.close(unlink_shm=True)


# -- the tier ladder in both engines ------------------------------------------


def _small_states():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    v = rng.integers(-2**15, 2**15, (16,)).astype(np.int16)
    jstate = {"step": jnp.asarray(7, jnp.int32),
              "v": jnp.asarray(v.view(ml_dtypes.bfloat16)),
              "w": jnp.asarray(w)}
    tstate = {"step": 7, "v": torch.from_numpy(v.copy()).view(torch.bfloat16),
              "w": torch.from_numpy(w.copy())}
    return jstate, tstate


def _zeroed(jstate, tstate):
    jt = jax.tree.map(jnp.zeros_like, jstate)
    tt = {"step": 0, "v": torch.zeros_like(tstate["v"]),
          "w": torch.zeros_like(tstate["w"])}
    return jt, tt


@pytest.mark.parametrize("scenario", ["shm", "disk", "crc_corrupt",
                                      "missing"])
def test_restore_tier_matches_jax(scenario, job):
    """The same scenario in both engines, each restoring what it saved:
    the same tier and the same leaves, or None in both. shm: the segment
    is there; disk: it is unlinked; crc_corrupt: a local-tier leaf file
    also has a flipped byte, so the object tier supplies it; missing:
    every tier is gone."""
    name, ckpt_root = job
    jstate, tstate = _small_states()
    want = _jax_named(jstate)
    outcomes = {}
    for pkg, engine_cls in (("jax", JaxEngine), ("port", CheckpointEngine)):
        ckpt_dir = os.path.join(ckpt_root, pkg)
        kw = dict(job_name=f"{name}-{pkg}", node_id=0, process_id=0)
        state = jstate if pkg == "jax" else tstate
        eng = engine_cls(ckpt_dir, **kw)
        eng.save_to_storage(3, state)
        eng.wait_staging()
        eng.close(unlink_shm=scenario != "shm")
        if scenario == "crc_corrupt":
            leaf = os.path.join(step_dir(local_tier_dir(ckpt_dir, 0), 3),
                                "proc-0", "leaf-1.bin")
            data = bytearray(open(leaf, "rb").read())
            data[0] ^= 0xFF
            with open(leaf, "wb") as f:
                f.write(bytes(data))
        elif scenario == "missing":
            shutil.rmtree(ckpt_dir)
        reader = engine_cls(ckpt_dir, **kw)
        target = _zeroed(jstate, tstate)[0 if pkg == "jax" else 1]
        try:
            result = reader.load(target=target)
            if result is None:
                outcomes[pkg] = None
            else:
                got = (_jax_named(result[1]) if pkg == "jax"
                       else train_state_to_numpy(result[1]))
                outcomes[pkg] = (result[0],
                                 reader.last_restore_stats["tier"],
                                 reader.last_restore_stats["tiers_read"],
                                 got)
        finally:
            reader.close(unlink_shm=True)
    if scenario == "missing":
        assert outcomes == {"jax": None, "port": None}
        return
    tier = {"shm": "shm", "disk": "disk", "crc_corrupt": "object"}[scenario]
    for pkg in ("jax", "port"):
        step, got_tier, tiers_read, got = outcomes[pkg]
        assert (step, got_tier) == (3, tier), pkg
        _assert_bitwise(got, want)
    assert outcomes["jax"][2] == outcomes["port"][2]


# -- ownership ----------------------------------------------------------------


def _pieces(plan):
    return {k: [(a.ranges, a.owner, a.replicas, a.parent_ranges) for a in v]
            for k, v in plan.items()}


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_ownership_plan_matches_jax(world, pair):
    """The port's plan for the tiny-Llama train state, every leaf
    replicated over ``world`` ranks, equals the JAX package's piece for
    piece: for host leaves, and for leaves replicated on the 8-device
    mesh split into ``world`` virtual ranks."""
    tstate = train_state_from_jax(jax.device_get(pair.j_state), "cpu")
    plan = ownership.plan_for_state(
        [(leaf.name, leaf.value.shape) for leaf in flatten_state(tstate)],
        world)
    ownership.validate_plan(plan)
    host = jownership.plan_for_state(jax.device_get(pair.j_state),
                                     world=world)
    assert _pieces(plan) == _pieces(host)
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    replicated = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())),
        jax.device_get(pair.j_state))
    device = jownership.plan_for_state(
        replicated, proc_of=jownership.virtual_proc_of(world), world=world)
    assert _pieces(plan) == _pieces(device)


def test_dedup_staging_rank_of_world(pair, job):
    """``ownership_world = (r, 3)``: each rank stages and persists only its
    pieces (the plan's ``owned_bytes``), the ranks' staged bytes sum to one
    copy, and rank 0 restores the whole state bitwise from the union on
    the object tier."""
    name, ckpt_dir = job
    state = train_state_from_jax(jax.device_get(pair.j_state), "cpu")
    want = train_state_to_numpy(state)
    total = sum(v.nbytes for v in want.values())
    world = 3
    plan = ownership.plan_for_state(
        [(leaf.name, leaf.value.shape) for leaf in flatten_state(state)],
        world)
    sizes = {name: (v.shape, v.dtype.itemsize) for name, v in want.items()}
    engines = [
        CheckpointEngine(ckpt_dir, job_name=name, node_id=r, process_id=r,
                         async_staging=False, ownership_world=(r, world))
        for r in range(world)
    ]
    try:
        staged = []
        for r, eng in enumerate(engines):
            eng.save_to_storage(1, state)
            stats = eng.last_stage_stats
            assert stats["dedup"] is True
            staged.append(stats["staged_bytes"])
            assert staged[-1] == ownership.owned_bytes(plan, sizes, r)
            assert stats["skipped_replica_bytes"] == total - staged[-1]
            ndir = step_dir(local_tier_dir(ckpt_dir, r), 1)
            assert sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(ndir) for f in fs
                       if f.endswith(".bin")) == staged[-1]
        assert sum(staged) == total
        assert max(staged) < total / (world - 0.5)
        target = train_state_from_jax(jax.device_get(pair.j_state), "cpu")
        for _, p in flatten(target["params"]):
            p.detach().zero_()
        step, restored = engines[0].load(target=target)
        assert step == 1
        # rank 0's local tier holds what its shm holds: the other ranks'
        # pieces come from the object tier
        assert engines[0].last_restore_stats["tiers_read"] == [
            "shm", "object"]
        _assert_bitwise(train_state_to_numpy(restored), want)
    finally:
        for eng in engines:
            eng.close(unlink_shm=True)


# -- a hard kill --------------------------------------------------------------


def test_hard_kill_resumes_from_shm(job, monkeypatch):
    """run/llama_pretrain.py trains 2 steps of tiny Llama on the CPU with a
    memory save after each, and is SIGKILLed once step 2 is staged; a
    second run restores step 2 from shm and trains steps 3-4 to the
    losses of an uninterrupted run, exactly (the CPU path is
    deterministic)."""
    name, ckpt_dir = job
    common = ["--device", "cpu", "--model", "tiny", "--seed", "0"]
    code = ("import sys, time\n"
            "from dlrover_tpu_torch.run import llama_pretrain\n"
            "llama_pretrain.main(sys.argv[1:])\n"
            "print('STAGED', flush=True)\n"
            "time.sleep(120)\n")
    env = dict(os.environ, DLROVER_TPU_JOB_NAME=name)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, *common, "--steps", "2",
         "--ckpt-dir", ckpt_dir, "--save-every", "0"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
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
    assert any(line.startswith("step 2 loss") for line in lines), lines

    resumed = llama_pretrain.run(llama_pretrain.parse_args(
        [*common, "--steps", "4", "--ckpt-dir", ckpt_dir,
         "--save-every", "0"]), log=lambda m: None)
    assert resumed["start_step"] == 2
    assert resumed["restore"]["step"] == 2
    assert resumed["restore"]["tier"] == "shm"
    whole = llama_pretrain.run(llama_pretrain.parse_args(
        [*common, "--steps", "4"]), log=lambda m: None)
    assert whole["restore"] is None and whole["saves"] == []
    assert resumed["losses"] == whole["losses"][2:]
    assert [s["step"] for s in resumed["saves"]] == [3, 4]
    assert {s["mode"] for s in resumed["saves"]} == {"device_snapshot"}
