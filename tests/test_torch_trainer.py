"""The port's optimizer and trainer against optax and the JAX
``ElasticTrainer``, on the CPU.

Schedules are compared value by value; one optimizer step against
``dlrover_tpu.train.trainer.make_optimizer``; and an 8-step training run
of ``LlamaConfig.tiny()`` (accum 2) against a 1-device JAX trainer, from
the same numpy weights and tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import MeshConfig, build_mesh
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.train import optim
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig


def _jax_tc(tc: TrainConfig) -> jtrainer.TrainConfig:
    return jtrainer.TrainConfig(**dataclasses.asdict(tc))


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(warmup):
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=warmup, total_steps=10)
    jsched = (
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, warmup, 10, 1e-3)
        if warmup else optax.cosine_decay_schedule(1e-2, 10, 0.1)
    )
    sched = optim.make_schedule(tc.learning_rate, tc.warmup_steps,
                                tc.total_steps)
    for count in range(0, 13):  # past the end: the schedule holds its floor
        # optax evaluates in f32, the port in f64
        np.testing.assert_allclose(sched(count), float(jsched(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))
    if warmup:
        assert sched(0) == 0.0  # the first warmup step does not move


def _opt_tree(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"norm": np.ones(6, np.float32),
              "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32)},
              "head": rng.standard_normal((5, 7)).astype(np.float32)}
    grads = jax.tree.map(
        lambda p: (grad_scale * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    return params, grads


@pytest.mark.parametrize("grad_scale", [0.05, 3.0], ids=["unclipped", "clipped"])
def test_optimizer_steps_match_optax(grad_scale):
    """Three steps of clip + adamw (weight decay on every leaf, norms
    included) from the same params and grads."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                     weight_decay=0.1, grad_clip=1.0)
    params, grads = _opt_tree(0, grad_scale)
    jopt = jtrainer.make_optimizer(_jax_tc(tc))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    topt = optim.make_optimizer(tc)
    tparams = params_from_jax(params, "cpu")
    tstate = topt.init(tparams)
    for _ in range(3):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = {p: torch.from_numpy(g.copy()) for p, g in flatten(grads)}
        topt.step(tparams, tgrads, tstate)
    # f32 on both sides: a few ulps of each update
    for (path, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, jparams)),
                                 flatten(params_to_numpy(tparams))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7, err_msg=path)
    assert tstate["count"] == 3


@pytest.mark.parametrize("warmup", [0, 3])
def test_trajectory_matches_jax_trainer(warmup):
    """8 steps, accum 2: every loss and the final params against a
    1-device JAX ElasticTrainer built from the same weights and tokens."""
    cfg_j = jllama.LlamaConfig.tiny()
    cfg_t = tllama.LlamaConfig.tiny()
    tc = TrainConfig(global_batch_size=4, micro_batch_size=2,
                     learning_rate=1e-2, warmup_steps=warmup, total_steps=8)
    np_params = jax.tree.map(
        np.asarray, jllama.init_params(cfg_j, jax.random.key(0)))
    rng = np.random.default_rng(3)
    batches = rng.integers(0, cfg_j.vocab_size, (8, 2, 2, 16)).astype(np.int32)

    mc = MeshConfig(dp=1, fsdp=1, sp=1, tp=1)
    mesh = build_mesh(mc, devices=jax.devices()[:1])
    jtr = jtrainer.ElasticTrainer(
        lambda p, t: jllama.loss_fn(p, t, cfg_j, mesh),
        jllama.param_specs(cfg_j), mesh, mc, _jax_tc(tc),
    )
    # fresh device arrays: the jitted step donates its state
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, np_params))
    ttr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg_t), tc)
    tstate = ttr.init_state(params_from_jax(np_params, "cpu"))
    assert ttr.accum_steps == jtr.accum_steps == 2
    assert ttr.step_batch_shape == tuple(jtr.step_batch_shape)

    j_losses, t_losses = [], []
    for batch in batches:
        jstate, jl = jtr.step(jstate, jnp.asarray(batch))
        tstate, tl = ttr.step(tstate, torch.from_numpy(batch).long())
        j_losses.append(float(jl))
        t_losses.append(tl.item())
    assert tstate["step"] == 8 and int(jstate["step"]) == 8
    # losses drift by f32 rounding only
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    # adam's normalizer amplifies near-zero gradients, as in
    # tests/test_llama.py::test_accum1_fast_path_matches_accum2
    j_final = flatten(jax.tree.map(np.asarray, jstate["params"]))
    t_final = flatten(params_to_numpy(tstate["params"]))
    for (path, a), (_, b) in zip(j_final, t_final):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)
    if warmup:
        assert t_losses[-1] < t_losses[0]


def test_accum1_step_matches_jax():
    """One microbatch per step (the path without an f32 accumulator)
    equals the JAX trainer's step."""
    cfg_j = jllama.LlamaConfig.tiny()
    cfg_t = tllama.LlamaConfig.tiny()
    tc = TrainConfig(global_batch_size=2, micro_batch_size=2,
                     learning_rate=1e-2, warmup_steps=0, total_steps=4)
    np_params = jax.tree.map(
        np.asarray, jllama.init_params(cfg_j, jax.random.key(1)))
    batch = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (1, 2, 16)).astype(np.int32)
    mc = MeshConfig(dp=1, fsdp=1, sp=1, tp=1)
    mesh = build_mesh(mc, devices=jax.devices()[:1])
    jtr = jtrainer.ElasticTrainer(
        lambda p, t: jllama.loss_fn(p, t, cfg_j, mesh),
        jllama.param_specs(cfg_j), mesh, mc, _jax_tc(tc),
    )
    jstate, jl = jtr.step(jtr.init_state(jax.tree.map(jnp.asarray, np_params)),
                          jnp.asarray(batch))
    ttr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg_t), tc)
    tstate, tl = ttr.step(ttr.init_state(params_from_jax(np_params, "cpu")),
                          torch.from_numpy(batch).long())
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for (path, a), (_, b) in zip(
            flatten(jax.tree.map(np.asarray, jstate["params"])),
            flatten(params_to_numpy(tstate["params"]))):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)


def _step_params(tc, params, grads, lr_scale):
    opt = optim.make_optimizer(tc)
    p = params_from_jax(params, "cpu")
    state = opt.init(p)
    opt.step(p, {k: torch.from_numpy(g.copy()) for k, g in flatten(grads)},
             state, lr_scale=lr_scale)
    return params_to_numpy(p)


def test_lr_scale_scales_the_update():
    """The state's ``lr_scale`` multiplies the whole update, weight decay
    included, as the JAX step applies it."""
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=4)
    params, grads = _opt_tree(5, 0.1)
    full = _step_params(tc, params, grads, 1.0)
    half = _step_params(tc, params, grads, 0.5)
    for (k, p0), (_, p1), (_, p2) in zip(flatten(params), flatten(full),
                                         flatten(half)):
        np.testing.assert_allclose(p2 - p0, 0.5 * (p1 - p0), rtol=1e-4,
                                   atol=1e-8, err_msg=k)


def test_evaluate_is_the_mean_loss_and_leaves_the_state():
    cfg = tllama.LlamaConfig.tiny()
    tc = TrainConfig(global_batch_size=2, micro_batch_size=2)
    trainer = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg), tc)
    state = trainer.init_state(
        tllama.init_params(cfg, torch.Generator().manual_seed(0)))
    before = {k: v.clone() for k, v in flatten(state["params"])}
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
               for _ in range(3)]
    mean = trainer.evaluate(state, batches)
    with torch.no_grad():
        want = sum(tllama.loss_fn(state["params"], b, cfg).item()
                   for b in batches) / 3
    assert mean == pytest.approx(want, rel=1e-6)
    assert state["step"] == 0 and state["opt"]["count"] == 0
    for k, v in flatten(state["params"]):
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="zero batches"):
        trainer.evaluate(state, [])
