"""The port's ViT against the JAX package's, on the CPU.

``ViTConfig.tiny()`` in float32, one set of weights made by the JAX
package's ``init_params`` and carried across by ``params_from_jax``.
Compared: patchify, forward logits, the loss and every gradient (labels
with the -1 pad, ``DLROVER_TPU_CHUNKED_CE`` on and off, ``attn_impl``
flash and reference), and a 4-step trajectory through the port's
``ElasticTrainer`` (tuple batch, accum 2) against a 1-device JAX trainer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import vit as jvit
from dlrover_tpu.parallel import MeshConfig, build_mesh
from dlrover_tpu.train import trainer as jtrainer
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import vit as tvit
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.ops import attention as tattn
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jvit.init_params(jvit.ViTConfig.tiny(),
                                                     jax.random.key(0)))


def _batch(seed, n=4, pad=True):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (n,)).astype(np.int32)
    if pad:
        labels[-1] = -1
    return images, labels


def test_patchify_matches_jax():
    images = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.patchify(jvit.ViTConfig.tiny(), jnp.asarray(images)))
    got = tvit.patchify(tvit.ViTConfig.tiny(), torch.from_numpy(images))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_params_layout_count_and_round_trip(np_params):
    cfg = tvit.ViTConfig.tiny()
    params = tvit.init_params(cfg, torch.Generator().manual_seed(0))
    got = [(p, tuple(t.shape), t.dtype) for p, t in flatten(params)]
    assert got == [(p, a.shape, torch.float32) for p, a in flatten(np_params)]
    assert tvit.param_count(cfg) == jvit.param_count(jvit.ViTConfig.tiny())
    assert tvit.param_count(tvit.ViTConfig.base_16()) == jvit.param_count(
        jvit.ViTConfig.base_16())
    # params_from_jax carries ViT's tree leaf by leaf, and back
    back = params_to_numpy(params_from_jax(np_params, "cpu"))
    for (pa, a), (pb, b) in zip(flatten(np_params), flatten(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # same distribution: unit norms, 1/sqrt(fan_in) matrices
    assert torch.equal(params["final_norm"], torch.ones(cfg.dim))
    assert abs(params["head"].std().item() - cfg.dim ** -0.5) < 0.02


def test_forward_matches_jax(np_params):
    images, _ = _batch(1)
    ref = np.asarray(jvit.forward(jax.tree.map(jnp.asarray, np_params),
                                  jnp.asarray(images), jvit.ViTConfig.tiny()))
    got = tvit.forward(params_from_jax(np_params, "cpu"),
                       torch.from_numpy(images), tvit.ViTConfig.tiny())
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunked", ["1", "0"], ids=["fused_ce", "dense"])
@pytest.mark.parametrize("attn_impl,remat", [("flash", False),
                                             ("reference", False),
                                             ("flash", True)])
def test_tiny_loss_and_grads_match_jax(np_params, monkeypatch, chunked,
                                       attn_impl, remat):
    """The loss (labels with a -1 pad) and every gradient. With
    ``DLROVER_TPU_CHUNKED_CE=1`` the port runs the fused-CE plain versions
    and JAX its chunked path on the CPU; with ``0`` both take dense
    logits. On the CPU the JAX ViT's attention is ``mha_reference`` (the
    16 patches have an aligned divisor, but Pallas runs only on the TPU)."""
    monkeypatch.setenv("DLROVER_TPU_CHUNKED_CE", chunked)
    monkeypatch.delenv("DLROVER_TPU_FUSED_CE", raising=False)
    jcfg = jvit.ViTConfig.tiny(attn_impl=attn_impl, remat=remat)
    tcfg = tvit.ViTConfig.tiny(attn_impl=attn_impl, remat=remat)
    images, labels = _batch(2)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jvit.loss_fn(p, (jnp.asarray(images), jnp.asarray(labels)),
                               jcfg)
    ))(jax.tree.map(jnp.asarray, np_params))

    params = params_from_jax(np_params, "cpu")
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    tattn.reset_launch_counts()
    loss = tvit.loss_fn(params, (torch.from_numpy(images),
                                 torch.from_numpy(labels).long()), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert not any(tattn.launch_counts.values())

    # f32 on both sides: the order of sums differs, nothing else
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for (path, jg), g in zip(flatten(jax.tree.map(np.asarray, j_grads)),
                             grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_loss_ignores_pad_labels(np_params):
    params = params_from_jax(np_params, "cpu")
    cfg = tvit.ViTConfig.tiny()
    images, labels = _batch(3, pad=False)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels).long()
    padded = tl.clone()
    padded[2:] = -1
    with torch.no_grad():
        masked = tvit.loss_fn(params, (ti, padded), cfg).item()
        first_two = tvit.loss_fn(params, (ti[:2], tl[:2]), cfg).item()
    np.testing.assert_allclose(masked, first_two, rtol=1e-5)


def _jax_tc(tc: TrainConfig) -> jtrainer.TrainConfig:
    return jtrainer.TrainConfig(**dataclasses.asdict(tc))


def test_trajectory_matches_jax_trainer(np_params):
    """4 steps, accum 2, (images, labels) tuple batches: every loss and the
    final params against a 1-device JAX ElasticTrainer."""
    cfg_j, cfg_t = jvit.ViTConfig.tiny(), tvit.ViTConfig.tiny()
    tc = TrainConfig(global_batch_size=4, micro_batch_size=2,
                     learning_rate=1e-2, warmup_steps=0, total_steps=4)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((4, 2, 2, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4, 2, 2)).astype(np.int32)
    labels[1, 0, 1] = -1

    mc = MeshConfig(dp=1, fsdp=1, sp=1, tp=1)
    mesh = build_mesh(mc, devices=jax.devices()[:1])
    jtr = jtrainer.ElasticTrainer(
        lambda p, b: jvit.loss_fn(p, b, cfg_j, mesh),
        jvit.param_specs(cfg_j), mesh, mc, _jax_tc(tc),
    )
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, np_params))
    ttr = ElasticTrainer(lambda p, b: tvit.loss_fn(p, b, cfg_t), tc)
    tstate = ttr.init_state(params_from_jax(np_params, "cpu"))
    assert ttr.step_batch_shape == tuple(jtr.step_batch_shape) == (2, 2)

    j_losses, t_losses = [], []
    for im, lb in zip(images, labels):
        jstate, jl = jtr.step(jstate, (jnp.asarray(im), jnp.asarray(lb)))
        tstate, tl = ttr.step(tstate, (torch.from_numpy(im),
                                       torch.from_numpy(lb).long()))
        j_losses.append(float(jl))
        t_losses.append(tl.item())
    # losses drift by f32 rounding only
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    # adam's normalizer amplifies near-zero gradients, as in
    # tests/test_torch_trainer.py::test_trajectory_matches_jax_trainer
    for (path, a), (_, b) in zip(
            flatten(jax.tree.map(np.asarray, jstate["params"])),
            flatten(params_to_numpy(tstate["params"]))):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)


def test_trainer_checks_every_batch_leaf():
    cfg = tvit.ViTConfig.tiny()
    tc = TrainConfig(global_batch_size=4, micro_batch_size=2)
    trainer = ElasticTrainer(lambda p, b: tvit.loss_fn(p, b, cfg), tc)
    state = trainer.init_state(
        tvit.init_params(cfg, torch.Generator().manual_seed(0)))
    images = torch.zeros((2, 2, 32, 32, 3))
    with pytest.raises(ValueError, match="accum_steps=2"):
        trainer.step(state, (images, torch.zeros((3, 2), dtype=torch.long)))
    loss = trainer.eval_step(state, (images[0], torch.zeros(2).long()))
    assert torch.isfinite(loss)


def test_vit_classify_runs_on_the_cpu():
    from dlrover_tpu_torch.run import vit_classify

    out = vit_classify.run(vit_classify.parse_args(
        ["--device", "cpu", "--model", "tiny", "--steps", "3",
         "--micro-batch", "2", "--global-batch", "4"]), log=lambda m: None)
    assert len(out["losses"]) == 3 and out["images_per_step"] == 4
    assert all(np.isfinite(out["losses"]))
    # random init: about ln(n_classes)
    assert abs(out["losses"][0] - np.log(10)) < 0.5
    assert out["max_memory_bytes"] is None
