"""The port's Llama against the JAX package's, on the CPU.

``LlamaConfig.tiny()`` in float32, one set of weights made by the JAX
package's ``init_params`` and carried across as numpy. Loss and every
parameter gradient are compared on both cross-entropy paths
(``DLROVER_TPU_CHUNKED_CE`` on and off, read by both packages), with
``DLROVER_TPU_FUSED_CE`` on and off, and under each rematerialization
policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.common.tree import flatten
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
from dlrover_tpu_torch.ops import fused_ce as fce

# vocab 256 in chunks of 96: three chunks, the last one 64 wide
CE_CHUNK = 96


@pytest.fixture(scope="module")
def np_params():
    cfg = jllama.LlamaConfig.tiny()
    return jax.tree.map(np.asarray,
                        jllama.init_params(cfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    toks[1, 12:] = -1  # trailing pad, ignored as targets
    return toks


@pytest.mark.parametrize("chunked", ["1", "0"], ids=["chunked_ce", "dense"])
@pytest.mark.parametrize("remat", ["off", "all", "mlp"])
def test_tiny_loss_and_grads_match_jax(np_params, tokens, monkeypatch,
                                       chunked, remat):
    monkeypatch.setenv("DLROVER_TPU_CHUNKED_CE", chunked)
    kw = dict(ce_chunk_size=CE_CHUNK, remat=remat != "off")
    if remat != "off":
        kw["remat_policy"] = remat
    jcfg = jllama.LlamaConfig.tiny(**kw)
    tcfg = tllama.LlamaConfig.tiny(**kw)

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(tokens), jcfg)
    ))(jax.tree.map(jnp.asarray, np_params))

    params = params_from_jax(np_params, "cpu")
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    loss = tllama.loss_fn(params, torch.from_numpy(tokens).long(), tcfg)
    grads = torch.autograd.grad(loss, leaves)

    # f32 on both sides: the order of sums differs, nothing else
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    j_flat = flatten(jax.tree.map(np.asarray, j_grads))
    assert [p for p, _ in j_flat] == [p for p, _ in flatten(params)]
    for (path, jg), g in zip(j_flat, grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused_ce", "chunked_ce"])
@pytest.mark.parametrize("remat", ["off", "all"])
def test_tiny_loss_and_grads_match_jax_fused_flag(np_params, tokens,
                                                  monkeypatch, fused, remat):
    """``DLROVER_TPU_FUSED_CE`` on and off: the port's loss takes the
    fused-CE plain versions or the chunked path; the JAX loss takes its
    chunked path on the CPU either way. The function is the same."""
    monkeypatch.setenv("DLROVER_TPU_CHUNKED_CE", "1")
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", fused)
    kw = dict(ce_chunk_size=CE_CHUNK, remat=remat != "off")
    jcfg = jllama.LlamaConfig.tiny(**kw)
    tcfg = tllama.LlamaConfig.tiny(**kw)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(tokens), jcfg)
    ))(jax.tree.map(jnp.asarray, np_params))

    params = params_from_jax(np_params, "cpu")
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    fce.reset_launch_counts()
    loss = tllama.loss_fn(params, torch.from_numpy(tokens).long(), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert not any(fce.launch_counts.values())

    # f32 on both sides: the order of sums differs, nothing else
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for (path, jg), g in zip(flatten(jax.tree.map(np.asarray, j_grads)),
                             grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_loss_dispatches_on_the_fused_flag(np_params, tokens, monkeypatch):
    """The loss reaches the fused CE by default and the chunked CE under
    ``DLROVER_TPU_FUSED_CE=0``, as the JAX loss does on the TPU."""
    calls = []
    real_fused, real_chunked = fce.fused_cross_entropy, fce.chunked_cross_entropy
    monkeypatch.setattr(fce, "fused_cross_entropy",
                        lambda *a, **k: calls.append("fused") or real_fused(*a))
    monkeypatch.setattr(fce, "chunked_cross_entropy",
                        lambda *a, **k: calls.append("chunked")
                        or real_chunked(*a, **k))
    params = params_from_jax(np_params, "cpu")
    toks = torch.from_numpy(tokens).long()
    cfg = tllama.LlamaConfig.tiny()
    monkeypatch.delenv("DLROVER_TPU_FUSED_CE", raising=False)
    tllama.loss_fn(params, toks, cfg)
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "0")
    tllama.loss_fn(params, toks, cfg)
    assert calls == ["fused", "chunked"]


def test_params_round_trip_through_numpy(np_params):
    params = params_from_jax(np_params, "cpu")
    back = params_to_numpy(params)
    for (pa, a), (pb, b) in zip(flatten(np_params), flatten(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tllama.param_count(tllama.LlamaConfig.tiny()) == sum(
        a.size for _, a in flatten(np_params))


def test_params_from_jax_casts_and_keeps_bf16_bits():
    """bf16 arrays (ml_dtypes) cross bit for bit; ``dtype`` casts."""
    a = np.asarray(jnp.asarray([[1.5, -2.25], [3.0, 1e-3]], jnp.bfloat16))
    t = params_from_jax({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    t32 = params_from_jax({"w": a}, "cpu", dtype=torch.float32)["w"]
    assert t32.dtype == torch.float32


@pytest.mark.parametrize("preset", ["llama3_8b", "llama3_70b",
                                    "gpt2_xl_class"])
def test_presets_match_jax(preset):
    """Each port preset has the JAX preset's value in every field the two
    configs share, and the same parameter count."""
    import dataclasses

    jcfg = getattr(jllama.LlamaConfig, preset)()
    tcfg = getattr(tllama.LlamaConfig, preset)()
    shared = ({f.name for f in dataclasses.fields(tcfg)}
              & {f.name for f in dataclasses.fields(jcfg)}) - {
                  "dtype", "param_dtype"}
    assert {"vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "ffn_dim", "max_seq_len", "rope_theta"} <= shared
    for name in sorted(shared):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    assert tcfg.head_dim == jcfg.head_dim
    assert tllama.param_count(tcfg) == jllama.param_count(jcfg)


def test_init_params_layout_matches_jax(np_params):
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    got = [(p, tuple(t.shape), t.dtype) for p, t in flatten(params)]
    want = [(p, a.shape, torch.float32) for p, a in flatten(np_params)]
    assert got == want
    # same distribution: unit norms, std 0.02 matrices
    assert torch.equal(params["final_norm"], torch.ones(cfg.dim))
    assert abs(params["lm_head"].std().item() - 0.02) < 2e-3


class _CountFfnMatmuls(TorchDispatchMode):
    """Counts aten.mm calls whose second operand is (dim, ffn) shaped."""

    def __init__(self, shape):
        super().__init__()
        self.shape = shape
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        mm = torch.ops.aten.mm.default
        if func is mm and tuple(args[1].shape) == self.shape:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_mlp_keeps_the_ffn_matmuls():
    """``"all"`` recomputes the gate and up matmuls of every layer in the
    backward; ``"mlp"`` keeps their outputs, so it runs as many (dim, ffn)
    matmuls as no remat at all (the w_down backward adds one per layer
    in every policy)."""
    counts = {}
    for name, kw in (("off", dict(remat=False)), ("all", dict(remat=True)),
                     ("mlp", dict(remat=True, remat_policy="mlp"))):
        cfg = tllama.LlamaConfig.tiny(**kw)
        params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_(True) for _, p in flatten(params)]
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        with _CountFfnMatmuls((cfg.dim, cfg.ffn_dim)) as count:
            torch.autograd.grad(tllama.loss_fn(params, toks, cfg), leaves)
        counts[name] = count.n
    n_layers = tllama.LlamaConfig.tiny().n_layers
    assert counts["off"] == 3 * n_layers
    assert counts["all"] == counts["off"] + 2 * n_layers
    assert counts["mlp"] == counts["off"]
