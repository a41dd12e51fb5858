"""Port ops against the JAX package's, on the CPU, at small sizes.

The same inputs, made with numpy from a seed, go through each JAX
function and its counterpart in dlrover_tpu_torch. The flash attention
reference is the JAX package's Pallas fwd/dq/dkv kernels run in interpret
mode, as tests/test_ops.py runs them; the port's CPU path is the plain
version of its Hopper kernels. Everything is float32; tolerances are
stated beside each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import attention as jattn
from dlrover_tpu.ops.chunked_ce import chunked_cross_entropy as j_chunked_ce
from dlrover_tpu.ops.embedding import embed_lookup as j_embed_lookup
from dlrover_tpu.ops.norms import rms_norm as j_rms_norm
from dlrover_tpu.ops.rotary import apply_rope as j_apply_rope
from dlrover_tpu.ops.rotary import rope_frequencies as j_rope_frequencies
from dlrover_tpu_torch.ops import attention as tattn
from dlrover_tpu_torch.ops.chunked_ce import chunked_cross_entropy
from dlrover_tpu_torch.ops.embedding import embed_lookup
from dlrover_tpu_torch.ops.norms import rms_norm
from dlrover_tpu_torch.ops.rotary import apply_rope, rope_frequencies

# f32 on both sides; only the order of sums differs
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def test_rms_norm_matches_jax():
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    ref = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_rope_matches_jax():
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 5, (2, 7))
    np.testing.assert_allclose(
        rope_frequencies(16, 500000.0).numpy(),
        np.asarray(j_rope_frequencies(16, 500000.0)), rtol=1e-6,
    )
    ref = j_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                       j_rope_frequencies(16, 10000.0))
    got = apply_rope(_t(x), _t(pos), rope_frequencies(16, 10000.0))
    # angles up to 11 rad: cos/sin of f32 arguments differ by a few ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_embed_lookup_values_and_grad_match_jax():
    rng = _rng(3)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    toks = np.array([[1, 4, 4, 10], [0, 2, -1, -1]], np.int32)
    cot = rng.standard_normal((2, 4, 8)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda t: j_embed_lookup(t, jnp.asarray(toks), None, jnp.float32),
        jnp.asarray(table),
    )
    tt = _t(table, grad=True)
    got = embed_lookup(tt, _t(toks).long(), torch.float32)
    (got * _t(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]), **F32_TOL)


def _qkv(b, s, h, hkv, d, seed):
    rng = _rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    g_out = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((b, h, s)).astype(np.float32)
    return q, k, v, g_out, g_lse


def _jax_value_and_grads(fn, q, k, v, g_out, g_lse):
    """(out, lse) and d<out, g_out> + <lse, g_lse> / d(q, k, v)."""

    def scalar(q, k, v):
        out, lse = fn(q, k, v)
        return jnp.sum(out * g_out) + jnp.sum(lse * g_lse), (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(
        scalar, argnums=(0, 1, 2), has_aux=True
    )(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(a) for a in (out, lse, *grads)]


def _torch_value_and_grads(fn, q, k, v, g_out, g_lse):
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out, lse = fn(tq, tk, tv)
    ((out * _t(g_out)).sum() + (lse * _t(g_lse)).sum()).backward()
    return [a.detach().numpy() for a in (out, lse, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_values_and_grads_match_jax(causal):
    q, k, v, g_out, g_lse = _qkv(2, 24, 4, 2, 8, seed=4)
    ref = _jax_value_and_grads(
        lambda q, k, v: jattn.mha_reference_with_lse(
            q, k, v, causal=causal, q_offset=8, k_offset=4),
        q, k, v, g_out, g_lse)
    got = _torch_value_and_grads(
        lambda q, k, v: tattn.mha_reference_with_lse(
            q, k, v, causal=causal, q_offset=8, k_offset=4),
        q, k, v, g_out, g_lse)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_mha_reference_lse_only_gradient_matches_jax():
    """A function of lse alone (what the ring-attention merge needs)."""
    q, k, v, _, g_lse = _qkv(1, 16, 2, 2, 8, seed=5)

    def jf(q, k, v):
        return jnp.sum(jattn.mha_reference_with_lse(q, k, v)[1] * g_lse)

    ref = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    (tattn.mha_reference_with_lse(tq, tk, tv)[1] * _t(g_lse)).sum().backward()
    assert tv.grad is None  # lse does not depend on v: JAX's grad is zeros
    for t, r in zip((tq, tk), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **F32_TOL)
    assert not np.asarray(ref[2]).any()


# (causal, h, hkv, s, d) and the case's id. The first four run two q and
# k blocks of 64 at d = 16 with h = 4; the next four run s = 192, three JAX
# blocks, which is no multiple of the card kernels' 128-row tiles, at the
# head dims they are built for, with group 4; the last two run group 8 (one
# kv head), the group at which every dk/dv tile takes the most query heads
_FLASH_INTERPRET_CASES = [
    pytest.param(True, 4, 4, 128, 16, id="group1-True"),
    pytest.param(True, 4, 2, 128, 16, id="group2-True"),
    pytest.param(False, 4, 4, 128, 16, id="group1-False"),
    pytest.param(False, 4, 2, 128, 16, id="group2-False"),
] + [
    pytest.param(causal, 4, 1, 192, d, id=f"s192-d{d}-group4-{causal}")
    for d in (64, 128) for causal in (True, False)
] + [
    pytest.param(causal, 8, 1, 128, 16, id=f"group8-{causal}")
    for causal in (True, False)
]


@pytest.mark.parametrize("causal,h,hkv,s,d", _FLASH_INTERPRET_CASES)
def test_flash_attention_cpu_matches_pallas_interpret(causal, h, hkv, s, d):
    """Out, lse and the q/k/v grads (lse cotangent included) of the port's
    flash attention on the CPU against the Pallas fwd/dq/dkv kernels in
    interpret mode, with JAX blocks of 64."""
    q, k, v, g_out, g_lse = _qkv(1, s, h, hkv, d, seed=6)
    ref = _jax_value_and_grads(
        lambda q, k, v: jattn.flash_attention_with_lse(
            q, k, v, causal, 64, 64, True),
        q, k, v, g_out, g_lse)
    got = _torch_value_and_grads(
        lambda q, k, v: tattn.flash_attention_with_lse(q, k, v, causal),
        q, k, v, g_out, g_lse)
    # f32 blockwise (Pallas) vs dense (plain): summation order only
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_flash_plain_kernel_versions_match_autograd():
    """The plain dq and dk/dv (what the card's kernels are held to) equal
    autograd through the reference, lse cotangent folded into delta."""
    q, k, v, g_out, g_lse = _qkv(2, 20, 4, 2, 8, seed=7)
    ref = _torch_value_and_grads(
        lambda q, k, v: tattn.mha_reference_with_lse(q, k, v, causal=True),
        q, k, v, g_out, g_lse)
    tq, tk, tv, tg = _t(q), _t(k), _t(v), _t(g_out)
    out, lse = tattn.mha_reference_with_lse(tq, tk, tv, True)
    delta = tattn.attention_delta(out, tg, _t(g_lse))
    dq = tattn.flash_bwd_dq_plain(tq, tk, tv, tg, lse, delta, True)
    dk, dv = tattn.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta, True)
    for a, b in zip((dq, dk, dv), ref[2:]):
        np.testing.assert_allclose(a.numpy(), b, **F32_TOL)


@pytest.mark.parametrize("h,hkv", [(8, 1), (4, 4)])
def test_flash_bwd_dkv_cpu_path_returns_k_dtype_and_shape(h, hkv):
    """dk and dv come back in k's dtype and shape, with a group (where the
    card's kernel adds into f32 sums) and without."""
    q, k, v, g_out, _ = _qkv(2, 12, h, hkv, 16, seed=10)
    tq, tk, tv, tg = (_t(a).to(torch.bfloat16) for a in (q, k, v, g_out))
    out, lse = tattn.flash_fwd(tq, tk, tv, True)
    delta = tattn.attention_delta(out, tg, torch.zeros_like(lse))
    dk, dv = tattn.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, True)
    for g, ref in ((dk, tk), (dv, tv)):
        assert g.dtype == torch.bfloat16 and g.shape == ref.shape
        assert torch.isfinite(g.float()).all()


def test_attention_delta_is_rowsum_of_do_times_o_minus_g_lse():
    """delta = sum_d do * o - g_lse, f32 (b, h, s) and contiguous, from bf16
    o and do: each product is exact in f32, only the sum's order differs."""
    rng = _rng(11)
    o = _t(rng.standard_normal((2, 5, 3, 16))).to(torch.bfloat16)
    do = _t(rng.standard_normal((2, 5, 3, 16))).to(torch.bfloat16)
    g_lse = _t(rng.standard_normal((2, 3, 5)).astype(np.float32))
    got = tattn.attention_delta(o, do, g_lse)
    ref = (np.einsum("bshd,bshd->bhs", do.float().numpy().astype(np.float64),
                     o.float().numpy().astype(np.float64))
           - g_lse.numpy())
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_flash_wrappers_cpu_path_launches_nothing():
    q, k, v, _, _ = _qkv(1, 8, 2, 1, 8, seed=8)
    tattn.reset_launch_counts()
    tattn.flash_attention(_t(q), _t(k), _t(v))
    assert tattn.launch_counts == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert tattn._lib is None  # no kernel library was built or loaded


def test_flash_wrapper_refuses_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel or raises."""
    q = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tattn.flash_fwd(q, q, q, True)


def _ce_inputs(seed, n_tok=(2, 9), d=16, vocab=100):
    rng = _rng(seed)
    x = rng.standard_normal((*n_tok, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, vocab))).astype(np.float32)
    tgt = rng.integers(0, vocab, n_tok).astype(np.int32)
    return x, w, tgt


@pytest.mark.parametrize("masked", ["some", "all"])
def test_chunked_ce_values_and_grads_match_jax(masked):
    """Chunk 32 does not divide the vocab of 100 (last chunk 4 wide)."""
    x, w, tgt = _ce_inputs(9)
    if masked == "all":
        tgt[:] = -1
    else:
        tgt[0, :3] = -1
        tgt[1, -1] = 99  # the last real column, in the narrow chunk

    def jf(x, w):
        nll, n = j_chunked_ce(x, w, jnp.asarray(tgt), chunk_size=32)
        return nll, n

    (j_nll, j_n), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = vjp((jnp.float32(1.5), jnp.float32(0.0)))
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    nll, n = chunked_cross_entropy(tx, tw, _t(tgt), chunk_size=32)
    (1.5 * nll).backward()
    np.testing.assert_allclose(nll.item(), float(j_nll), rtol=1e-5)
    assert n.item() == float(j_n)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), **F32_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), **F32_TOL)
    if masked == "all":
        assert nll.item() == 0.0 and not tw.grad.any()
