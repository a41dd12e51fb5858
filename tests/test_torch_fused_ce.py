"""The port's fused lm-head cross-entropy against the JAX package's, on the
CPU.

The reference is ``dlrover_tpu.ops.fused_ce.fused_cross_entropy`` with
``interpret=True``: the Pallas fwd / dx / dw kernels run on the CPU, as
tests/test_fused_ce.py runs them. The port's CPU path is the plain version
of each of its Hopper kernels. Everything is float32, where the port's
rounding of the lm-head and of q to the compute dtype is the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import fused_ce as jfce
from dlrover_tpu_torch.ops import fused_ce as fce

# f32 on both sides; only the order of sums differs
F32_TOL = dict(rtol=1e-5, atol=1e-6)

B, T, D, V = 3, 8, 16, 300  # as tests/test_fused_ce.py


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _inputs(case, seed=0, v=V):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w = (0.1 * rng.normal(size=(D, v))).astype(np.float32)
    t = rng.integers(0, v, size=(B, T)).astype(np.int32)
    if case == "masked_tail":
        t[:, -2:] = -1
        t[0, 0] = -1
    elif case == "all_masked":
        t[:] = -1
    elif case == "last_column":
        t[:, ::2] = v - 1
        t[2, -1] = -1
    return x, w, t


def _port(x, w, t, g_nll):
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    nll, n = fce.fused_cross_entropy(tx, tw, _t(t))
    (g_nll * nll).backward()
    return nll.item(), n.item(), tx.grad.numpy(), tw.grad.numpy()


def _pallas_logz_gold(x2, w, t1, bt, bv):
    """Per-token ``(logz, gold)`` of the Pallas forward kernel, run as
    the JAX package's fused CE runs it: operands padded to its tiles."""
    n, v = x2.shape[0], w.shape[1]
    bt, bv, n_pad, v_pad = jfce._tile_geometry(n, v, bt, bv)
    xp, wp, tp = jfce._pad_operands(jnp.asarray(x2), jnp.asarray(w),
                                    jnp.asarray(t1), n_pad, v_pad)
    logz, gold = jfce._fused_ce_fwd_pallas(xp, wp, tp, v, bt, bv, True)
    return np.asarray(logz)[:n], np.asarray(gold)[:n]


@pytest.mark.parametrize("case,v", [
    ("masked_tail", V), ("all_masked", V), ("last_column", V),
    # 384 = 256 + 128: one full forward tile of the port and one half tile
    ("masked_tail", 384), ("last_column", 384),
], ids=["masked_tail", "all_masked", "last_column", "masked_tail_v384",
        "last_column_v384"])
@pytest.mark.parametrize("bt,bv", [(8, 128), (64, 512)])
def test_matches_pallas_interpret(case, v, bt, bv):
    """logz and gold of every token, nll_sum, n_valid, dx and dw against
    the Pallas kernels with JAX tiles (8, 128) and (64, 512), under a
    cotangent of 1.5."""
    x, w, t = _inputs(case, v=v)

    def jf(x, w):
        return jfce.fused_cross_entropy(x, w, jnp.asarray(t), block_t=bt,
                                        block_v=bv, interpret=True)

    (j_nll, j_n), vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = vjp((jnp.float32(1.5), jnp.float32(0.0)))
    x2, t1 = x.reshape(-1, D), t.reshape(-1)
    j_logz, j_gold = _pallas_logz_gold(x2, w, t1, bt, bv)
    tt = _t(t1)
    logz, gold = fce.fused_ce_merge(fce.fused_ce_fwd(
        _t(x2), fce.compute_weight(_t(w), torch.float32), tt, v))
    np.testing.assert_allclose(logz.numpy(), j_logz, **F32_TOL)
    np.testing.assert_allclose(gold.numpy(), j_gold, **F32_TOL)
    nll, n, dx, dw = _port(x, w, t, 1.5)
    np.testing.assert_allclose(nll, float(j_nll), rtol=1e-5, atol=1e-6)
    assert n == float(j_n) == float((t >= 0).sum())
    np.testing.assert_allclose(dx, np.asarray(j_dx), **F32_TOL)
    np.testing.assert_allclose(dw, np.asarray(j_dw), **F32_TOL)
    if case == "all_masked":
        assert nll == 0.0 and n == 0.0
        assert not dx.any() and not dw.any()


def _dense(x, w, t):
    """Dense CE through autograd: (logits, logz, gold, nll_sum, dlogits,
    dx, dw) under a cotangent of 1.5 on nll_sum."""
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    logits = tx @ tw
    logits.retain_grad()
    tt = _t(t).long()
    valid = (tt >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tt.clamp(min=0)[:, None])[:, 0]
    nll = torch.sum((logz - gold) * valid)
    (1.5 * nll).backward()
    return (logz.detach(), gold.detach() * valid, logits.grad, tx.grad,
            tw.grad)


@pytest.mark.parametrize("case,v,vp,widths", [
    ("masked_tail", V, 304, [64, 64, 64, 64, 48]),
    ("last_column", V, 304, [64, 64, 64, 64, 48]),
    ("last_column", 384, 384, [64] * 6),
], ids=["masked_tail", "last_column", "last_column_v384"])
def test_plain_kernel_versions_match_autograd(case, v, vp, widths):
    """Each plain version (what the card's kernels are held to) against
    autograd through the dense CE: fwd + merge give logz and gold, q is
    d(1.5 nll)/d(logits) chunk by chunk, and dx and dw sum and write the
    chunks. 64-column chunks over V = 300 (padded to 304): five chunks,
    the last 48 wide; two 256-column forward tiles, the last 44 wide. Over
    v = 384: six chunks, and a full tile then a half one (128 wide) that
    holds the targets of the last_column case."""
    x, w, t = _inputs(case, seed=1, v=v)
    x2, t1 = x.reshape(-1, D), t.reshape(-1)
    logz_r, gold_r, dlogits, dx_r, dw_r = _dense(x2, w, t1)

    tx, tt = _t(x2), _t(t1)
    wc = fce.compute_weight(_t(w), torch.float32)
    assert tuple(wc.shape) == (D, vp) and not wc[:, v:].any()
    part = fce.fused_ce_fwd_plain(tx, wc, tt, v)
    assert fce.FWD_TILE == 256 and tuple(part.shape) == (3, 2, B * T)
    # the last tile's partials cover only its real columns
    last = v - fce.FWD_TILE
    lt = torch.tensor(x2 @ w[:, fce.FWD_TILE:])
    assert lt.shape[1] == last
    np.testing.assert_allclose(part[0, 1].numpy(), lt.max(dim=1).values,
                               **F32_TOL)
    logz, gold = fce.fused_ce_merge_plain(part)
    np.testing.assert_allclose(logz.numpy(), logz_r.numpy(), **F32_TOL)
    np.testing.assert_allclose(gold.numpy(), gold_r.numpy(), **F32_TOL)

    scale = (tt >= 0).float() * 1.5
    dx = torch.zeros(x2.shape)
    dw = torch.empty((D, v))
    seen = []
    for c0 in range(0, vp, 64):
        cw = min(64, vp - c0)
        seen.append(cw)
        q = fce.fused_ce_bwd_q_plain(tx, wc, tt, logz, scale, v, c0, cw)
        real = min(cw, v - c0)
        np.testing.assert_allclose(q[:, :real].numpy(),
                                   dlogits[:, c0:c0 + real].numpy(), **F32_TOL)
        assert not q[:, real:].any()  # padded columns carry no gradient
        fce.fused_ce_bwd_dx_plain(q, wc, c0, dx)
        fce.fused_ce_bwd_dw_plain(tx, q, v, c0, dw)
    assert seen == widths
    np.testing.assert_allclose(dx.numpy(), dx_r.numpy(), **F32_TOL)
    np.testing.assert_allclose(dw.numpy(), dw_r.numpy(), **F32_TOL)


def test_backward_chunking_does_not_change_the_result(monkeypatch):
    x, w, t = _inputs("masked_tail", seed=2)
    one = _port(x, w, t, 1.0)
    monkeypatch.setattr(fce, "BWD_CHUNK", 64)
    five = _port(x, w, t, 1.0)
    assert one[:2] == five[:2]
    for a, b in zip(one[2:], five[2:]):
        np.testing.assert_allclose(a, b, **F32_TOL)


def test_bf16_operands_f32_sums_and_grad_dtypes():
    """bf16 x with an f32 lm-head: the sums are f32 and equal the f32 CE of
    the bf16-rounded operands; dx comes back bf16, dw in w's f32."""
    x, w, t = _inputs("masked_tail", seed=3)
    xb = _t(x).to(torch.bfloat16).requires_grad_(True)
    tw = _t(w, grad=True)
    nll, n = fce.fused_cross_entropy(xb, tw, _t(t))
    nll.backward()
    assert nll.dtype == torch.float32 and n.dtype == torch.float32
    assert xb.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    xr = xb.detach().float().reshape(-1, D)
    logits = xr @ _t(w).to(torch.bfloat16).float()
    tt = _t(t).reshape(-1).long()
    valid = (tt >= 0).float()
    ref = torch.sum((torch.logsumexp(logits, -1) - logits.gather(
        -1, tt.clamp(min=0)[:, None])[:, 0]) * valid)
    np.testing.assert_allclose(nll.item(), ref.item(), rtol=1e-5)


def test_default_flag_takes_the_fused_plain_path(monkeypatch):
    """With the flag at its default, ``cross_entropy_sums`` runs the fused
    path: on CPU tensors that is the plain versions, so no kernel launches
    and no library is built or loaded."""
    monkeypatch.delenv("DLROVER_TPU_FUSED_CE", raising=False)
    called = []
    monkeypatch.setattr(fce, "chunked_cross_entropy",
                        lambda *a, **k: called.append(1))
    assert fce.fused_ce_enabled()
    x, w, t = _inputs("masked_tail", seed=4)
    fce.reset_launch_counts()
    nll, _ = fce.cross_entropy_sums(_t(x, grad=True), _t(w), _t(t))
    nll.backward()
    assert not called
    assert fce.launch_counts == {k: 0 for k in fce.launch_counts}
    assert fce._lib is None


def test_kill_switch_takes_the_chunked_path(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FUSED_CE", "0")
    assert not fce.fused_ce_enabled()
    seen = []
    real = fce.chunked_cross_entropy

    def spy(*args, **kwargs):
        seen.append(kwargs["chunk_size"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fce, "chunked_cross_entropy", spy)
    x, w, t = _inputs("masked_tail", seed=5)
    got = fce.cross_entropy_sums(_t(x), _t(w), _t(t), chunk_size=96)
    assert seen == [96]
    ref = fce.fused_cross_entropy(_t(x), _t(w), _t(t))
    np.testing.assert_allclose(got[0].item(), ref[0].item(), rtol=1e-5)


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device either
    launches the kernel or raises."""
    x = torch.empty((4, 16), device="meta")
    w = torch.empty((16, 304), device="meta")
    t = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fce.fused_ce_fwd(x, w, t, 300)
    with pytest.raises(RuntimeError, match="unsupported device"):
        fce.fused_ce_merge(torch.empty((3, 4, 3), device="meta"))


def test_shape_validation():
    x, w, t = _inputs("masked_tail")
    with pytest.raises(ValueError, match="targets shape"):
        fce.fused_cross_entropy(_t(x), _t(w), _t(t[:, :-1]))
    with pytest.raises(ValueError, match="w_unembed rows"):
        fce.fused_cross_entropy(_t(x[..., :-1]), _t(w), _t(t))


def test_cuda_source_constants_match_the_wrapper():
    """The forward's vocab tile in fused_ce.cu is the wrapper's FWD_TILE:
    the constant that ``dlrover_ce_tile()`` returns (the one the wrapper
    checks when it loads the library), defined once across fused_ce.cu and
    the headers beside it, so another kernel's tile constant cannot
    shadow or stand in for it."""
    import re

    from dlrover_tpu_torch.ops import cuda_build

    assert cuda_build.sources() == ["flash_attn", "fused_ce"]
    src = (cuda_build.CSRC_DIR / "fused_ce.cu").read_text()
    (name,) = re.findall(r"int dlrover_ce_tile\(\) \{ return (\w+); \}", src)
    texts = [src] + [h.read_text()
                     for h in sorted(cuda_build.CSRC_DIR.glob("*.cuh"))]
    defs = [v for text in texts
            for v in re.findall(rf"constexpr int {name} = (\d+);", text)]
    assert defs == [str(fce.FWD_TILE)]


@pytest.mark.parametrize("change", ["edit", "add"])
def test_library_path_hashes_the_headers(monkeypatch, tmp_path, change):
    """A library is named by a hash of its source and of every header under
    csrc/, so editing or adding a header that a source includes rebuilds
    it rather than loading a stale library."""
    from dlrover_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "loop.cuh"\n')
    (tmp_path / "loop.cuh").write_text("constexpr int BN = 256;\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build.library_path("k")
    assert before == cuda_build.library_path("k")
    if change == "edit":
        (tmp_path / "loop.cuh").write_text("constexpr int BN = 128;\n")
    else:
        (tmp_path / "extra.cuh").write_text("// another header\n")
    after = cuda_build.library_path("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libk-")
    assert cuda_build.sources() == ["k"]  # a header is no source of its own
