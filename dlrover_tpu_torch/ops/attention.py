"""Attention: plain PyTorch reference + hand-written Hopper flash attention
(forward, dq, dk/dv) behind one differentiable surface.

Port of dlrover_tpu/ops/attention.py. Layout everywhere: ``(batch, seq,
n_heads, head_dim)``; GQA via ``n_kv_heads <= n_heads`` (kv head
``h // group`` serves query head ``h``, resolved by the kernels' indexing,
never materialized).

`flash_attention_with_lse` is a `torch.autograd.Function` returning
``(out, lse)``, ``lse`` being the per-row logsumexp of the scaled logits in
float32, shaped ``(b, h, s)``:

- **forward**: the ``flash_fwd`` kernel (online softmax, the s x s matrix
  never exists);
- **backward**: the ``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels, which
  recompute probabilities blockwise from (q, k, v, lse). The ``lse`` output
  is differentiable: its cotangent folds into ``delta``
  (``ds = p * (dp - (rowsum(do * o) - g_lse))``), which ring attention's
  logsumexp merge relies on.

Kernels (``csrc/flash_attn.cu``, head dims 64 and 128), all three written
for Hopper on one design: a block of one producer and two consumer
warpgroups owns a 128-row tile of one (batch, head); the producer loads the
block's own tiles once and streams tiles of the other sequence axis by TMA
(rank-4 tensor maps over (d, s, head, batch), built by the C entry point at
each launch) through a 3-stage mbarrier ring; each consumer warpgroup owns
64 of the rows and runs ``wgmma``, with probabilities and gradients passed
from the accumulators to the next product as bf16 register operands.

- forward: 128-key K and V tiles; ``S = Q K^T`` and ``O += P V`` around an
  online softmax on the accumulators.
- dq: a 128-query block streams 64-key K and V tiles; ``S = Q K^T``,
  ``dP = dO V^T``, ``dS = P (dP - delta) scale``, ``dQ += dS K``; dQ of one
  tile runs on the tensor cores while the next tile's dS is computed.
- dk/dv: a 128-key block of one *query* head streams 64-query Q and dO
  tiles with their lse and delta; ``S^T = K Q^T``, ``dP^T = V dO^T``,
  ``dV += P^T dO``, ``dK += dS^T Q``, so no transpose is stored. One block a
  query head (not a kv head) balances the causal grid; with GQA each
  block writes its f32 sums once into a ``(b, h, sk, d)`` scratch, and a
  second kernel of the same launch adds each kv head's group in head order
  and casts to bf16, so dk and dv are the same bits on every run, as the
  Pallas kernel's (it sums the group on chip and writes once).

``chip_smoke.py`` checks each kernel against its plain version below and
counts the wgmma (``HGMMA``) and TMA (``UTMALDG``) instructions in each
kernel's SASS.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version of each kernel (kept beside it here); a CUDA tensor launches the
kernel, or raises when the card is not sm_90. There is no fallback from a
CUDA tensor to the plain path. Each kernel launch adds one to its entry in
``launch_counts``. The ``attention_fwd`` / ``attention_bwd`` profiler
scopes carry the JAX package's attribution names.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

_NEG_INF = -1e30  # finite sentinel: exp(-1e30 - -1e30) = 1, never nan

#: kernel launches since the last ``reset_launch_counts()``
launch_counts: Dict[str, int] = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def mha_reference_with_lse(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, hkv, d)
    v: torch.Tensor,  # (b, sk, hkv, d)
    causal: bool = True,
    q_offset: int = 0,
    k_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-softmax attention in float32, GQA-aware; returns
    ``(out (b,sq,h,d), lse (b,h,sq))``. ``q_offset`` / ``k_offset`` are the
    global positions of element 0 (ring-attention chunks mask causally
    against each other with them)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask, logits, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)  # (b, h, sq)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def mha_reference(q, k, v, causal: bool = True, q_offset: int = 0,
                  k_offset: int = 0) -> torch.Tensor:
    return mha_reference_with_lse(
        q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset
    )[0]


# ---------------------------------------------------------------------------
# plain versions of the backward kernels (the forward's is
# mha_reference_with_lse): the CPU path, and what the card's kernels are
# held to
# ---------------------------------------------------------------------------


def _bwd_terms(q, k, v, dout, lse, delta, causal):
    """f32 ``(p, ds, k_rep)`` over (b, h, sq, sk), kv heads repeated."""
    b, sq, h, d = q.shape
    group = h // k.shape[2]
    k_rep = k.float().repeat_interleave(group, dim=2)
    v_rep = v.float().repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k_rep)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v_rep)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, k_rep


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool):
    _, ds, k_rep = _bwd_terms(q, k, v, dout, lse, delta, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k_rep).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool):
    b, sk, hkv, d = k.shape
    group = q.shape[2] // hkv
    p, ds, _ = _bwd_terms(q, k, v, dout, lse, delta, causal)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    # the group's query heads sum into their kv head
    dk = dk.reshape(b, sk, hkv, group, d).sum(dim=3)
    dv = dv.reshape(b, sk, hkv, group, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------


def _kernels():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flash_attn")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i, i, i, i, i, i, f, i, p]  # b sq sk h hkv d scale causal stream
        lib.dlrover_flash_fwd.argtypes = [p] * 5 + dims
        lib.dlrover_flash_bwd_dq.argtypes = [p] * 7 + dims
        lib.dlrover_flash_bwd_dkv.argtypes = [p] * 10 + dims
        lib.dlrover_flash_supports_head_dim.argtypes = [i]
        for fn in (lib.dlrover_flash_fwd, lib.dlrover_flash_bwd_dq,
                   lib.dlrover_flash_bwd_dkv,
                   lib.dlrover_flash_supports_head_dim):
            fn.restype = i
        _lib = lib
    return _lib


def _on_cpu(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: unsupported device {q.device}")
    return False


def _check_cuda(q, k, v, dout=None, lse=None, delta=None):
    """Device, dtype, shape and contiguity checks before a launch; returns
    the dims the kernels take."""
    dev = q.device
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(
            f"flash attention kernels are built for sm_90a; {dev} is "
            f"sm_{cap[0]}{cap[1]}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, hkv, dk_ = k.shape
    if k.shape[0] != b or dk_ != d or hkv == 0 or h % hkv:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if not _kernels().dlrover_flash_supports_head_dim(d):
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {dev}, got {t.dtype} "
                             f"on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"dout{tuple(dout.shape)} != q{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (b, h, sq) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 {(b, h, sq)} on "
                             f"{dev}")
    return b, sq, sk, h, hkv, d


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"flash {kernel} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, causal: bool):
    """``(o, lse)`` of attention: the forward kernel on the card."""
    if _on_cpu(q):
        return mha_reference_with_lse(q, k, v, causal=causal)
    b, sq, sk, h, hkv, d = _check_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _kernels().dlrover_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, hkv, d, 1.0 / math.sqrt(d),
            int(causal), _stream(q),
        )
    _raise_on(rc, "fwd")
    launch_counts["fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool):
    """dq from the blockwise recompute: the dq kernel on the card."""
    if _on_cpu(q):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal)
    b, sq, sk, h, hkv, d = _check_cuda(q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _kernels().dlrover_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, sk, h, hkv, d, 1.0 / math.sqrt(d), int(causal),
            _stream(q),
        )
    _raise_on(rc, "bwd_dq")
    launch_counts["bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool):
    """(dk, dv), summed over each kv head's query group: the dk/dv kernel
    on the card. With a group of one the kernel stores dk and dv; with more,
    each query head's f32 sums go to a scratch that the launch's second
    kernel adds by kv head in head order (deterministic)."""
    if _on_cpu(q):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal)
    b, sq, sk, h, hkv, d = _check_cuda(q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = None
    if h != hkv:
        part = torch.empty((2, b, h, sk, d), dtype=torch.float32,
                           device=k.device)
    with torch.cuda.device(q.device):
        rc = _kernels().dlrover_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            b, sq, sk, h, hkv, d, 1.0 / math.sqrt(d), int(causal), _stream(q),
        )
    _raise_on(rc, "bwd_dkv")
    launch_counts["bwd_dkv"] += 1
    return dk, dv


def attention_delta(out, g_out, g_lse):
    """``rowsum(do * o) - g_lse`` as a contiguous f32 (b, h, s) vector: the
    lse cotangent folds in here. One f32 product (``out`` converted inside
    the multiply), summed over the head dim."""
    delta = (g_out.float() * out).sum(dim=-1).transpose(1, 2)
    return (delta - g_lse.float()).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        with record_function("attention_fwd"):
            out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        with record_function("attention_bwd"):
            g_out = g_out.contiguous()
            delta = attention_delta(out, g_out, g_lse)
            dq = flash_bwd_dq(q, k, v, g_out, lse, delta, ctx.causal)
            dk, dv = flash_bwd_dkv(q, k, v, g_out, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """``(out (b,s,h,d), lse (b,h,s) f32)`` — both differentiable."""
    return _FlashAttention.apply(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    return flash_attention_with_lse(q, k, v, causal)[0]
