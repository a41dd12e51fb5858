"""Chunked fused cross-entropy: unembed matmul + softmax-CE without the
[B, T, V] logits (port of dlrover_tpu/ops/chunked_ce.py).

The loss iterates vocab chunks: per-chunk f32 logits, a streaming
logsumexp ``(max, sumexp)`` carry, and the target logit gathered from the
one chunk that holds it. The backward recomputes each chunk's logits from
the saved ``(x, logz)`` and writes one disjoint chunk of ``dw`` at a time,
so no ``[tokens, V]`` tensor exists in either direction.

The JAX package pads the vocab to a chunk multiple with padded columns at
-inf; here the last chunk is simply narrower, which gives the same sums
(a -inf column adds exp(-inf) = 0) without a padded copy of the lm-head.

Logit precision: operands are in the compute dtype and the products
accumulate in f32, as the JAX package's ``preferred_element_type`` does.
On the card a bf16 product asks cuBLAS for an f32 output
(``torch.mm(..., out_dtype=torch.float32)``); on the CPU the bf16 operands
are upcast to f32 first, which gives the same exact products.

This op has no Pallas kernel, so ``torch.mm`` per chunk is its port. It is
the path behind ``DLROVER_TPU_FUSED_CE=0``; the models reach it through
``ops/fused_ce.py::cross_entropy_sums``, whose default is the fused kernels.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from dlrover_tpu_torch.common import flags

#: default vocab-chunk width (columns per loop step)
DEFAULT_CHUNK_SIZE = 2048


def chunked_ce_enabled() -> bool:
    """Env kill-switch: ``DLROVER_TPU_CHUNKED_CE=0`` restores the dense
    [B, T, V] logits path wherever the model routes through this op."""
    return flags.CHUNKED_CE.get()


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D compute-dtype operands with an f32 result."""
    if a.dtype == torch.float32:
        return a @ b.float()
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chunked_cross_entropy(
    x: torch.Tensor,
    w_unembed: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
):
    """Fused ``softmax_ce(x @ w_unembed, targets)`` in vocab chunks.

    Args:
      x: ``(..., d)`` hidden states (post final-norm, pre-unembed).
      w_unembed: ``(d, v)`` unembedding / lm-head weights.
      targets: ``(...)`` integer class ids; ``targets < 0`` are ignored.
      chunk_size: vocab columns per loop step (clipped to ``v``).

    Returns:
      ``(nll_sum, n_valid)``: the f32 sum of per-token negative
      log-likelihoods over valid targets, and the f32 count of valid
      targets (not differentiable).
    """
    if tuple(x.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"x leading dims {tuple(x.shape[:-1])} != targets shape "
            f"{tuple(targets.shape)}"
        )
    if x.shape[-1] != w_unembed.shape[0]:
        raise ValueError(
            f"x feature dim {x.shape[-1]} != w_unembed rows "
            f"{w_unembed.shape[0]}"
        )
    chunk = max(1, min(int(chunk_size), w_unembed.shape[1]))
    return _ChunkedCE.apply(x, w_unembed, targets, chunk)


def _chunks(v: int, chunk: int):
    for start in range(0, v, chunk):
        yield start, min(chunk, v - start)


def _target_in_chunk(tgt_c, start: int, width: int):
    local = tgt_c - start
    in_chunk = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), in_chunk


def _ce_forward(chunk: int, x2, w, tgt):
    """Streaming-lse forward over (n, d) tokens; returns
    ``(nll_sum, n_valid, logz)`` with logz ``(n,)`` kept for the backward."""
    n = x2.shape[0]
    valid = tgt >= 0
    vf = valid.float()
    tgt_c = torch.where(valid, tgt, 0)
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=x2.device)
    s = torch.zeros(n, dtype=torch.float32, device=x2.device)
    gold = torch.zeros(n, dtype=torch.float32, device=x2.device)
    for start, width in _chunks(w.shape[1], chunk):
        logits = matmul_f32(x2, w[:, start:start + width].to(x2.dtype))
        # every chunk holds >= 1 real column, so m_new is finite from the
        # first chunk on and the -inf initial max contributes exp(-inf) = 0
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]
        ).sum(dim=-1)
        local, in_chunk = _target_in_chunk(tgt_c, start, width)
        g = logits.gather(1, local[:, None])[:, 0]
        gold = torch.where(in_chunk, g, gold)
        m = m_new
    logz = m + torch.log(s)
    return torch.sum((logz - gold) * vf), torch.sum(vf), logz


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, chunk):
        x2 = x.reshape(-1, x.shape[-1])
        tgt = targets.reshape(-1).long()
        with record_function("chunked_ce_fwd"):
            nll_sum, n_valid, logz = _ce_forward(chunk, x2, w, tgt)
        ctx.save_for_backward(x2, w, tgt, logz)
        ctx.chunk = chunk
        ctx.x_shape = x.shape
        ctx.mark_non_differentiable(n_valid)
        return nll_sum, n_valid

    @staticmethod
    def backward(ctx, g_nll, _g_n_valid):
        x2, w, tgt, logz = ctx.saved_tensors
        with record_function("chunked_ce_bwd"):
            dx, dw = _ce_backward(ctx.chunk, x2, w, tgt, logz, g_nll)
        return dx.reshape(ctx.x_shape), dw, None, None


def _ce_backward(chunk: int, x2, w, tgt, logz, g_nll):
    """d(nll_sum)/d(logits_c) = (softmax_c - onehot_c) * valid, chunk by
    chunk: dx sums over chunks in an f32 accumulator; each dw chunk is
    written exactly once, in w's dtype."""
    valid = tgt >= 0
    tgt_c = torch.where(valid, tgt, 0)
    row_scale = (valid.float() * g_nll.float())[:, None]
    dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    rows = torch.arange(x2.shape[0], device=x2.device)
    for start, width in _chunks(w.shape[1], chunk):
        w_c = w[:, start:start + width].to(x2.dtype)
        p = torch.exp(matmul_f32(x2, w_c) - logz[:, None])
        local, in_chunk = _target_in_chunk(tgt_c, start, width)
        p[rows, local] -= in_chunk.float()  # minus the one-hot
        q = (p * row_scale).to(x2.dtype)
        dx += matmul_f32(q, w_c.t())
        dw[:, start:start + width] = matmul_f32(x2.t(), q).to(w.dtype)
    return dx.to(x2.dtype), dw
