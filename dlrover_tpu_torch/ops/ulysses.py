"""Ulysses (all-to-all) sequence parallelism (port of
dlrover_tpu/ops/ulysses.py).

Over an sp group of ``P`` ranks, each holding a contiguous chunk of the
sequence::

    in : (b, s/P, h,   d)  sequence-split, as the rest of the layer runs
    a2a: (b, s,   h/P, d)  head-split: each rank holds the whole sequence
                           of its h/P heads
    the flash kernels on the whole sequence, causal as the model asks
    a2a: (b, s/P, h,   d)  back to sequence-split

Heads are independent in attention, so the result is the whole layer's
attention, exactly. Each all-to-all is one ``torch.autograd.Function``
(``_AllToAll``) whose backward is the inverse all-to-all; it runs
``dist.all_to_all_single`` on a contiguous buffer, chunk ``j`` to group
rank ``j``, as ``lax.all_to_all(..., tiled=True)`` does. It moves data and
computes nothing, so it stands in for no kernel.

GQA: when ``P`` does not divide the kv head count, each kv head is
repeated ``P / gcd(hkv, P)`` times (``repeat_interleave`` on the head dim,
``jnp.repeat``), which keeps the kernels' query-to-kv-head index; the
backward sums the copies' gradients. Shapes where even that gives no
valid grouping (``h % lcm(hkv, P) != 0``) raise, pointing at ring
attention, as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from dlrover_tpu_torch.ops.attention import flash_attention


def _all_to_all(x: torch.Tensor, group, split: int, cat: int) -> torch.Tensor:
    """``x`` cut into the group's size of chunks along ``split``, chunk
    ``j`` sent to group rank ``j``, and the chunks received joined along
    ``cat`` in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = torch.stack(x.chunk(n, dim=split))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.cat(out.unbind(0), dim=cat)


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` forward; the inverse all-to-all (``cat`` and
    ``split`` swapped) backward."""

    @staticmethod
    def forward(ctx, x, group, split, cat):
        ctx.group, ctx.split, ctx.cat = group, split, cat
        return _all_to_all(x, group, split, cat)

    @staticmethod
    def backward(ctx, grad):
        return (_all_to_all(grad, ctx.group, ctx.cat, ctx.split), None, None,
                None)


def _scatter_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(b, s/P, h, d) -> (b, s, h/P, d): scatter heads, gather the
    sequence."""
    return _AllToAll.apply(x, group, 2, 1)


def _gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """(b, s, h/P, d) -> (b, s/P, h, d): gather heads, scatter the
    sequence."""
    return _AllToAll.apply(x, group, 1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = True) -> torch.Tensor:
    """Attention of this rank's chunk of the sequence over the whole of it
    in ``group`` (sp order). q ``(b, s/P, h, d)``, k and v ``(b, s/P,
    hkv, d)``; returns this rank's ``(b, s/P, h, d)`` output."""
    import torch.distributed as dist

    sp = dist.get_world_size(group)
    h, hkv = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses needs query heads divisible by sp: h={h} sp={sp}"
            " (use ring attention otherwise)")
    if hkv % sp:
        rep = sp // math.gcd(hkv, sp)
        if h % (hkv * rep):
            raise ValueError(
                f"ulysses GQA replication needs h % lcm(hkv, sp) == 0: "
                f"h={h} hkv={hkv} sp={sp} (lcm={hkv * rep}); use ring "
                "attention for this shape")
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    out = flash_attention(_scatter_heads(q, group), _scatter_heads(k, group),
                          _scatter_heads(v, group), causal=causal)
    return _gather_heads(out, group)
