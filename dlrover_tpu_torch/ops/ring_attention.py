"""Ring attention: exact attention over a sequence split into contiguous
chunks over a process group (port of dlrover_tpu/ops/ring_attention.py).

Each rank of the sp group holds one chunk of ``s/sp`` positions of q, k and
v, rank ``i`` chunk ``i``. The kv chunks travel round the ring, rank ``i``
to rank ``i+1``, and at every step the rank runs the flash kernels on its
own q against the visiting chunk (``flash_attention_with_lse``: the s x s
matrix never exists, GQA by index). The per-chunk results merge by the
logsumexp combine in f32, as the JAX package merges them::

    lse = logaddexp(lse_acc, lse_i)
    out = out_acc · exp(lse_acc - lse) + out_i · exp(lse_i - lse)

which is exact and differentiable: the flash kernels' ``lse`` output is
differentiable, its cotangent folding into the backward's ``delta``.

Chunk causality, as in JAX: a kv chunk after the query chunk adds nothing
and runs no kernel; the diagonal chunk runs the causal kernel; an earlier
chunk the non-causal one. So under causal attention rank ``r`` runs ``r+1``
chunk kernels a forward.

The rotation is one ``torch.autograd.Function`` (``_RotateKV``) that moves
k and v together, packed in one buffer, to the next rank through one
``batch_isend_irecv``; its backward sends the packed cotangents the other
way round. The hops form a chain (each moves the output of the one before),
so the backward runs them in reverse order on every rank, and k's and v's
cotangents can never cross: NCCL pairs point-to-point messages by the
order of issue, and two like-shaped tensors sent by two chains could be
paired wrongly with no error. Every rank issues every hop, also where it
skips the chunk, and again in a remat recompute: a chunk skipped at the
last step is tied into the graph by ``_KeepInGraph`` (zero cotangent), so
its hop's backward runs on every rank. JAX rotates ``sp`` times, the last
hop idle; this stops after ``sp - 1``, the same function.

On CPU tensors (gloo) the flash calls run the kernels' plain versions;
on CUDA tensors (NCCL) the kernels, or they raise.
"""

from __future__ import annotations

import torch

from dlrover_tpu_torch.ops.attention import flash_attention_with_lse


def _ring_peers(group):
    """(world, rank, global rank of the next, of the previous) on the
    ring of ``group``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (n, me, dist.get_global_rank(group, (me + 1) % n),
            dist.get_global_rank(group, (me - 1) % n))


def _shift(buf: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``buf`` to global rank ``to`` and receive one like it from
    ``frm`` in one batch; returns the received buffer."""
    import torch.distributed as dist

    buf = buf.contiguous()
    out = torch.empty_like(buf)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, to, group),
        dist.P2POp(dist.irecv, out, frm, group),
    ])
    for w in works:
        w.wait()
    return out


class _RotateKV(torch.autograd.Function):
    """One ring hop of the packed ``(2, b, s, hkv, d)`` k/v buffer:
    forward, this rank's buffer to the next rank and the previous rank's
    here; backward, the cotangent to the previous rank and the next
    rank's here."""

    @staticmethod
    def forward(ctx, kv, group, nxt, prev):
        ctx.group, ctx.nxt, ctx.prev = group, nxt, prev
        return _shift(kv, nxt, prev, group)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.prev, ctx.nxt, ctx.group), None, None, None


class _KeepInGraph(torch.autograd.Function):
    """``out`` itself forward; backward, ``out``'s cotangent and a zero
    one for ``kv``: ties an unused hop's output into the graph so the
    hop's backward runs."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv_shape, ctx.kv_dtype = kv.shape, kv.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return grad, grad.new_zeros(ctx.kv_shape, dtype=ctx.kv_dtype)


def _merge(o_acc, lse_acc, o_i, lse_i):
    """The logsumexp combine of two normalised partial softmaxes in f32:
    ``o`` (b, s, h, d), ``lse`` (b, h, s)."""
    lse = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse).transpose(1, 2)[..., None]
    w_i = torch.exp(lse_i - lse).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_i.float() * w_i, lse


def ring_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group, causal: bool = True):
    """``(out, lse)`` of this rank's chunk of queries over every rank's
    chunk of keys and values in ``group`` (sp order: group rank ``i``
    holds positions ``[i·s, (i+1)·s)``). q ``(b, s, h, d)``, k and v
    ``(b, s, hkv, d)``, each this rank's chunk; ``out`` is f32 ``(b, s,
    h, d)``, ``lse`` f32 ``(b, h, s)``, both differentiable."""
    n, me, nxt, prev = _ring_peers(group)
    kv = torch.stack([k, v])
    o_acc, lse_acc = None, None
    used = True
    for step in range(n):
        if step:
            kv = _RotateKV.apply(kv, group, nxt, prev)
        src = (me - step) % n
        used = not (causal and src > me)  # a later chunk: all keys ahead
        if not used:
            continue
        o_i, lse_i = flash_attention_with_lse(q, kv[0], kv[1],
                                              causal and src == me)
        if o_acc is None:
            # the merge from the empty accumulator (-inf lse) is o_i itself
            o_acc, lse_acc = o_i.float(), lse_i
        else:
            o_acc, lse_acc = _merge(o_acc, lse_acc, o_i, lse_i)
    if not used:
        o_acc = _KeepInGraph.apply(o_acc, kv)
    return o_acc, lse_acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """``ring_attention_with_lse``'s output in q's dtype."""
    return ring_attention_with_lse(q, k, v, group, causal)[0].to(q.dtype)
