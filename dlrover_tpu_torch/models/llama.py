"""Llama-3-family decoder (port of dlrover_tpu/models/llama.py, the non-pp
path: one device, and dp, fsdp, sp and tp on a ``DeviceMesh``).

The parameter layout is the JAX package's, so weights cross between the two
through numpy with no transposes: per-layer leaves are stacked on a leading
layer axis (``params["layers"]["wq"]`` is ``(L, dim, n_heads*head_dim)``)
and every projection is ``x @ w``. The layer scan is a Python loop over the
stacked leaves. bfloat16 compute, float32 master params; attention runs the
flash kernels (``ops/attention.py``). The loss fuses the unembed matmul
into the cross-entropy through ``cross_entropy_sums``, as the JAX loss
does: the fused-CE kernels (``ops/fused_ce.py``) by default, the chunked
cross-entropy under ``DLROVER_TPU_FUSED_CE=0``; under
``DLROVER_TPU_CHUNKED_CE=0`` it computes dense f32 logits instead.

Sharded params. On a mesh with fsdp or tp above 1 every param is a
DTensor placed per ``param_specs`` (``init_params`` and
``models/convert.py::params_from_jax`` place them; each rank holds
``1/(fsdp·tp)`` of every matrix, the norms whole).

Fully sharded params (ZeRO-3, fsdp above 1): the forward gathers what it
needs over fsdp as the JAX package's weight-gathered path does: the
embedding before its lookup, each layer's matrices inside the remat
boundary (so the recomputed forward gathers again rather than keep a
whole layer), the lm-head before the fused CE. A gather is an all-gather
over the mesh's fsdp group; its backward reduce-scatters the gradient in
f32, so a shard's gradient is the sum over the fsdp ranks that the
replicated dp step would all-reduce. The layer matrices are gathered as
their compute-dtype casts (half the bytes; the cast is element-wise, so
the forward is the same), the embedding and the lm-head in f32, whose
gradients the lookup and the fused CE form in the weight's dtype.

Tensor parallelism (tp above 1) is Megatron's recipe written out, as the
JAX package writes it for its pipeline stages (its non-pp path leaves tp
to the GSPMD partitioner, which the port does not have): a tp rank holds
the contiguous heads ``[r·h/tp, (r+1)·h/tp)`` and kv heads ``[r·hkv/tp,
…)`` of the column-parallel ``wq``/``wk``/``wv``, the same ffn columns of
``w_gate``/``w_up``, and those rows of the row-parallel ``wo``/``w_down``.
The residual stream is replicated over tp. Each layer's pre-norm output
enters ``_tp_region_in`` (Megatron's ``f``: identity forward, all-reduce
backward) and each row-parallel product leaves through ``_tp_region_out``
(``g``: all-reduce forward, identity backward), so a replicated tensor's
gradient is the total on every tp rank and a tp-replicated leaf (the
norms) needs no tp reduction. The flash kernels run unchanged on the
local heads: the GQA group ``h/hkv`` is the same locally, so a local
query head's kv head is the same one as in the whole layer. The
embedding is split by vocab rows: a rank looks up the ids it owns
(``ops/embedding.py``) and ``_tp_region_out`` sums the ranks' lookups.
The lm-head stays in the JAX package's weight-gathered limit (no
vocab-parallel CE yet): it is gathered whole over tp and fsdp, and every
tp rank runs the fused CE on it; the tp gather's backward takes the
rank's own columns of the gradient without a sum, since each rank's is
already the total. Under fsdp × tp a layer's ``(d/fsdp, h/tp)`` shard is
gathered over fsdp only, to ``(d, h/tp)``.

Sequence parallelism (sp above 1): the ranks of an sp group train the
same rows, each its own contiguous chunk of ``s/sp`` positions, rank ``i``
chunk ``i``, and runs the whole layer on it; the JAX package's GSPMD
shards the activations' sequence dim over sp the same way. Every entry
point takes the whole rows on every sp rank and returns this rank's chunk
(``forward_hidden``, ``forward``) or its chunk's sums (``loss_sums``).
Two things differ on a chunk: RoPE rotates by the global positions
``sp_index · s/sp + arange(s/sp)``, and the next-token shift runs on the
whole row before the split (``_shift_targets``), so a chunk's last target
is the next chunk's first token and only the last chunk's last position
is ``-1``, as the JAX pp stages shift. The attention is the only part
that crosses chunks: ``attn_impl`` picks ring attention (``"auto"`` or
``"ring"``, ``ops/ring_attention.py``) or ulysses (``"ulysses"``,
``ops/ulysses.py``) over the mesh's sp group, on this rank's heads, so tp
× sp composes. ``"flash"`` and ``"reference"`` on an sp mesh raise: the
port has no partitioner to run a whole-sequence attention on a chunk.
The trainer sums the losses' sums and the gradients over sp beside the
batch axes (train/trainer.py).

Every rank issues the same collectives in the same order, in the remat
recompute too. ep and pp are later slices: a mesh with one of them above
1 raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dlrover_tpu_torch.ops import (
    apply_rope,
    chunked_ce_enabled,
    cross_entropy_sums,
    embed_lookup,
    flash_attention,
    mha_reference,
    ring_attention,
    rms_norm,
    rope_frequencies,
    ulysses_attention,
)
from dlrover_tpu_torch.parallel.mesh import (
    DP,
    EP,
    FSDP,
    PP,
    SP,
    TP,
    MeshConfig,
    axis_sizes,
    check_ported_axes,
    sp_group,
    sp_index,
    sp_size,
    tp_group,
    tp_index,
    tp_size,
    validate_divisibility,
)
from dlrover_tpu_torch.parallel.sharding import local_of, place_local

Params = Dict[str, Any]

#: ``LlamaConfig.attn_impl``'s values, the JAX package's
ATTN_IMPLS = ("auto", "flash", "reference", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master params
    remat: bool = True
    # "all": recompute the whole layer in the backward (least memory);
    # "mlp": keep the two d x ffn matmul outputs (gate and up) and
    # recompute the rest
    remat_policy: str = "all"
    # vocab columns per step of the chunked cross-entropy
    ce_chunk_size: int = 2048
    # "auto": ring on an sp mesh, else flash; "flash", "ring", "ulysses";
    # "reference": the plain attention, on CPU tensors only (_attention)
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.remat_policy not in ("all", "mlp"):
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: expected 'all' or 'mlp'"
            )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected one of {ATTN_IMPLS}")

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets -------------------------------------------------------
    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        return LlamaConfig(
            dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672
        )

    @staticmethod
    def gpt2_xl_class() -> "LlamaConfig":
        """~1.5B-param config matching the reference's flash-checkpoint
        benchmark subject (GPT-2 xl); head dim 64."""
        return LlamaConfig(
            vocab_size=50304, dim=1600, n_layers=48, n_heads=25,
            n_kv_heads=25, ffn_dim=3712, max_seq_len=1024, rope_theta=10000.0
        )

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=128, dtype=torch.float32, remat=False,
        )
        base.update(kw)
        return LlamaConfig(**base)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                mesh=None) -> Params:
    """Random init on ``generator.device``: normal(0, 0.02) matrices, the
    output projections scaled by 1/sqrt(2 L) (gpt-2 residual scaling), unit
    norms. The same distribution as the JAX package, not the same numbers.

    On a mesh with fsdp or tp above 1 the params are born sharded: each
    leaf is drawn whole, in the same order from the same generator, and
    cut at once into this rank's DTensor shard per ``param_specs``, so a
    shard equals the same slice of the one-process init and no more than
    one whole leaf is ever resident beside the shards."""
    pd = cfg.param_dtype
    dev = generator.device
    std = 0.02
    L, D, H, KV, Fd = (cfg.n_layers, cfg.dim, cfg.n_heads * cfg.head_dim,
                       cfg.n_kv_heads * cfg.head_dim, cfg.ffn_dim)
    sharded = sharded_mesh(mesh)
    specs = param_specs(cfg)

    def put(t, spec):
        return t if sharded is None else place_local(t, sharded, spec)

    def normal(shape, scale, spec):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32).mul_(scale)
        return put(t.to(pd), spec)

    def ones(shape, spec):
        return put(torch.ones(shape, dtype=pd, device=dev), spec)

    out_scale = std / (2 * cfg.n_layers) ** 0.5
    ls = specs["layers"]
    layers = {
        "attn_norm": ones((L, D), ls["attn_norm"]),
        "wq": normal((L, D, H), std, ls["wq"]),
        "wk": normal((L, D, KV), std, ls["wk"]),
        "wv": normal((L, D, KV), std, ls["wv"]),
        "wo": normal((L, H, D), out_scale, ls["wo"]),
        "mlp_norm": ones((L, D), ls["mlp_norm"]),
        "w_gate": normal((L, D, Fd), std, ls["w_gate"]),
        "w_up": normal((L, D, Fd), std, ls["w_up"]),
        "w_down": normal((L, Fd, D), out_scale, ls["w_down"]),
    }
    return {
        "embed": normal((cfg.vocab_size, D), std, specs["embed"]),
        "layers": layers,
        "final_norm": ones((D,), specs["final_norm"]),
        "lm_head": normal((D, cfg.vocab_size), std, specs["lm_head"]),
    }


def param_count(cfg: LlamaConfig) -> int:
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    H = cfg.n_heads * cfg.head_dim
    KV = cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * D + D * H + 2 * D * KV + H * D + 3 * D * Fd
    return L * per_layer + 2 * V * D + D


# ---------------------------------------------------------------------------
# Sharding: the specs, the mesh check, the ZeRO-3 gather, the tp regions
# ---------------------------------------------------------------------------


def param_specs(cfg: LlamaConfig, pp: int = 1) -> Params:
    """Spec tree mirroring ``init_params``: the JAX ``param_specs`` as
    ``tuple(P(...))`` of each leaf. The leading axis of every layer leaf
    is the layer axis, unsharded (split over pp under pipeline
    parallelism, a later slice); the column-parallel matrices are
    ``(d, h) = (fsdp, tp)``, the row-parallel ``wo``/``w_down`` ``(h, d)
    = (tp, fsdp)``, the norms replicated."""
    layer_axis = PP if pp > 1 else None
    return {
        "embed": (TP, FSDP),
        "layers": {
            "attn_norm": (layer_axis, None),
            "wq": (layer_axis, FSDP, TP),
            "wk": (layer_axis, FSDP, TP),
            "wv": (layer_axis, FSDP, TP),
            "wo": (layer_axis, TP, FSDP),
            "mlp_norm": (layer_axis, None),
            "w_gate": (layer_axis, FSDP, TP),
            "w_up": (layer_axis, FSDP, TP),
            "w_down": (layer_axis, TP, FSDP),
        },
        "final_norm": (None,),
        "lm_head": (FSDP, TP),
    }


def validate_for_mesh(cfg: LlamaConfig, mesh, seq_len: int = 0) -> None:
    """Fail fast on model-shape / mesh-axis mismatches (the JAX checks of
    the non-pp path: ``validate_divisibility``). ``mesh``: a
    ``DeviceMesh``, a ``MeshConfig`` or ``{axis: size}``. A mesh with pp
    above 1 raises: the pipeline schedules, and the JAX checks that go
    with them, are not ported yet (``parallel/pp_schedule.py``)."""
    shape = axis_sizes(mesh)
    mc = MeshConfig(
        dp=shape.get(DP, 1), pp=shape.get(PP, 1),
        fsdp=shape.get(FSDP, 1), ep=shape.get(EP, 1),
        sp=shape.get(SP, 1), tp=shape.get(TP, 1),
    )
    validate_divisibility(
        mc,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        seq_len=seq_len or cfg.max_seq_len,
        vocab=cfg.vocab_size,
        n_layers=cfg.n_layers,
    )
    if mc.pp > 1:
        raise ValueError(
            f"pp={mc.pp}: the pipeline schedules are not ported yet "
            "(parallel/pp_schedule.py)")


def sharded_mesh(mesh):
    """``mesh`` when one of its param-splitting axes, fsdp or tp, is above
    1 (the params are DTensors placed per ``param_specs``), else None
    (plain tensors, whole)."""
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    if sizes.get(FSDP, 1) <= 1 and sizes.get(TP, 1) <= 1:
        return None
    return mesh


def _fsdp_size(mesh) -> int:
    return 1 if mesh is None else axis_sizes(mesh).get(FSDP, 1)


#: fsdp (ZeRO-3) all-gather dim per layer leaf, after the leading layer
#: axis is unbound: column-parallel wq/wk/wv/w_gate/w_up are (d, h) =
#: (fsdp, tp) -> gather dim 0; row-parallel wo/w_down are (h, d) = (tp,
#: fsdp) -> gather dim 1. Norm leaves are fsdp-replicated.
_PP_FSDP_DIM = {
    "wq": 0, "wk": 0, "wv": 0, "w_gate": 0, "w_up": 0,
    "wo": 1, "w_down": 1,
}


class FsdpGather(torch.autograd.Function):
    """A whole fsdp-sharded leaf from every rank's shard: forward, the
    shard cast to ``dtype`` and all-gathered over ``group`` along
    ``dim`` (through a leading-dim copy when ``dim`` is not 0); backward,
    the gradient cast to the shard's dtype and reduce-scattered, so this
    rank gets the ranks' summed gradient of its own shard."""

    @staticmethod
    def forward(ctx, shard, group, dim, dtype):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.dtype = group, dim, shard.dtype
        world = dist.get_world_size(group)
        src = shard.to(dtype).movedim(dim, 0).contiguous()
        out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        world = dist.get_world_size(ctx.group)
        src = grad.to(ctx.dtype).movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // world,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


def fsdp_gather(shard: torch.Tensor, mesh, dim: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``FsdpGather`` of ``shard`` over ``mesh``'s fsdp group (its dtype
    kept when ``dtype`` is None)."""
    return FsdpGather.apply(shard, mesh.get_group(FSDP), dim,
                            dtype or shard.dtype)


class TpGather(torch.autograd.Function):
    """A tp-split leaf gathered whole along ``dim`` over ``group``:
    forward, an all-gather (through a leading-dim copy when ``dim`` is not
    0); backward, this rank's own block of the gradient (the ``index``-th
    of the group's), with no sum: every tp rank computes the same function
    of the whole leaf on the same replicated inputs, so each rank's
    gradient of it is already the total (a reduce-scatter would multiply
    it by tp, which the JAX package's marker path undoes with
    ``_grad_downscale``)."""

    @staticmethod
    def forward(ctx, shard, group, dim, index):
        import torch.distributed as dist

        ctx.dim, ctx.index, ctx.size = dim, index, shard.shape[dim]
        world = dist.get_world_size(group)
        src = shard.movedim(dim, 0).contiguous()
        out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        own = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return own.contiguous(), None, None, None


class _TpRegionIn(torch.autograd.Function):
    """Megatron ``f``: identity forward, all-reduce over ``group``
    backward (the branch partials of a replicated tensor summed back to
    its total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _TpRegionOut(torch.autograd.Function):
    """Megatron ``g``: all-reduce over ``group`` forward (the row-parallel
    partial sums; ``loss_fn``'s chunk sums over sp), identity backward
    (the replicated total's gradient handed to each rank's partial)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _tp_region_in(x: torch.Tensor, mesh) -> torch.Tensor:
    """``f`` over ``mesh``'s tp group (``_TpRegionIn``); ``x`` itself at
    tp 1."""
    if tp_size(mesh) <= 1:
        return x
    return _TpRegionIn.apply(x, tp_group(mesh))


def _tp_region_out(x: torch.Tensor, mesh) -> torch.Tensor:
    """``g`` over ``mesh``'s tp group (``_TpRegionOut``); ``x`` itself at
    tp 1."""
    if tp_size(mesh) <= 1:
        return x
    return _TpRegionOut.apply(x, tp_group(mesh))


def _gather_layer_params(lp, mesh, dtype=None):
    """ZeRO-3 gather of one layer's fsdp-sharded matrices over fsdp only,
    each in ``dtype`` (a tp shard ``(d/fsdp, h/tp)`` becomes ``(d,
    h/tp)``), the norms as they are. Called inside the remat boundary so
    the backward gathers again instead of saving the whole matrices; each
    gather's backward reduce-scatters its gradient into the shard."""
    if _fsdp_size(mesh) <= 1:
        return lp
    return {k: (fsdp_gather(a, mesh, _PP_FSDP_DIM[k], dtype)
                if k in _PP_FSDP_DIM else a)
            for k, a in lp.items()}


def _gather_lm_head(lm_head, mesh):
    """The whole (d, vocab) lm-head, f32, from its (fsdp, tp) shard, for
    the fused CE (the weight-gathered limit: no vocab-parallel CE yet):
    gathered over tp along dim 1 (``TpGather``: no tp sum in the
    backward), then over fsdp along dim 0 (``FsdpGather``)."""
    if tp_size(mesh) > 1:
        lm_head = TpGather.apply(lm_head, tp_group(mesh), 1, tp_index(mesh))
    if _fsdp_size(mesh) > 1:
        lm_head = fsdp_gather(lm_head, mesh, 0)
    return lm_head


def _mesh_of(params: Params, mesh):
    """The mesh the forward runs on: ``mesh``, else the params' own when
    they are DTensors. Params on an fsdp or tp mesh must be DTensors."""
    if mesh is None:
        mesh = getattr(params["embed"], "device_mesh", None)
    if sharded_mesh(mesh) is not None and not hasattr(params["embed"],
                                                      "to_local"):
        raise ValueError(
            "an fsdp or tp mesh needs params placed per param_specs "
            "(DTensors: init_params or params_from_jax with the mesh)")
    return mesh


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _attention(cfg: LlamaConfig, mesh, q, k, v) -> torch.Tensor:
    """Causal attention of this rank's heads (and, on an sp mesh, its
    chunk of the sequence) by ``cfg.attn_impl``, the JAX ``_attention``:
    ring or ulysses over the sp group, else the flash kernels on the whole
    sequence; ``"reference"`` runs the plain attention on a CPU tensor and
    raises on a CUDA one, where nothing stands in for the kernels."""
    impl = cfg.attn_impl
    sp = sp_size(mesh)
    if impl == "auto":
        impl = "ring" if sp > 1 else "flash"
    if sp > 1:
        if impl not in ("ring", "ulysses"):
            raise ValueError(
                f"attn_impl={impl!r} on a mesh with sp={sp}: each rank holds "
                "a chunk of the sequence, so only 'ring', 'ulysses' or "
                "'auto' attend across chunks")
        attend = ring_attention if impl == "ring" else ulysses_attention
        return attend(q, k, v, sp_group(mesh), causal=True)
    if impl == "reference":
        if q.is_cuda:
            raise ValueError(
                "attn_impl='reference' runs the plain attention on CPU "
                "tensors only; on the card the flash kernels run")
        return mha_reference(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=True)


def _decoder_layer(cfg: LlamaConfig, inv_freq, positions, lp, x, mesh=None):
    """One block: pre-norm attention + pre-norm swiglu, residual adds. At
    tp above 1 on ``mesh``, the JAX ``tp_size`` form: this rank's
    ``h/tp`` heads and ``hkv/tp`` kv heads between the f/g regions
    (module docstring); at sp above 1, ``x`` is this rank's chunk of the
    sequence and ``positions`` its global positions."""
    dt = cfg.dtype
    b, s, _ = x.shape
    tp = tp_size(mesh)
    h, kvh, hd = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim

    y = _tp_region_in(rms_norm(x, lp["attn_norm"], cfg.norm_eps), mesh)
    q = (y @ lp["wq"].to(dt)).view(b, s, h, hd)
    k = (y @ lp["wk"].to(dt)).view(b, s, kvh, hd)
    v = (y @ lp["wv"].to(dt)).view(b, s, kvh, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = _attention(cfg, mesh, q, k, v).reshape(b, s, h * hd)
    x = x + _tp_region_out(attn @ lp["wo"].to(dt), mesh)

    y = _tp_region_in(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), mesh)
    gate = F.silu(y @ lp["w_gate"].to(dt))
    up = y @ lp["w_up"].to(dt)
    return x + _tp_region_out((gate * up) @ lp["w_down"].to(dt), mesh)


def _mlp_policy(cfg: LlamaConfig, tp: int = 1):
    """Selective-checkpoint policy of one layer call for
    ``remat_policy="mlp"``: keep the outputs of the two matmuls against
    this rank's ``(dim, ffn_dim/tp)`` weights (gate before its silu, and
    up) and recompute everything else, as the JAX package's
    ``save_only_these_names("ffn_gate", "ffn_up")`` keeps two ffn-sized
    tensors per layer. It keys on the local weight's shape and keeps the
    first two such products of the forward and of the recompute: the
    row-parallel ``w_down`` comes third, so its product is recomputed
    even where ``dim`` equals ``ffn_dim/tp``."""
    ffn_weight = (cfg.dim, cfg.ffn_dim // tp)
    kept = {False: 0, True: 0}

    def policy(ctx, op, *args, **kwargs):
        if (op is torch.ops.aten.mm.default
                and tuple(args[1].shape) == ffn_weight
                and kept[ctx.is_recompute] < 2):
            kept[ctx.is_recompute] += 1
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _maybe_remat(cfg: LlamaConfig, layer_fn, tp: int = 1):
    """The configured rematerialization of one layer: non-reentrant
    ``torch.utils.checkpoint``, so the backward re-runs the layer forward
    (flash forward kernel and the layer's collectives included), as
    ``jax.checkpoint`` does."""
    if not cfg.remat:
        return layer_fn
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "mlp":
        # a policy a call: its count of kept products starts anew
        kwargs["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _mlp_policy(cfg, tp))

    def remat_layer(lp, x):
        return checkpoint(layer_fn, lp, x, **kwargs)

    return remat_layer


def sp_chunk(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous chunk of ``t``'s sequence dim (dim 1) on an
    sp mesh: positions ``[i·s/sp, (i+1)·s/sp)`` at sp index ``i``; ``t``
    itself at sp 1."""
    sp = sp_size(mesh)
    if sp <= 1:
        return t
    n = t.shape[1] // sp
    return t.narrow(1, sp_index(mesh) * n, n)


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Final-norm hidden states (b, s, dim) in compute dtype: everything up
    to, not including, the unembed matmul. ``mesh``: the ``DeviceMesh``
    the params live on (their own when they are DTensors and it is None);
    with fsdp or tp above 1 the weights are gathered and the heads split
    as the module docstring says. With sp above 1 ``tokens`` are the whole
    rows and the result is this rank's chunk, ``(b, s/sp, dim)``. On any
    mesh an id outside the vocabulary embeds as zeros, as the JAX
    package's one-hot lookup does there; without one it wraps
    (``ops/embedding.py``)."""
    b, s = tokens.shape
    mesh = _mesh_of(params, mesh)
    if mesh is not None:
        validate_for_mesh(cfg, mesh, seq_len=s)
        check_ported_axes(mesh)
    tokens = sp_chunk(tokens, mesh)
    n = tokens.shape[1]
    embed = local_of(params["embed"])
    if _fsdp_size(mesh) > 1:
        embed = fsdp_gather(embed, mesh, 1)
    x = _tp_region_out(embed_lookup(embed, tokens, cfg.dtype, mesh), mesh)
    # global positions: this chunk's offset in the row
    positions = (sp_index(mesh) * n
                 + torch.arange(n, device=tokens.device)).expand(b, n)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                device=tokens.device)
    layer = functools.partial(_decoder_layer, cfg, inv_freq, positions,
                              mesh=mesh)
    if _fsdp_size(mesh) > 1:
        def layer(lp, x, _layer=layer):
            return _layer(_gather_layer_params(lp, mesh, cfg.dtype), x)
    layer_fn = _maybe_remat(cfg, layer, tp_size(mesh))
    # unbind, not leaf[i]: its backward stacks the L layer grads once,
    # where L selects would each zero-fill a whole (L, ...) grad to add up;
    # on a sharded mesh the local (L, ...) shard is unbound
    per_layer = {name: local_of(leaf).unbind(0)
                 for name, leaf in params["layers"].items()}
    for i in range(len(per_layer["wq"])):
        x = layer_fn({name: views[i] for name, views in per_layer.items()}, x)
    return rms_norm(x, local_of(params["final_norm"]), cfg.norm_eps)


def unembed(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """Dense logits (..., vocab) in f32 from compute-dtype operands."""
    if x.dtype == torch.float32:
        return x @ lm_head.float()
    # upcast after rounding the weight to the compute dtype: the exact
    # products of bf16 operands, accumulated in f32 (differentiable)
    return x.float() @ lm_head.to(x.dtype).float()


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig, mesh=None) -> torch.Tensor:
    """Logits (b, s, vocab) in float32; on an sp mesh this rank's chunk,
    ``(b, s/sp, vocab)``, of the whole rows ``tokens``."""
    mesh = _mesh_of(params, mesh)
    x = forward_hidden(params, tokens, cfg, mesh)
    return unembed(x, _gather_lm_head(local_of(params["lm_head"]), mesh))


def _ce_sums(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of NLL, count of valid targets) against pre-shifted targets
    (``_shift_targets``; targets < 0 are ignored), the JAX
    ``_ce_sums_shifted``. ``logits``/``targets`` are (mb, s, vocab)/(mb,
    s)."""
    valid = (targets >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _shift_targets(tokens: torch.Tensor) -> torch.Tensor:
    """targets[i] = tokens[i+1], last position padded invalid (-1)."""
    return F.pad(tokens[..., 1:], (0, 1), value=-1)


def loss_sums(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL, count of valid targets) of ``tokens``;
    pad tokens < 0 are ignored. A data-parallel trainer all-reduces the
    count to form the global token mean. On an sp mesh ``tokens`` are the
    whole rows: they are shifted whole, and the sums are this rank's
    chunk's (the trainer sums them over sp)."""
    mesh = _mesh_of(params, mesh)
    targets = sp_chunk(_shift_targets(tokens), mesh)
    if chunked_ce_enabled():
        # fused lm-head + CE on the shifted targets: never materializes
        # [b, s, vocab] logits
        x = forward_hidden(params, tokens, cfg, mesh)
        return cross_entropy_sums(
            x, _gather_lm_head(local_of(params["lm_head"]), mesh),
            targets, chunk_size=cfg.ce_chunk_size,
        )
    return _ce_sums(forward(params, tokens, cfg, mesh), targets)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy (pad tokens < 0 are ignored). On an
    sp mesh the mean of the whole rows on every sp rank: the chunks' sums
    are added over the sp group by Megatron's ``g`` (all-reduce forward,
    identity backward), so a rank's gradient is its chunk's share, which
    the trainer's sp sum completes."""
    mesh = _mesh_of(params, mesh)
    nll_sum, n_valid = loss_sums(params, tokens, cfg, mesh)
    if sp_size(mesh) > 1:
        nll_sum = _TpRegionOut.apply(nll_sum, sp_group(mesh))
        n_valid = _TpRegionOut.apply(n_valid.detach(), sp_group(mesh))
    return nll_sum / torch.clamp(n_valid, min=1.0)
