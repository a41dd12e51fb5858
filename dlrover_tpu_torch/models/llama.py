"""Llama-3-family decoder (port of dlrover_tpu/models/llama.py, the non-pp,
single-device path).

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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

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
    rms_norm,
    rope_frequencies,
)

Params = Dict[str, Any]


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

    def __post_init__(self):
        if self.remat_policy not in ("all", "mlp"):
            raise ValueError(
                f"remat_policy={self.remat_policy!r}: expected 'all' or 'mlp'"
            )

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


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> Params:
    """Random init on ``generator.device``: normal(0, 0.02) matrices, the
    output projections scaled by 1/sqrt(2 L) (gpt-2 residual scaling), unit
    norms. The same distribution as the JAX package, not the same numbers."""
    pd = cfg.param_dtype
    dev = generator.device
    std = 0.02
    L, D, H, KV, Fd = (cfg.n_layers, cfg.dim, cfg.n_heads * cfg.head_dim,
                       cfg.n_kv_heads * cfg.head_dim, cfg.ffn_dim)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32).mul_(scale)
        return t.to(pd)

    out_scale = std / (2 * cfg.n_layers) ** 0.5
    layers = {
        "attn_norm": torch.ones((L, D), dtype=pd, device=dev),
        "wq": normal((L, D, H), std),
        "wk": normal((L, D, KV), std),
        "wv": normal((L, D, KV), std),
        "wo": normal((L, H, D), out_scale),
        "mlp_norm": torch.ones((L, D), dtype=pd, device=dev),
        "w_gate": normal((L, D, Fd), std),
        "w_up": normal((L, D, Fd), std),
        "w_down": normal((L, Fd, D), out_scale),
    }
    return {
        "embed": normal((cfg.vocab_size, D), std),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=pd, device=dev),
        "lm_head": normal((D, cfg.vocab_size), std),
    }


def param_count(cfg: LlamaConfig) -> int:
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size
    H = cfg.n_heads * cfg.head_dim
    KV = cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * D + D * H + 2 * D * KV + H * D + 3 * D * Fd
    return L * per_layer + 2 * V * D + D


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _decoder_layer(cfg: LlamaConfig, inv_freq, positions, lp, x):
    """One block: pre-norm attention + pre-norm swiglu, residual adds."""
    dt = cfg.dtype
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    y = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (y @ lp["wq"].to(dt)).view(b, s, h, hd)
    k = (y @ lp["wk"].to(dt)).view(b, s, kvh, hd)
    v = (y @ lp["wv"].to(dt)).view(b, s, kvh, hd)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = flash_attention(q, k, v, causal=True).reshape(b, s, h * hd)
    x = x + attn @ lp["wo"].to(dt)

    y = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = F.silu(y @ lp["w_gate"].to(dt))
    up = y @ lp["w_up"].to(dt)
    return x + (gate * up) @ lp["w_down"].to(dt)


def _mlp_policy(cfg: LlamaConfig):
    """Selective-checkpoint policy for ``remat_policy="mlp"``: keep the
    outputs of the two ``(dim, ffn)`` matmuls (gate before its silu, and
    up) and recompute everything else, as the JAX package's
    ``save_only_these_names("ffn_gate", "ffn_up")`` keeps two ffn-sized
    tensors per layer."""
    ffn_weight = (cfg.dim, cfg.ffn_dim)

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.mm.default and tuple(args[1].shape) == ffn_weight:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _maybe_remat(cfg: LlamaConfig, layer_fn):
    """The configured rematerialization of one layer: non-reentrant
    ``torch.utils.checkpoint``, so the backward re-runs the layer forward
    (flash forward kernel included), as ``jax.checkpoint`` does."""
    if not cfg.remat:
        return layer_fn
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "mlp":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _mlp_policy(cfg)
        )

    def remat_layer(lp, x):
        return checkpoint(layer_fn, lp, x, **kwargs)

    return remat_layer


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: LlamaConfig) -> torch.Tensor:
    """Final-norm hidden states (b, s, dim) in compute dtype: everything up
    to, not including, the unembed matmul."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    inv_freq = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                device=tokens.device)
    layer_fn = _maybe_remat(
        cfg, functools.partial(_decoder_layer, cfg, inv_freq, positions)
    )
    # unbind, not leaf[i]: its backward stacks the L layer grads once,
    # where L selects would each zero-fill a whole (L, ...) grad to add up
    per_layer = {name: leaf.unbind(0)
                 for name, leaf in params["layers"].items()}
    for i in range(len(per_layer["wq"])):
        x = layer_fn({name: views[i] for name, views in per_layer.items()}, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def unembed(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """Dense logits (..., vocab) in f32 from compute-dtype operands."""
    if x.dtype == torch.float32:
        return x @ lm_head.float()
    # upcast after rounding the weight to the compute dtype: the exact
    # products of bf16 operands, accumulated in f32 (differentiable)
    return x.float() @ lm_head.to(x.dtype).float()


def forward(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Logits (b, s, vocab) in float32."""
    return unembed(forward_hidden(params, tokens, cfg), params["lm_head"])


def _ce_sums(logits: torch.Tensor, tokens: torch.Tensor):
    """(sum of next-token NLL, count of valid targets); pad tokens < 0
    are ignored. ``logits``/``tokens`` are (mb, s, vocab)/(mb, s)."""
    logits, targets = logits[:, :-1], tokens[:, 1:]
    valid = (targets >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.clamp(min=0).long()[..., None])[..., 0]
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _shift_targets(tokens: torch.Tensor) -> torch.Tensor:
    """targets[i] = tokens[i+1], last position padded invalid (-1)."""
    return F.pad(tokens[..., 1:], (0, 1), value=-1)


def loss_sums(params: Params, tokens: torch.Tensor,
              cfg: LlamaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL, count of valid targets) of ``tokens``;
    pad tokens < 0 are ignored. A data-parallel trainer all-reduces the
    count to form the global token mean."""
    if chunked_ce_enabled():
        # fused lm-head + CE on the shifted targets: never materializes
        # [b, s, vocab] logits
        x = forward_hidden(params, tokens, cfg)
        return cross_entropy_sums(
            x, params["lm_head"], _shift_targets(tokens),
            chunk_size=cfg.ce_chunk_size,
        )
    return _ce_sums(forward(params, tokens, cfg), tokens)


def loss_fn(params: Params, tokens: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (pad tokens < 0 are ignored)."""
    nll_sum, n_valid = loss_sums(params, tokens, cfg)
    return nll_sum / torch.clamp(n_valid, min=1.0)
