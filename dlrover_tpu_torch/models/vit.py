"""Vision Transformer (port of dlrover_tpu/models/vit.py).

Patchify by unfold + matmul, learned position embeddings, pre-norm encoder
blocks (rms-norm, non-causal attention, gelu MLP), mean-pooled features
and a linear head. The parameter layout is the JAX package's: per-layer
leaves stacked on a leading layer axis, a fused ``wqkv (L, D, 3D)`` split
as ``reshape(b, s, 3, h, hd)``, every projection ``x @ w``; weights cross
between the packages through numpy with no transposes. bfloat16 compute,
float32 master params.

Both kernel families run here: attention is the flash kernels' non-causal
mode, and the loss fuses the head matmul into ``cross_entropy_sums`` (the
fused-CE kernels, or the chunked path under ``DLROVER_TPU_FUSED_CE=0``), or
computes dense f32 logits under ``DLROVER_TPU_CHUNKED_CE=0``.

Differences from the JAX package to keep in mind:

- ``jax.nn.gelu`` defaults to ``approximate=True`` (the tanh form), so the
  port uses ``F.gelu(..., approximate="tanh")``.
- The JAX package's ``_divisor_block`` (vit.py:154-161) is a TPU tiling
  guard: it sends every sequence length without a multiple-of-8 divisor
  (ViT-B/16's 196 patches among them) to ``mha_reference``. The port's
  flash kernels mask ragged edges themselves, so the port calls
  ``flash_attention(causal=False)`` at every length, and
  ``mha_reference`` only under ``attn_impl="reference"``. Both compute the
  same function.
- Remat is the JAX package's ``nothing_saveable``: a full non-reentrant
  ``torch.utils.checkpoint`` of each layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.ops import (
    chunked_ce_enabled,
    cross_entropy_sums,
    flash_attention,
    mha_reference,
    rms_norm,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attn_impl: str = "flash"  # flash | reference

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size * self.patch_size

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError("image_size must be a multiple of patch_size")
        if self.dim % self.n_heads:
            raise ValueError("dim must divide by n_heads")
        if self.attn_impl not in ("flash", "reference"):
            raise ValueError(
                f"attn_impl={self.attn_impl!r}: expected 'flash' or "
                "'reference'"
            )

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(
            image_size=32, patch_size=8, channels=3, n_classes=10,
            dim=64, n_layers=2, n_heads=4, mlp_dim=128,
            dtype=torch.float32, remat=False,
        )
        base.update(kw)
        return ViTConfig(**base)

    @staticmethod
    def base_16() -> "ViTConfig":
        """ViT-B/16 (Dosovitskiy et al. 2020, Table 1)."""
        return ViTConfig()


def init_params(cfg: ViTConfig, generator: torch.Generator) -> Params:
    """Random init on ``generator.device``: matrices normal(0, 1/fan_in),
    position embeddings normal(0, 0.02), unit norms. The same distribution
    as the JAX package, not the same numbers."""
    pd = cfg.param_dtype
    dev = generator.device
    D, L = cfg.dim, cfg.n_layers

    def init(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32).mul_(1.0 / math.sqrt(fan_in))
        return t.to(pd)

    pos = torch.randn((cfg.n_patches, D), generator=generator, device=dev,
                      dtype=torch.float32).mul_(0.02)
    return {
        "patch_embed": init((cfg.patch_dim, D), cfg.patch_dim),
        "pos_embed": pos.to(pd),
        "layers": {
            "attn_norm": torch.ones((L, D), dtype=pd, device=dev),
            "wqkv": init((L, D, 3 * D), D),
            "wo": init((L, D, D), D),
            "mlp_norm": torch.ones((L, D), dtype=pd, device=dev),
            "w_up": init((L, D, cfg.mlp_dim), D),
            "w_down": init((L, cfg.mlp_dim, D), cfg.mlp_dim),
        },
        "final_norm": torch.ones((D,), dtype=pd, device=dev),
        "head": init((D, cfg.n_classes), D),
    }


def param_count(cfg: ViTConfig) -> int:
    D, L, M = cfg.dim, cfg.n_layers, cfg.mlp_dim
    per_layer = 2 * D + 3 * D * D + D * D + 2 * D * M
    return (cfg.patch_dim * D + cfg.n_patches * D + L * per_layer + D
            + D * cfg.n_classes)


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) -> (b, n_patches, patch_dim): each patch row is the
    raster-order pixels of one patch, channels last."""
    b, hgt, wid, c = images.shape
    p = cfg.patch_size
    gh, gw = hgt // p, wid // p
    x = images.reshape(b, gh, p, gw, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # b, gh, gw, p, p, c
    return x.reshape(b, gh * gw, p * p * c)


def _encoder_layer(cfg: ViTConfig, lp, x):
    dt = cfg.dtype
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    y = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    qkv = (y @ lp["wqkv"].to(dt)).reshape(b, s, 3, h, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.attn_impl == "reference":
        attn = mha_reference(q, k, v, causal=False)
    else:
        attn = flash_attention(q, k, v, causal=False)
    x = x + attn.reshape(b, s, d) @ lp["wo"].to(dt)

    y = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    up = F.gelu(y @ lp["w_up"].to(dt), approximate="tanh")
    return x + up @ lp["w_down"].to(dt)


def forward_pooled(params: Params, images: torch.Tensor,
                   cfg: ViTConfig) -> torch.Tensor:
    """(b, H, W, C) float images -> (b, dim) mean-pooled features in the
    compute dtype: everything up to, not including, the head matmul."""
    dt = cfg.dtype
    x = patchify(cfg, images.to(dt)) @ params["patch_embed"].to(dt)
    x = x + params["pos_embed"].to(dt)[None]

    def layer_fn(lp, x):
        return _encoder_layer(cfg, lp, x)

    if cfg.remat:
        def layer(lp, x):
            return checkpoint(layer_fn, lp, x, use_reentrant=False)
    else:
        layer = layer_fn
    # unbind, not leaf[i]: its backward stacks the L layer grads once
    per_layer = {name: leaf.unbind(0)
                 for name, leaf in params["layers"].items()}
    for i in range(cfg.n_layers):
        x = layer({name: views[i] for name, views in per_layer.items()}, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.mean(dim=1)


def forward(params: Params, images: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """(b, H, W, C) float images -> (b, n_classes) logits in float32."""
    pooled = forward_pooled(params, images, cfg)
    return (pooled @ params["head"].to(cfg.dtype)).float()


def loss_fn(params: Params, batch, cfg: ViTConfig) -> torch.Tensor:
    """Softmax cross-entropy of ``batch = (images, int labels)``; labels
    < 0 are the pad sentinel and contribute nothing."""
    images, labels = batch
    if chunked_ce_enabled():
        pooled = forward_pooled(params, images, cfg)
        nll_sum, n_valid = cross_entropy_sums(pooled, params["head"], labels)
        return nll_sum / torch.clamp(n_valid, min=1.0)
    logits = forward(params, images, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
