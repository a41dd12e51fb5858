"""Rotary position embeddings, llama-3 style (port of dlrover_tpu/ops/rotary.py).

Half-split rotation: the first and second halves of the head dim are the
two coordinates of each rotated pair (not interleaved). ``positions`` is
passed explicitly so a sequence shard can rotate with its global positions.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 500000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponents = torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device
    ) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(
    x: torch.Tensor,          # (..., seq, n_heads, head_dim)
    positions: torch.Tensor,  # (..., seq) integer global positions
    inv_freq: torch.Tensor,   # (head_dim // 2,)
) -> torch.Tensor:
    angles = positions[..., :, None].float() * inv_freq  # (..., s, d/2)
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
