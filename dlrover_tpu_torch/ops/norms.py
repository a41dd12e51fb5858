"""Normalization ops (port of dlrover_tpu/ops/norms.py).

Computed in float32 whatever the input dtype, then cast back.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
