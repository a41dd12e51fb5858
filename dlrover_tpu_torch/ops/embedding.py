"""Token embedding lookup (port of dlrover_tpu/ops/embedding.py).

Only the gather form: the JAX package's one-hot matmul form exists for the
GSPMD partitioner, which the single-device port does not have.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embed_lookup(
    embed: torch.Tensor,   # (vocab, dim)
    tokens: torch.Tensor,  # (b, s) integer ids
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(b, s, dim) activations in ``dtype``. Gathering before the cast
    gives the same values as casting the table first, without a
    vocab-sized copy of it. Negative ids (the ``-1`` pad sentinel) wrap
    around as numpy-style indices do in the JAX package's gather."""
    tokens = torch.where(tokens < 0, tokens + embed.shape[0], tokens)
    return F.embedding(tokens, embed).to(dtype)
