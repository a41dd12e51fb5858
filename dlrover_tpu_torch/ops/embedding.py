"""Token embedding lookup (port of dlrover_tpu/ops/embedding.py).

Without a mesh the lookup is a gather, as the JAX package's is there:
negative ids (the ``-1`` pad sentinel) wrap around as numpy-style indices
do. On a mesh the JAX package contracts a one-hot of the ids with the
table, so an id outside ``[0, vocab)`` matches no row and embeds as
zeros; the port gives the same value by a masked gather over the rows
this rank holds. On a tp mesh the table is this rank's block of vocab
rows (``param_specs``' ``(tp, fsdp)``), the ids outside it embed as zeros
here, and the caller sums the ranks' lookups over tp (each id has one
owner, so the sum is exact in any dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.parallel.mesh import tp_index


def embed_lookup(
    embed: torch.Tensor,   # (vocab, dim), or this tp rank's (vocab/tp, dim)
    tokens: torch.Tensor,  # (b, s) integer ids
    dtype: torch.dtype = torch.bfloat16,
    mesh=None,
) -> torch.Tensor:
    """(b, s, dim) activations in ``dtype``. Gathering before the cast
    gives the same values as casting the table first, without a
    vocab-sized copy of it. ``mesh``: None for the wrapping gather; a
    ``DeviceMesh`` (or, at tp 1, a ``MeshConfig`` or ``{axis: size}``)
    for the one-hot form's value over the rows ``embed`` holds, which
    start at ``tp_index(mesh) * embed.shape[0]`` (module docstring)."""
    if mesh is None:
        tokens = torch.where(tokens < 0, tokens + embed.shape[0], tokens)
        return F.embedding(tokens, embed).to(dtype)
    rows = embed.shape[0]
    local = tokens - tp_index(mesh) * rows
    owned = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(owned, local, 0), embed)
    return torch.where(owned[..., None], x, 0).to(dtype)
