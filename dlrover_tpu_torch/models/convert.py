"""Parameters across the two packages, through numpy.

Both packages keep one layout (stacked layer leaves, ``x @ w``
orientation), so conversion is a leaf-by-leaf copy with no transposes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.tree import Tree, map_tree


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree: Tree, device, dtype: Optional[torch.dtype] = None
                    ) -> Tree:
    """The JAX package's params (a nested dict of numpy arrays, e.g. from
    ``jax.device_get``) as the port's tensors on ``device``, cast to
    ``dtype`` when given."""
    return map_tree(
        lambda a: _tensor(a).to(device=torch.device(device), dtype=dtype),
        np_tree,
    )


def params_to_numpy(params: Tree) -> Tree:
    """The port's params as a nested dict of numpy arrays (bf16 leaves
    come back as float32: numpy has no bfloat16 of its own)."""

    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(leaf, params)
