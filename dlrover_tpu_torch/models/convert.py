"""Parameters and train states across the two packages, through numpy.

Both packages keep one layout (stacked layer leaves, ``x @ w``
orientation), so conversion is a leaf-by-leaf copy with no transposes. A
train state crosses under the leaf names of the JAX state
(``checkpoint/shm_handler.py::flatten_state``), the names a checkpoint of
either package carries. On a mesh the numpy tree is placed per a spec
tree (a model's ``param_specs``): each rank keeps its region of every
leaf as a DTensor, with no communication; coming back, a DTensor is
gathered whole (a collective: every rank of its mesh calls it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.shm_handler import flatten_state
from dlrover_tpu_torch.common.tree import Tree, flatten, map_tree
from dlrover_tpu_torch.parallel.sharding import place_local


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree: Tree, device, dtype: Optional[torch.dtype] = None,
                    mesh=None, specs: Optional[Tree] = None) -> Tree:
    """The JAX package's params (a nested dict of numpy arrays, e.g. from
    ``jax.device_get``) as the port's tensors on ``device``, cast to
    ``dtype`` when given. With ``mesh`` and ``specs`` (a tree of spec
    tuples, e.g. ``llama.param_specs(cfg)``), each leaf is this rank's
    DTensor shard of it, placed per its spec."""
    def put(a, spec=None):
        t = _tensor(a).to(device=torch.device(device), dtype=dtype)
        return t if mesh is None else place_local(t, mesh, spec)

    if mesh is None:
        return map_tree(put, np_tree)
    return _map_pairs(put, np_tree, specs)


def _map_pairs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    # a copy: a CPU tensor's numpy() is a view the next step would change
    return t.numpy().copy()


def params_to_numpy(params: Tree) -> Tree:
    """The port's params as a nested dict of numpy arrays, a DTensor
    gathered whole (bf16 leaves come back as float32: numpy has no
    bfloat16 of its own)."""
    return map_tree(_numpy, params)


def train_state_from_jax(np_state: dict, device) -> dict:
    """The JAX package's train state (``jax.device_get`` of its
    ``ElasticTrainer`` state: a nested dict of numpy arrays whose ``opt``
    is optax's chain of states) as the port's ``{"params", "opt":
    {"count", "mu", "nu"}, "step", "lr_scale"}`` on ``device``, params
    differentiable as ``ElasticTrainer.init_state`` leaves them."""
    adam = np_state["opt"][1][0]  # optax's ScaleByAdamState(count, mu, nu)
    params = params_from_jax(np_state["params"], device)
    for _, p in flatten(params):
        p.requires_grad_(True)
    return {
        "params": params,
        "opt": {"count": int(adam.count),
                "mu": params_from_jax(adam.mu, device),
                "nu": params_from_jax(adam.nu, device)},
        "step": int(np_state["step"]),
        "lr_scale": float(np_state["lr_scale"]),
    }


def train_state_to_numpy(state: dict) -> Dict[str, np.ndarray]:
    """The port's train state as ``{JAX leaf name: numpy array}`` in the
    JAX state's flatten order: ``jax.tree_util.tree_map_with_path`` over a
    JAX state, keyed by ``keystr``, rebuilds that state. Counts and
    ``step`` are int32, ``lr_scale`` float32, as in the JAX state; bf16
    leaves come back as float32."""
    return {
        leaf.name: (_numpy(leaf.value) if isinstance(leaf.value, torch.Tensor)
                    else np.array(leaf.value))
        for leaf in flatten_state(state)
    }
