"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted key order, as ``jax.tree.leaves`` visits a
dict, so a leaf's position means the same thing in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Tree = Dict[str, Any]


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` with ``/``-joined paths, in sorted key order."""
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        path = f"{prefix}{key}"
        value = tree[key]
        if isinstance(value, dict):
            out.extend(flatten(value, path + "/"))
        else:
            out.append((path, value))
    return out


def map_tree(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """A tree of the same shape with ``fn`` applied to every leaf."""
    return {
        k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
        for k, v in tree.items()
    }
