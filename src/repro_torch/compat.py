"""Pytree helpers of the model, train and serve code, over
``torch.utils._pytree``.

The names are the JAX package's ``compat`` names and keep its argument
order: ``tree_unflatten(treedef, leaves)`` (torch's own takes the leaves
first).  A path from ``tree_flatten_with_path`` is a tuple of key entries
whose ``.key`` is the dict key, as in JAX.  One difference stays: torch
flattens a dict in insertion order, JAX in sorted key order, so code that
pairs leaves of two trees goes by path, not by position.
"""
from __future__ import annotations

import torch.utils._pytree as _pt

tree_map = _pt.tree_map
tree_leaves = _pt.tree_leaves
tree_flatten = _pt.tree_flatten
tree_structure = _pt.tree_structure
tree_flatten_with_path = _pt.tree_flatten_with_path
tree_map_with_path = _pt.tree_map_with_path


def tree_unflatten(treedef, leaves):
    return _pt.tree_unflatten(list(leaves), treedef)
