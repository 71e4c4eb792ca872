"""Pytree helpers of the model, train and serve code, over
``torch.utils._pytree``, and ``cost_analysis`` of a captured step.

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


def cost_analysis(compiled) -> dict:
    """The cost dict of one captured step (``roofline.hlo_analysis.
    Captured``; the JAX package takes a compiled object): ``flops``
    (``FlopCounterMode``), ``bytes accessed`` and ``transcendentals``.
    A list of per-device dicts is normalised to the first, as in the
    reference.  One difference is deliberate: XLA counts a while body
    once, while an eager capture counts every run of every op, so a loop
    of 10 matmuls counts 10 here and 1 there."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return ca or {}
