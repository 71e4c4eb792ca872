"""The JAX package's stacked parameter leaves over the port's
per-superblock parameters.

The JAX package stacks every block leaf over the ``n_super``
superblocks (``blocks/pos0/attn/wq`` is one ``[n_super, d, H, hd]``
array) and its optimisers act on those stacked leaves: AdamW decays a
leaf of rank >= 2, so it decays the stacked norm scales; Adafactor
factors the stacked ``[n_super, d]`` norm scales, takes column means
across superblocks and clips each update by the RMS of the whole leaf.
The port keeps one parameter per superblock, so its optimisers act on
the same groups through this module.

A *parameter tree* is the JAX package's tree of nested dicts whose leaf
is either a tensor (a leaf the reference keeps as it is) or a list of
tensors, the ``n_super`` slices of one stacked leaf in superblock order
(``models.model.param_tree`` builds one over a model's own parameters).
Grads come in the same layout; optimiser state and checkpoints hold the
stacked tensors, in the reference's layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.compat import tree_flatten_with_path, tree_map

Path = Tuple[str, ...]


def _is_leaf(node) -> bool:
    return isinstance(node, list)


def leaves(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf, in the tree's own order."""
    kv, _ = tree_flatten_with_path(tree, is_leaf=_is_leaf)
    return [(tuple(k.key for k in kp), leaf) for kp, leaf in kv]


def get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def slices(leaf) -> List[torch.Tensor]:
    """The tensors one leaf updates: its slices, or the tensor itself."""
    return list(leaf) if isinstance(leaf, list) else [leaf]


def ref_shape(leaf) -> Tuple[int, ...]:
    """The shape of the reference's leaf (stacked for a list)."""
    if isinstance(leaf, list):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


def device(leaf) -> torch.device:
    return slices(leaf)[0].device


def zeros(leaf) -> torch.Tensor:
    """f32 zeros of the reference leaf's shape on the leaf's device: for a
    leaf of DTensors a DTensor on their mesh, sharded as they are (a
    stacked leaf's tensor dims shifted by its leading superblock dim)."""
    t = slices(leaf)[0]
    if not isinstance(t, DTensor):
        return torch.zeros(ref_shape(leaf), dtype=torch.float32,
                           device=t.device)
    shift = 1 if isinstance(leaf, list) else 0
    return dtensor_zeros(ref_shape(leaf), dtype=torch.float32,
                         device_mesh=t.device_mesh, placements=[
                             Shard(p.dim + shift) if isinstance(p, Shard)
                             else p for p in t.placements])


def map_leaves(fn: Callable, tree):
    """``tree`` with every leaf (tensor or list of slices) replaced by
    ``fn(leaf)``."""
    return tree_map(fn, tree, is_leaf=_is_leaf)


def stack(tree) -> Dict[str, Any]:
    """The reference's tree of tensors: every list of slices stacked (a
    copy, on the slices' device), every tensor as it is; detached."""
    return map_leaves(lambda leaf: torch.stack([t.detach() for t in leaf])
                      if isinstance(leaf, list) else leaf.detach(), tree)


def _as_tensor(v) -> torch.Tensor:
    """``v`` as a tensor: a tensor as it is, anything else through a numpy
    copy; numpy's ``bfloat16`` (ml_dtypes), which torch cannot take, goes
    across as its int16 bits."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def copy_into(tree, values):
    """Copy ``values`` (the reference's layout: stacked tensors or arrays,
    on any device) into the tensors of ``tree``, each cast to its
    tensor's dtype and device.  Every leaf of ``tree`` must be present
    with its reference shape.  Returns ``tree``."""
    for path, leaf in leaves(tree):
        val = _as_tensor(get(values, path))
        if tuple(val.shape) != ref_shape(leaf):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(val.shape)}, "
                             f"want {ref_shape(leaf)}")
        if not isinstance(leaf, list):
            val = val[None]
        for j, t in enumerate(slices(leaf)):
            assign(t, val[j])
    return tree


def like(tree, values):
    """``values`` (the reference's layout) in the layout of ``tree``: new
    tensors of its tensors' dtype, device and placements, such as grads
    for a parameter tree."""
    return copy_into(map_leaves(
        lambda leaf: [torch.empty_like(t) for t in leaf]
        if isinstance(leaf, list) else torch.empty_like(leaf), tree), values)


@torch.no_grad()
def assign(t: torch.Tensor, value: torch.Tensor):
    """``t.copy_(value)`` for a plain tensor ``value`` of ``t``'s shape; a
    DTensor ``t`` takes its own shard of it (no collective: every rank
    holds the same ``value``)."""
    if isinstance(t, DTensor):
        value = distribute_tensor(value.to(t.dtype), t.device_mesh,
                                  t.placements, src_data_rank=None)
    t.copy_(value)
