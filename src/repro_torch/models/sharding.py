"""Partition-spec rules: map parameter paths to partition specs, and specs
to DTensor placements on a ``DeviceMesh``.

Baseline layout (the JAX package's rules, unchanged):
  * megatron-style tensor parallelism on the 'model' axis: attention heads,
    FFN hidden dim, MoE expert dim (or expert-FFN dim when E < axis), SSM
    head channels, vocab dim of embed/head;
  * pure data parallelism over the ('pod', 'data') axes for the batch;
  * a dim is sharded only when divisible by the model-axis size (small KV
    heads / odd vocab sizes are replicated — noted per arch).

A spec is a ``P``: one entry per tensor dim, ``None`` (replicated), a
mesh-dim name, or a tuple of names (one tensor dim sharded over several
mesh dims, major first).  ``placements`` turns it into one DTensor
placement per mesh dim.  Specs are over the JAX package's *stacked*
leaves (``models.stacked``): a block leaf's spec has a leading ``None``
for its ``n_super`` dim, and ``block_spec`` drops it for the port's
per-superblock parameter.

ZeRO-1 optimizer-state sharding is layered on top by ``zero1_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.compat import tree_map, tree_map_with_path
from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A partition spec: ``P(None, "model")`` as the JAX package writes
    its ``PartitionSpec``; a tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: DeviceMesh
    dp_axes: Tuple[str, ...]       # ('data',) or ('pod', 'data')
    model_axis: str = "model"
    # shard head/ffn dims on the model axis even when not divisible (the
    # heads are padded, see ``models.model.LMModel``); baseline False:
    # replicate instead (megatron convention)
    uneven: bool = False

    @property
    def model_size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(
            self.model_axis))

    def named(self, *spec):
        """The DTensor placements of ``spec`` on this context's mesh."""
        return placements(P(*spec), self.mesh)


def placements(spec, mesh: DeviceMesh):
    """One placement per mesh dim: ``Shard(i)`` where tensor dim ``i``'s
    entry names that mesh dim (alone or in a tuple), else ``Replicate()``.
    A tuple entry shards one tensor dim over several mesh dims, the first
    named the major one, as DTensor orders shards by mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, ctx: Optional[ShardCtx], *spec):
    """``x`` redistributed to ``spec`` on the context's mesh; a plain
    tensor, or any tensor without a context, as it is."""
    if ctx is None or not isinstance(x, DTensor):
        return x
    want = ctx.named(*spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def _div(n: int, k: int) -> bool:
    return n % k == 0


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ArchConfig, model_size: int,
               uneven: bool = False) -> P:
    """Partition spec for one parameter leaf.

    ``path`` is the tuple of dict keys; stacked block leaves have a
    leading n_superblock dim which is never sharded.
    """
    name = path[-1]
    m = "model"
    stacked = path[0] == "blocks"

    def wrap(spec_tail: tuple) -> P:
        if stacked:
            return P(None, *spec_tail)
        return P(*spec_tail)

    dims = shape[1:] if stacked else shape

    if name == "embed":
        return P(m, None) if _div(shape[0], model_size) else P(None, None)
    if name == "head":
        return P(None, m) if _div(shape[1], model_size) else P(None, None)
    if name in ("final_norm", "norm1", "norm2", "gate_norm_scale"):
        return wrap((None,) * len(dims))

    # attention.  With `uneven`, head dims shard whenever there are at
    # least model_size heads.
    def head_ok(n):
        return _div(n, model_size) or (uneven and n >= model_size)

    if name == "wq":
        return wrap((None, m if head_ok(dims[1]) else None, None))
    if name in ("wk", "wv"):
        return wrap((None, m if head_ok(dims[1]) else None, None))
    if name == "wo":
        return wrap((m if head_ok(dims[0]) else None, None, None))

    # dense / shared-expert MLP
    if name in ("w1", "w3", "shared_w1", "shared_w3") and len(dims) == 2:
        return wrap((None, m if _div(dims[1], model_size) else None))
    if name in ("w2", "shared_w2") and len(dims) == 2:
        return wrap((m if _div(dims[0], model_size) else None, None))

    # MoE expert-stacked tensors [E, d, f] / [E, f, d]
    if name in ("w1", "w3") and len(dims) == 3:
        if cfg.moe and cfg.moe.shard_mode == "expert" \
                and _div(dims[0], model_size):
            return wrap((m, None, None))
        return wrap((None, None, m if _div(dims[2], model_size) else None))
    if name == "w2" and len(dims) == 3:
        if cfg.moe and cfg.moe.shard_mode == "expert" \
                and _div(dims[0], model_size):
            return wrap((m, None, None))
        return wrap((None, m if _div(dims[1], model_size) else None, None))
    if name == "router":
        return wrap((None, None))

    # SSM
    if name in ("z_proj", "x_proj", "dt_proj"):
        return wrap((None, m if _div(dims[1], model_size) else None))
    if name == "out_proj":
        return wrap((m if _div(dims[0], model_size) else None, None))
    if name in ("B_proj", "C_proj"):
        return wrap((None, None))
    if name in ("conv_x_w",):
        return wrap((None, m if _div(dims[1], model_size) else None))
    if name in ("conv_x_b", "gate_norm", "A_log", "D", "dt_bias"):
        return wrap((m if _div(dims[0], model_size) else None,))
    if name in ("conv_B_w", "conv_C_w"):
        return wrap((None, None))
    if name in ("conv_B_b", "conv_C_b"):
        return wrap((None,))

    # default: replicate
    return wrap((None,) * len(dims))


def block_spec(spec: P) -> P:
    """The spec of one superblock's slice of a stacked block leaf."""
    assert spec[0] is None, spec
    return P(*spec[1:])


def param_specs(cfg: ArchConfig, shapes_tree, ctx: ShardCtx):
    """Tree of ``P`` matching a tree of shapes (tuples, as
    ``LMModel.param_shapes`` gives them)."""
    def fn(path, shape):
        return param_spec(tuple(k.key for k in path), shape, cfg,
                          ctx.model_size, uneven=ctx.uneven)
    return tree_map_with_path(fn, shapes_tree, is_leaf=_is_shape)


def _is_shape(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(n, int) for n in s)


def zero1_spec(spec: P, shape: Tuple[int, ...], dp_axes: Tuple[str, ...],
               dp_size: int) -> P:
    """Extend a param spec by sharding the first free divisible dim over
    the data axes (ZeRO-1 optimizer-state sharding)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, n) in enumerate(zip(parts, shape)):
        if p is None and n % dp_size == 0 and n >= dp_size:
            parts[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            return P(*parts)
    return spec


def cache_spec(kind: str, ctx: ShardCtx, batch: int) -> P:
    """Decode-cache sharding.  KV caches shard batch over dp and the
    sequence (slot) dim over the model axis (flash-decoding layout —
    robust to tiny GQA head counts); SSM states shard heads on model."""
    dp = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    if kind == "kv":          # [B, C, K, hd]
        return P(dp, ctx.model_axis, None, None) if batch > 1 \
            else P(None, ctx.model_axis, None, None)
    if kind == "ssm":         # [B, h, n, p]
        return P(dp, ctx.model_axis, None, None) if batch > 1 \
            else P(None, ctx.model_axis, None, None)
    if kind == "conv":        # [B, cw-1, C]
        return P(dp, None, None) if batch > 1 else P(None, None, None)
    raise ValueError(kind)


def map_specs(fn, specs):
    """``specs`` (a tree of ``P``) with ``fn`` applied to every spec."""
    return tree_map(fn, specs, is_leaf=lambda s: isinstance(s, P))


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_shard(t: DTensor, placements, grad_placements=None):
    """``t`` redistributed to ``placements`` and its local shard, whose
    grad is handed back contiguous: code that works on local shards (and
    whose products leave transposed grads) meets DTensor's backward of
    the ops before it, which views the grad and cannot view a
    non-contiguous one."""
    local = t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad_placements)
    return _ContiguousGrad.apply(local) if local.requires_grad else local


class Reduced(torch.autograd.Function):
    """``t`` placed as ``placements`` (its partial sums all-reduced: each
    partial dim is replicated there); backward passes the grad on as it
    is, whole on every rank, which is each partial's grad (DTensor's own
    redistribute would hand back a partial grad)."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = placements
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def reduce_partial(t: DTensor) -> DTensor:
    """``t`` with its partial sums all-reduced (``Reduced``)."""
    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    if want == tuple(t.placements):
        return t
    return Reduced.apply(t, want)
