"""Cross-pod gradient compression (hierarchical reduction).

On a multi-pod mesh the inter-pod links are the scarcest bandwidth.  The
standard production trick is hierarchical gradient reduction: full-
precision all-reduce *within* a pod, compressed all-reduce *across* pods.
This module implements the cross-pod stage as an int8 quantized sum with
error feedback (the residual of quantization is carried into the next
step, preserving convergence — 1-bit/low-bit SGD literature).

Wire effect: the cross-pod gradient traffic drops 4x (fp32 -> int8 +
one fp32 scale per tensor).  The JAX package's ``shard_map`` + ``psum``
over the pod axis is ``torch.distributed.all_reduce`` on the mesh's
``pod`` sub-group here, one call each for the int8 payload (summed as
int32), the scale and the pod count; a DTensor gradient is compressed
shard by shard, as ``shard_map`` hands each device its shard.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.compat import tree_flatten, tree_map, tree_unflatten
from repro_torch.models.sharding import P


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # the divisor is a tensor on g's device: a CUDA division by a host
    # scalar multiplies by its reciprocal, which rounds differently
    scale = torch.max(torch.abs(g)) / torch.full((), 127.0,
                                                 device=g.device) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor,
                         group) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantized sum over ``group`` (a process group) with error
    feedback for one gradient leaf; g is this pod's partial gradient (a
    plain tensor: this rank's shard)."""
    g = g.to(torch.float32) + err
    q, scale = quantize_int8(g)
    deq_local = dequantize_int8(q, scale)
    new_err = g - deq_local                      # error feedback residual
    # the wire payload is (q int8, scale fp32); the sum itself must
    # accumulate in >=i32 to avoid overflow across pods
    summed = q.to(torch.int32)
    dist.all_reduce(summed, group=group)
    scale_sum = scale.clone()                    # conservative shared scale
    dist.all_reduce(scale_sum, group=group)
    n = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(n, group=group)
    out = summed.to(torch.float32) * (scale_sum / n) / n
    return out, new_err


def make_cross_pod_sync(mesh, param_specs, pod_axis: str = "pod"):
    """Returns sync(grads, err_state) -> (synced_grads, new_err_state).

    grads are assumed already reduced within the pod; this applies the
    compressed mean across pods.  ``mesh`` is a ``DeviceMesh`` with a
    ``pod_axis`` dim; param_specs: tree of ``P`` for the gradient leaves
    (model-axis sharding); the pod axis must be unsharded in them.  A
    leaf is a plain tensor (this rank's gradient) or a DTensor, whose
    local shard is compressed and which comes back with its placements.
    """
    group = mesh.get_group(pod_axis)
    for spec in tree_flatten(param_specs,
                             is_leaf=lambda s: isinstance(s, P))[0]:
        if any(part == pod_axis or (isinstance(part, tuple)
                                    and pod_axis in part) for part in spec):
            raise ValueError(f"spec {spec} shards the pod axis {pod_axis!r}")

    def one(g, e):
        if isinstance(g, DTensor):
            out, new_e = compressed_psum_leaf(g.to_local(), e.to_local(),
                                              group)
            return (DTensor.from_local(out, g.device_mesh, g.placements),
                    DTensor.from_local(new_e, e.device_mesh, e.placements))
        return compressed_psum_leaf(g, e, group)

    def sync(grads, err_state):
        flat_g, tdef = tree_flatten(grads)
        flat_e, _ = tree_flatten(err_state)
        outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
        return (tree_unflatten(tdef, [o[0] for o in outs]),
                tree_unflatten(tdef, [o[1] for o in outs]))

    return sync


def init_error_state(grads_like):
    """f32 zeros shaped like each gradient leaf (a tensor; a DTensor gives
    a DTensor of its placements)."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads_like)
