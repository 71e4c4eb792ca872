"""Production mesh construction.

``make_production_mesh`` is a FUNCTION (not a module-level constant) so
importing this module never touches process-group state; a caller
initialises ``torch.distributed`` (one rank per device, or the ``fake``
backend for a mesh of placeholder ranks) before calling it.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.sharding import ShardCtx


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_shard_ctx(mesh: DeviceMesh) -> ShardCtx:
    axes = mesh.mesh_dim_names
    dp_axes: Tuple[str, ...] = tuple(a for a in axes if a != "model")
    return ShardCtx(mesh=mesh, dp_axes=dp_axes, model_axis="model")


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A ``(world, 1)`` ('data', 'model') mesh over every rank of the
    initialised process group (tests/examples)."""
    return init_device_mesh(device_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
