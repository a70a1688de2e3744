"""Production mesh construction over ``torch.distributed``.

The reference's ``launch/mesh.py``, building ``DeviceMesh``es (importing
this module touches no process group):

* single-pod: ``(16, 16)`` over ``("data", "model")`` — 256 devices,
* multi-pod:  ``(2, 16, 16)`` over ``("pod", "data", "model")`` — 512 devices.

Axis roles: ``("pod","data")`` = DP; ``"data"`` also carries FSDP parameter
sharding and long-context sequence parallelism; ``"model"`` = TP/EP.
``make_tiny_mesh`` builds the same role structure at toy sizes.  The shape
and axis-name vocabulary lives in :mod:`.mesh_shapes`.

A ``DeviceMesh`` spans the ranks of the default process group, so each
function needs ``torch.distributed.init_process_group`` called first with a
world size equal to the mesh's size: NCCL on the card, gloo on the CPU, or
the ``fake`` backend to build a production-size mesh in one process (as the
reference builds its meshes from ``jax.devices()``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .mesh_shapes import production_shape, tiny_shape

__all__ = ["make_production_mesh", "make_tiny_mesh", "mesh_axis_sizes", "dp_axes"]


def _mk(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str) -> DeviceMesh:
    size = math.prod(shape)
    need = (f"a {shape} mesh over {axes} needs torch.distributed.init_process_group(...) with world_size={size} "
            "first")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{need}: no process group is initialised")
    if dist.get_world_size() != size:
        raise RuntimeError(f"{need}: the process group has world_size={dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    return _mk(*production_shape(multi_pod=multi_pod), device_type)


def make_tiny_mesh(*, multi_pod: bool = False, data: int = 2, model: int = 2, device_type: str = "cuda") -> DeviceMesh:
    return _mk(*tiny_shape(multi_pod=multi_pod, data=data, model=model), device_type)


def mesh_axis_sizes(mesh: DeviceMesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh: DeviceMesh) -> tuple:
    """The data-parallel axes present on this mesh, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
