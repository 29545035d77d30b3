"""Device meshes over the initialised process group.

The reference package's ``repro/launch/mesh.py``.  The reference is one
controller over every device (``jax.make_mesh``); the port runs one process
per rank, as PyTorch does, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group the caller initialised (``torch.distributed.init_process_group``, or
``launch.ranks.run_ranks``), with the reference's axis names as
``mesh_dim_names``.  The reference's ``mesh.shape[axis]`` is
``mesh.size(mesh.mesh_dim_names.index(axis))`` here (``axis_size``).

Functions, not module-level constants, so that importing this module touches
no process group.  Meshes are on the card (``device_type="cuda"``) unless the
caller names another device type; the CPU tests pass ``"cpu"``.
"""

from __future__ import annotations

from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the world's ranks (row-major), its
    dimensions named ``axes``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first (torch.distributed.init_process_group)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the process group, as a 1-D 'data' mesh."""
    return make_mesh((dist.get_world_size(),), ("data",), device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The reference's production shapes: 16 x 16 = 256 ranks ('data',
    'model'); ``multi_pod`` adds a 2-way 'pod' axis in front (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the named mesh axis."""
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))
