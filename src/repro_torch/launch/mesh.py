"""Device meshes over an initialised ``torch.distributed`` process group.

The backend is the caller's, chosen once when it initialises the group
(``torch.distributed.init_process_group``: NCCL where each rank has its
own card, ``gloo`` for CPU ranks or ranks that share a card) and never
switched here. Nothing on a machine tells a program of its cluster: the
caller gives the group its address, world size and rank.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with the named ``axes`` (e.g.
    ("data", "model") or ("pod", "data", "model")) over the initialised
    world, rank r at the row-major position r. Raises when no group is
    initialised or when the world size is not the mesh's size."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16, 16) ('data', 'model') = 256 ranks. Multi-pod:
    (2, 16, 16) ('pod', 'data', 'model') = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
