"""Mesh construction over the launched ranks (the JAX package's
``launch/mesh.py``).

Functions, not module constants, so importing never touches the process
group.  ``make_local_mesh`` lays ``(world // model, model)`` with axes
``("data", "model")`` over however many ranks ``core.mesh.launch`` started;
``make_production_mesh`` is the same for the production meshes, 16 x 16 =
256 ranks with axes (data, model), or 2 x 16 x 16 = 512 with (pod, data,
model), and raises unless the world has that many.  The planner needs only
``production_mesh_shape``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist

from repro_torch.core.mesh import ProcessMesh


def production_mesh_shape(*, multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                           f"this process group has {world}")
    return ProcessMesh(shape, axes)


def make_local_mesh(model: int = 1) -> ProcessMesh:
    """``(world // model, model)`` over the launched ranks (tests, CPU and
    one-card runs)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs the ranks' process group "
                           "(core.mesh.launch starts it)")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"--model-parallel {model} does not divide the {world} ranks")
    return ProcessMesh((world // model, model), ("data", "model"))
