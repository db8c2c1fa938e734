"""Device meshes on the current ``torch.distributed`` process group, the
port of ``repro/launch/mesh.py``.

Nothing here starts a process group: the caller does, with its own
address, world size and rank (``torch.distributed.init_process_group``;
NCCL on the card, gloo on the CPU), and every rank then builds the same
mesh.  ``device`` defaults to ``"cuda"``; ``"cpu"`` makes a gloo mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..engine.plan import resolve_device


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call init_process_group first")
    return dist.get_world_size()


def make_mesh_compat(shape, axes, device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the group's ranks in order, its
    dimensions named ``axes``."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} mesh dimensions but {len(axes)} names: {shape}, {axes}")
    world = _world()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a {shape} mesh needs {size} ranks; the process group has {world}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 ranks (``data``, ``model``), or 2 x 16 x 16 = 512
    (``pod``, ``data``, ``model``) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a process group of {need} ranks; it has {world}")
    return make_mesh_compat(shape, axes, device)


def make_host_mesh(model_axis: int = 1, device: str = "cuda") -> DeviceMesh:
    """(world / model_axis, model_axis) over the whole process group
    (``data``, ``model``): tests and smoke runs."""
    world = _world()
    if world % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide the world of {world}")
    return make_mesh_compat((world // model_axis, model_axis), ("data", "model"), device)
