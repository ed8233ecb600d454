"""Process groups and device meshes.

The port of ``repro.launch.mesh`` on ``torch.distributed``.  The backend
follows the device: ``nccl`` for cuda (after ``torch.cuda.set_device`` to
the process's ``LOCAL_RANK``), ``gloo`` for cpu.  Rank and world size come
from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``); without one, the process is a world of
one over an in-process ``HashStore``.  A process group that is already
initialised (a test's ``FileStore`` world, say) is taken as it is.
Meshes are ``DeviceMesh``es with dims ``("data", "model")`` or ``("pod",
"data", "model")``, as in ``repro``.  Importing this module starts
nothing.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def init_distributed(device: str | torch.device = "cuda") -> int:
    """Start (or join) the default process group; returns the world size."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if dist.is_initialized():
        return dist.get_world_size()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _device_type(device: str | torch.device) -> str:
    return resolve_device(device).type


def make_local_mesh(model_axis: int = 1, device: str | torch.device = "cuda"
                    ) -> DeviceMesh:
    """``(world // model_axis, model_axis)`` over ``("data", "model")``;
    raises where ``model_axis`` does not divide the world."""
    world = init_distributed(device)
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return init_device_mesh(_device_type(device),
                            (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """16x16 ranks per pod, 2 pods on the ``pod`` axis: ``repro``'s
    shapes.  Raises unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = init_distributed(device)
    need = 1
    for s in shape:
        need *= s
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, "
                         f"the world has {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)
