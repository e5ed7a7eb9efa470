"""Mesh construction: the port of ``repro.launch.mesh`` over
``torch.distributed``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the initialised process group, with the reference's axis names
and shapes.  These are functions, never module-level constants: importing
this module touches no process group (the dry run builds 256- and
512-rank meshes on a fake group, while a one-card run sees a world of 1).
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def device_type() -> str:
    """The device type a mesh of the initialised group lives on: ``cuda``
    under NCCL, ``cpu`` under gloo (or the fake backend)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "torch.distributed.init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2x16x16 = 512 ranks across two pods.
    The process group must have that world size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type(), shape, mesh_dim_names=axes)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch shards over (everything but 'model')."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a != "model")


def model_axis(mesh) -> str:
    return "model"


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the initialised group; the
    model axis is halved until it divides the world size."""
    kind = device_type()
    n = dist.get_world_size()
    mp = model_parallel
    while mp > 1 and n % mp:
        mp //= 2
    return init_device_mesh(kind, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
