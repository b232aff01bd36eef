"""Production and smoke meshes as ``DeviceMesh``es (port of
``repro.launch.mesh``).

The reference's production meshes are a TPU v5e pod: (16, 16) on ("data",
"model"), 256 chips, and a 2-pod (2, 16, 16) job with a leading "pod"
axis.  The port keeps those shapes, so every spec can be held equal to the
reference's; on H100s a 16-wide "model" axis spans two 8-GPU NVLink nodes.
The meshes span the current ``torch.distributed`` world: the dry-run opens
a fake process group of 256 or 512 ranks in one process
(:mod:`repro_torch.launch.dryrun`).  Building a mesh is a function call, so
importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != ndev:
        raise RuntimeError(
            f"need a world of {ndev} ranks for mesh {shape}, have {have}; "
            "the dry-run (python -m repro_torch.launch.dryrun) opens a fake "
            f"process group of {ndev} ranks")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_smoke_mesh(shape=(1,), axes=("data",),
                    device_type: str | None = None) -> DeviceMesh:
    """A small mesh over the first ranks of the current world.  With no
    process group, a world of one is opened first (a ``dist.HashStore``,
    no environment variables): NCCL on the card, gloo on the CPU."""
    if not dist.is_initialized():
        device_type = device_type or "cuda"
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                           f"has {dist.get_world_size()}")
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def abstract_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` and ``axes`` with no process group behind it:
    enough for spec arithmetic (:mod:`repro_torch.launch.specs`), nothing
    runs on it."""
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(
        tuple(shape)), mesh_dim_names=tuple(axes), _init_backend=False,
        _rank=0)


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry data parallelism ("pod" spans pods)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
