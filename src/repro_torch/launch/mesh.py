"""Device meshes (port of ``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions over the process group that is running.  Defined as functions
(never module-level constants), so importing this module touches no
process group: the dry run starts a fake group of 256 or 512 ranks first
(:mod:`repro_torch.launch.dryrun`) and only then calls these.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.device import DeviceLike, resolve_device


def _mesh_device_type() -> str:
    """The mesh's device type, from the running group's backend: NCCL
    ranks hold CUDA tensors, gloo and fake ranks CPU (or meta) ones."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axis_names):
    """A mesh of ``shape`` named ``axis_names`` over the running process
    group, whose world size must be the product of ``shape``."""
    return init_device_mesh(_mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 chips) or 2x16x16 dual-pod (512 chips); the
    running group must have that many ranks (the dry run fakes them)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def init_single(device: DeviceLike = None) -> None:
    """A process group of world size 1 for ``device`` (``None`` = the
    CUDA device): NCCL on the card, gloo only for ``device="cpu"``.  The
    store is in-process, so nothing listens on a port."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(device: DeviceLike = None):
    """Whatever the running group has: pure data parallel over its world
    size.  Without a running group, one of world size 1 is started for
    ``device`` (:func:`init_single`)."""
    if not dist.is_initialized():
        init_single(device)
    return make_mesh((dist.get_world_size(),), ("data",))


def destroy() -> None:
    """End the running process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
