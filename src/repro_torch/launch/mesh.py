"""Meshes of ranks (the port of the JAX package's ``repro/launch/mesh.py``).

A device of the port's model mesh is one process of the default
``torch.distributed`` group: a rank.  The mesh is a ``DeviceMesh`` with
named dimensions over every rank (``init_device_mesh``).

:func:`make_host_mesh` keeps the reference's rule, with the world size in
place of the visible device count: a shape wider than the world shrinks to
``(1, ..., world)``.  A shape of one rank is the one-device path: the
shape is returned as ``{axis: size}`` and no mesh is built (a world of one
needs no process group).  :func:`init_distributed` starts the process
group from ``torch.distributed.run``'s environment, with the backend the
caller names, and :func:`group_line` reports the group's backend after a
barrier of every rank.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..parallel.sharding import world_size

BACKENDS = ("nccl", "gloo")


def parse_mesh(s: str):
    dims = tuple(int(x) for x in s.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, axes


def mesh_shape(shape: tuple[int, ...], axes: tuple[str, ...],
               n_devices: int) -> dict[str, int]:
    """``{axis: size}`` under the shrink rule: a shape wider than
    ``n_devices`` becomes ``(1, ..., n_devices)``."""
    if math.prod(shape) > n_devices:
        shape = (1,) * (len(shape) - 1) + (n_devices,)
    return dict(zip(axes, shape))


def mesh_dims(mesh) -> dict[str, int]:
    """A mesh's ``{axis: size}``: a ``DeviceMesh``'s, or the one-rank
    shape :func:`make_host_mesh` returns as it is."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_host_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model"), *,
                   device_type: str = "cuda"):
    """The reference's small host mesh over the ranks of the default
    process group (its world size, 1 without one): ``{axis: size}`` when
    the shrunk shape holds one rank, else a ``DeviceMesh`` of
    ``device_type`` over the ranks.  A shape of more than one rank must
    fill the process group."""
    world = world_size()
    dims = mesh_shape(shape, axes, world)
    size = math.prod(dims.values())
    if size == 1:
        return dims
    if size != world:
        raise ValueError(
            f"mesh {dims} spans {size} ranks, the process group holds "
            f"{world}; start {size} ranks (torch.distributed.run "
            f"--nproc-per-node {size}) or ask for a mesh of {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(dims.values()),
                            mesh_dim_names=tuple(dims))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's pod meshes: (16, 16) ``('data', 'model')``, or
    (2, 16, 16) ``('pod', 'data', 'model')``, over 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def init_distributed(backend: str, device=None) -> torch.device:
    """Join the default process group from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``env://``) with
    ``backend``, and return this rank's device: ``cuda:(LOCAL_RANK %
    device_count)``, or the CPU when ``device`` is ``'cpu'``.  Outside
    ``torch.distributed.run`` (no ``WORLD_SIZE``) no group is started and
    the device is ``device`` as :func:`repro_torch.device.resolve_device`
    gives it."""
    from ..device import resolve_device

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return resolve_device(device)
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass --device "
                               "cpu to run the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://")
    return dev


def group_line() -> str | None:
    """``group: backend <name>, world <size>`` after a barrier of every
    rank (a collective on the group's backend, where the run made none),
    or None outside a process group.  Every rank calls it."""
    if not dist.is_initialized():
        return None
    dist.barrier()
    return (f"group: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")


def is_main() -> bool:
    """Rank 0, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0
