"""The compiler's device meshes: where the sharded engine
(:mod:`repro_torch.core.engine`, :mod:`repro_torch.core.shardspec`,
:mod:`repro_torch.core.multihost`) places its stacked spec-lane axis.

torch has no ``jax.sharding.Mesh``, so :class:`Mesh` is a small frozen
stand-in with the surface the engine reads: ``devices`` (an ndarray of
``torch.device``, one dimension per axis), ``axis_names``,
``devices.size`` and ``devices.shape``.  **One entry is one shard, and an
entry may name a device more than once.**  torch has a single CPU device,
so the JAX package's "8 fake host devices" become a mesh of
``["cpu"] * 8``: eight shards, run one after another on the CPU.  Likewise
``["cuda:0"] * 4`` splits the lanes four ways on one card.  Every entry's
lanes compute exactly what they would alone (the engine's kernel is
elementwise per lane), so the entry count never changes a result.

Across processes (``torch.distributed``), each process knows only its own
devices.  :func:`host_spec_mesh` then gives the ``host`` axis one row per
rank and fills every row with the calling process's devices: row ``r``
stands for rank ``r``'s devices, which are taken to be laid out like the
caller's.  A process only ever runs on its own row
(:mod:`repro_torch.core.multihost`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over an ndarray of ``torch.device`` entries (see the
    module doc: one entry is one shard; entries may repeat a device)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        if devs.ndim != len(self.axis_names) or devs.size == 0:
            raise ValueError(f"a mesh over axes {self.axis_names} needs a "
                             f"non-empty {len(self.axis_names)}-d device "
                             f"array, got shape {devs.shape}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))


def _entries(devices) -> np.ndarray:
    """``devices`` as a flat object array of ``torch.device``; ``None`` is
    every visible CUDA card, and an error where there is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible for the mesh; pass "
                "devices=[\"cpu\"] (or [\"cpu\"] * n for n shards) to "
                "place it on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    out = np.empty(len(devs), dtype=object)
    out[:] = devs
    return out


def spec_sweep_mesh(devices=None) -> Mesh:
    """1-D ``('spec',)`` mesh over ``devices`` (default: every visible CUDA
    card) — the placement of the sharded multi-spec engine's spec lanes.
    The engine's kernel is elementwise along the spec axis, so a flat axis
    is all it needs."""
    return Mesh(_entries(devices), ("spec",))


def world_size() -> int:
    """Processes in the default ``torch.distributed`` group, 1 without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def host_spec_mesh(devices=None, n_hosts: int | None = None) -> Mesh:
    """2-D ``('host', 'spec')`` mesh: one row per host, the per-host
    entries along ``'spec'`` — the placement of the engine's multi-host
    strategy (:mod:`repro_torch.core.multihost`).  ``n_hosts`` defaults to
    the ``torch.distributed`` world size (1 without a process group).

    Without a process group (or in a world of one), ``devices`` are all the
    mesh's entries and are split into ``n_hosts`` rows; a ragged split falls
    back to one row, the single-host spec sweep.  In a world of several
    processes, ``devices`` are the caller's own and every one of the
    ``n_hosts`` rows holds them (the module doc says why)."""
    devs = _entries(devices)
    world = world_size()
    if n_hosts is None:
        n_hosts = world
    if world > 1:
        return Mesh(np.stack([devs] * max(n_hosts, 1)), ("host", "spec"))
    if n_hosts < 1 or devs.size % n_hosts:
        n_hosts = 1            # ragged host split: fall back to one host row
    return Mesh(devs.reshape(n_hosts, -1), ("host", "spec"))
