"""Multi-host spec sharding: one ``register_strategy`` call on the shared
execution engine, not a new execution-path module.

The strategy splits each group's stacked spec axis over a 2-D
``('host', 'spec')`` mesh (:func:`repro_torch.parallel.sharding.
host_spec_mesh`): one row per ``torch.distributed`` rank, that rank's mesh
entries along the second axis.  A fused pass splits specs first across
hosts and then across each host's entries.

* **Single controller** (no process group, or a world of one): every entry
  is this process's, so the lane axis is split over both mesh axes at once,
  row-major, through the engine's sharded-jit path.
* **Several processes**: each process knows only its own devices (the
  mesh's other rows stand for the other ranks', see
  :mod:`repro_torch.parallel.sharding`).  Each rank runs its contiguous lane
  slice on its own row through the sharded-jit path, and the per-key
  float64 outputs are gathered with ``torch.distributed.all_gather`` on the
  default process group, in rank order, which is lane order.  Every rank
  plans the same groups from the same specs (the planner is deterministic),
  so every rank packs the same operands and ends with the whole result.
  gloo gathers host tensors; other backends gather tensors on the rank's
  first mesh device.

On one host the placement degenerates to the single-host spec sweep —
same entries, same per-lane float64 arithmetic, bit-identical results.
Where ``torch.distributed`` is missing,
:func:`repro_torch.core.engine.resolve_sharded_mode` falls back from
"multihost" to the single-host pick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel.sharding import Mesh, host_spec_mesh, world_size
from . import engine as E


def _host_spec_mesh(device=None) -> Mesh:
    """The default ``('host', 'spec')`` mesh of ``device`` (the entries of
    :func:`repro_torch.core.engine.device_mesh`)."""
    return host_spec_mesh(list(E.device_mesh(device).devices.flat))


def _available() -> bool:
    """Capability probe: the multi-process branch needs
    ``torch.distributed``."""
    return torch.distributed.is_available()


def _check_mesh(placement: E.Placement) -> Mesh:
    mesh = placement.mesh
    if mesh is None:
        raise ValueError("the 'multihost' strategy needs a mesh "
                         "(use engine.place to resolve one)")
    if tuple(mesh.axis_names) != ("host", "spec"):
        raise ValueError("the 'multihost' strategy needs a ('host', 'spec') "
                         f"mesh, got axes {tuple(mesh.axis_names)}")
    return mesh


def _slice_packed(packed: E.PackedGroup, lo: int, hi: int) -> E.PackedGroup:
    """One host's contiguous slice of a group's lane axis (shared gather
    tuple kept whole — it is lane-invariant)."""
    return E.PackedGroup(
        lattices=packed.lattices[lo:hi],
        tables_list=packed.tables_list[lo:hi], csa_i=packed.csa_i,
        ofu_j=packed.ofu_j, idx=packed.idx,
        operands=E._lane_slice(packed.operands, lo, hi))


def _all_gather(a: np.ndarray, device: torch.device) -> np.ndarray:
    """Every rank's ``a`` (same shape on each) concatenated in rank order
    along the lane axis."""
    dist = torch.distributed
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def _run_multiprocess(packed: E.PackedGroup, placement: E.Placement) -> dict:
    """World size > 1: this rank's contiguous lane slice on its own mesh
    row, then an all-gather of the outputs in rank (= lane) order."""
    dist = torch.distributed
    mesh = placement.mesh
    n_hosts = mesh.devices.shape[0]
    if n_hosts != dist.get_world_size():
        # A hand-built mesh whose host axis disagrees with the world would
        # make the per-rank slices (and the gather shapes) inconsistent
        # across ranks — fail loudly instead of gathering garbage.
        raise ValueError(
            f"multihost mesh has {n_hosts} host rows but the process group "
            f"has {dist.get_world_size()} ranks; build the mesh with "
            "parallel.sharding.host_spec_mesh on every rank")
    me = dist.get_rank()
    pad, *operands = E._padded_operands(packed, n_hosts)
    padded = dataclasses.replace(
        packed, lattices=packed.lattices + (packed.lattices[0],) * pad,
        tables_list=packed.tables_list + (packed.tables_list[0],) * pad,
        operands=tuple(operands))
    per = len(padded) // n_hosts
    mine = _slice_packed(padded, me * per, (me + 1) * per)
    row = Mesh(mesh.devices[me], ("spec",))
    out_local = E._run_sharded_jit(
        mine, E.Placement(mode="sharded-jit", device=row.devices[0],
                          mesh=row))
    gather_on = (torch.device("cpu") if dist.get_backend() == "gloo"
                 else row.devices[0])
    return E._merge([out_local],
                    lambda a: _all_gather(a[0], gather_on)[:len(packed)])


def _run_multihost(packed: E.PackedGroup, placement: E.Placement) -> dict:
    """The spec axis split over the ``('host', 'spec')`` mesh — specs split
    across hosts, then across each host's entries."""
    _check_mesh(placement)
    if world_size() == 1:
        return E._run_sharded_jit(packed, placement)
    return _run_multiprocess(packed, placement)


#: Multi-host spec sharding is a register_strategy call on the engine.
MULTIHOST = E.register_strategy(
    E.Strategy("multihost", _available, _run_multihost, sharded=True,
               default_mesh=_host_spec_mesh))
