"""The mesh rules and the compiler's device meshes.

The first part is the compiler's meshes: where the sharded engine
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

The second part is the models' distribution strategy (the JAX package's
``repro/parallel/sharding.py``): the logical-axis rules
(:data:`MESH_RULES`, :func:`rules_for_mesh`, :func:`logical_to_spec`), which
read the axis names of either kind of mesh (a ``DeviceMesh``'s
``mesh_dim_names``, a :class:`Mesh`'s ``axis_names``), the DTensor
:func:`placements` a spec names, and the activation constraints
(:func:`constrain_act`).  A spec is a tuple with one entry per tensor
dimension, the reference's ``PartitionSpec``.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Any

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


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rules (the distribution strategy)
# ---------------------------------------------------------------------------
#
# The reference's layout, 2-D FSDP x TP (GSPMD / ZeRO-3 style):
#
#   * ``embed`` (the d_model dim of weight matrices) -> ``data``: the FSDP
#     axis; each block's weights are gathered whole just before use and
#     their gradients reduced back onto the shards, so parameter and
#     optimizer memory divide by |data|.
#   * ``heads`` / ``ff`` / ``experts`` / ``vocab`` -> ``model``.  In the
#     port this axis divides parameter and optimizer memory too; the
#     weights are gathered whole, so activations are not sharded over it
#     (true tensor parallelism is later work, ROADMAP.md).
#   * ``batch`` -> ('pod', 'data'): data parallelism across pods.
#   * ``kv_seq`` -> 'model' for long-context cached decode.
#
# ``layer`` (the reference's stacked per-layer axis) is never sharded; the
# port keeps a parameter per block.  Alternative layouts are rule overrides
# per arch config (``cfg.sharding_overrides``).

MESH_RULES: dict[str, Any] = {
    # weights
    "embed": "data",          # FSDP / ZeRO-3 axis
    "embed_no_fsdp": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "expert_ff": None,
    "vocab": "model",
    "layer": None,
    "conv": None,
    "state": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    # KV caches carry (batch, kv_seq, cache_heads) together: batch takes the
    # data axes, the cache sequence dim takes 'model', heads stay local
    "kv_seq": "model",
    "cache_heads": None,
    "act_embed": None,
    # K/V entering blockwise attention: gathered once per layer
    "attn_kv_seq": None,
    "act_heads": "model",
    "act_ff": "model",
    "act_vocab": "model",
    # DCIM compiler sweeps: the stacked macro-spec axis of the multi-spec
    # engine (repro_torch.core.shardspec), one lane per spec
    "spec": "spec",
}


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of the
    compiler's :class:`Mesh` (``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def rules_for_mesh(mesh, overrides: dict[str, Any] | None = None
                   ) -> dict[str, Any]:
    """:data:`MESH_RULES` with ``overrides`` merged in, and mesh axes the
    mesh does not have dropped (e.g. 'pod' on the single-pod mesh): a
    tuple keeps its axes that exist, one left is a plain name, none is
    ``None``."""
    names = set(mesh_axis_names(mesh))
    out = {}
    merged = dict(MESH_RULES)
    if overrides:
        merged.update(overrides)
    for k, v in merged.items():
        if isinstance(v, list):
            v = tuple(v)
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in names)
            out[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
        else:
            out[k] = v if (v is None or v in names) else None
    return out


def logical_to_spec(axes: tuple[str | None, ...], rules: dict[str, Any]
                    ) -> tuple:
    """One entry per tensor dimension: ``None``, a mesh-axis name or a
    tuple of them (the reference's ``PartitionSpec``)."""
    return tuple(rules.get(a, None) if a is not None else None
                 for a in axes)


def shard_batch_spec(rules: dict[str, Any]) -> tuple:
    return (rules.get("batch"), None)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``: one
    per mesh dimension, ``Shard(d)`` where tensor dimension ``d``'s entry
    names that mesh axis, else ``Replicate()``.  A dimension that names
    several axes (``('pod', 'data')``) is sharded over each, the first
    outermost, as the reference's ``NamedSharding`` splits it; so they
    must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        order = [names.index(a) for a in axes if a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            where[a] = d
    return [Shard(where[n]) if n in where else Replicate() for n in names]


def with_sharding(x, mesh, spec: tuple):
    """``x`` redistributed to ``spec`` on ``mesh`` when it is a DTensor;
    a plain tensor is returned as it is (the reference's constraint is a
    no-op outside a mesh context)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------

_ACT_RULES: contextvars.ContextVar = contextvars.ContextVar("act_rules",
                                                            default=None)


def activation_rules(rules: dict[str, Any] | None):
    """Set the ambient logical->mesh rules used by :func:`constrain_act`.
    Returns a reset token for :func:`reset_activation_rules`."""
    return _ACT_RULES.set(rules)


def reset_activation_rules(token) -> None:
    _ACT_RULES.reset(token)


def constrain_act(x, axes: tuple[str | None, ...]):
    """Constrain an activation to the ambient rules: a DTensor is
    redistributed to the placements the rules name on its own mesh;
    anything else, or any tensor when no rules are set or the rank does
    not match, is returned unchanged.

    On every path the port runs this returns its input: the sharded step
    gathers each weight whole (:mod:`repro_torch.parallel.zero`), so the
    activations at the models' call sites are plain tensors, and
    ``act_shard`` (``launch.train --tuned``) changes nothing.  Only
    DTensor activations, which true tensor parallelism would make, are
    redistributed (DTensor's own collectives, which crash under gloo on
    CUDA tensors: ROADMAP).  The rules are a context variable, so a block
    rematerialised on an autograd thread sees none; that changes nothing
    while the constraint is the identity."""
    rules = _ACT_RULES.get()
    if rules is None or len(axes) != x.ndim:
        return x
    return with_sharding(x, getattr(x, "device_mesh", None),
                         logical_to_spec(axes, rules))
