"""Unified synthesis execution engine: one plan → place → execute → extract
pipeline shared by every way the compiler runs Algorithm 1's evaluation.

The path modules are thin strategies over this one pipeline:

  plan      characterize specs (``DesignLattice`` + ``SpecTables``) and
            bucket them into spec-stacked groups by lattice signature
            (:func:`group_key` / :func:`plan`);
  place     resolve an execution mode and bind it to a torch device or,
            for the sharded modes, a device mesh (:func:`place` /
            :class:`Placement`);
  execute   pack each group's operands (:func:`pack_group`), run the shared
            float64 roll-up (:func:`repro_torch.core.batched.eval_lattice`:
            the CUDA kernel on a card, its plain version ``_eval_kernel``
            on the CPU) under the placed strategy, and finish with the
            shared single-spec numpy tail (:func:`unpack_group`) —
            per-spec results are bit-identical across strategies because
            the kernel is elementwise per spec row (:func:`execute`);
  extract   the frontier tail: a survivor mask (host predicate, on-device
            chunked, or sharded over a mesh — all computing the same
            eps-band verdicts) followed by the exact dedup/order pass
            (:func:`extract_frontier`).

Execution strategies live in a registry (:data:`STRATEGIES`,
:func:`register_strategy`):

  ``"jit"``          one spec, one kernel launch (the :mod:`repro_torch.core.
                     batched` path);
  ``"vmap"``         a same-shape group of specs on one device in one
                     launch, the spec axis written out as the kernel's
                     leading dimension (:mod:`repro_torch.core.multispec`);
  ``"sharded-jit"``  the group's spec axis split into one contiguous lane
                     slice per entry of a ``('spec',)`` mesh
                     (:mod:`repro_torch.parallel.sharding`), each slice run
                     on its entry's device (:mod:`repro_torch.core.
                     shardspec`'s preferred mode);
  ``"pmap"``         the JAX package's ``jax.pmap`` mode name, kept as a
                     public mode: it runs the sharded-jit strategy (folding
                     the lanes to ``(entries, lanes/entry)`` and taking row
                     ``d`` is entry ``d``'s contiguous slice, so a separate
                     path would give the same bits);
  ``"multihost"``    the spec axis split over a ``('host', 'spec')`` mesh,
                     one row per ``torch.distributed`` rank, registered by
                     :mod:`repro_torch.core.multihost`.

A sharded strategy's lanes are padded to the entry count with copies of
lane 0 and the padding is sliced off before the numpy tail, so every lane
computes what the unsharded kernel computes, bit for bit.

Execution is observable: :func:`add_execute_hook` registers a callback fired
once per :func:`execute` call with the plan being run, and
:func:`add_latency_hook` one fired with the plan and its wall-clock seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import Mesh, spec_sweep_mesh
from . import batched as B
from . import subcircuits as sc
from .batched import BatchedPPA, DesignLattice, SpecTables
from .macro import MacroSpec
from .pareto import pareto_indices
from .tech import TechModel

# ---------------------------------------------------------------------------
# Plan: spec grouping + operand packing
# ---------------------------------------------------------------------------


def group_key(lattice: DesignLattice, tables: SpecTables):
    """Specs share a group iff their lattices address identically — same
    registered axes at the same sizes — and their mode axes have equal
    length (mode *names* may differ per spec).  Axis names participate so an
    extended lattice (precision / approx_cell axes enabled) can never fuse
    with a seed lattice that happens to share its flat shape."""
    return (tuple(a.name for a in lattice.axes), lattice.dims,
            lattice.splits, len(tables.modes))


@dataclass(frozen=True)
class PackedGroup:
    """numpy-side operands for one group launch: the shared gather tuple
    (one copy for the whole group) plus every per-spec kernel input stacked
    along a leading spec axis."""

    lattices: tuple[DesignLattice, ...]
    tables_list: tuple[SpecTables, ...]
    csa_i: np.ndarray
    ofu_j: np.ndarray
    idx: tuple[np.ndarray, ...]
    operands: tuple      # (tabs_s, consts_s, e_ofu_s, e_align_s)

    def __len__(self) -> int:
        return len(self.lattices)


def pack_group(lattices: Sequence[DesignLattice],
               tables_list: Sequence[SpecTables]) -> PackedGroup:
    """Pack one group's kernel operands (every strategy executes from this
    one packing, so the paths cannot drift).  Gather indices come from the
    tables' axis-flattening helpers (``csa_index`` / ``ofu_index``), so an
    optional axis's coordinates reach the kernel as wider gathers into the
    flattened tables — never as new kernel code."""
    lat0, t0 = lattices[0], tables_list[0]
    for lat, tab in zip(lattices, tables_list):
        if not tab.compatible_with(lat):
            raise ValueError(
                f"tables built for axes {[(a.name, a.size) for a in tab.axes]}"
                f" cannot serve lattice axes "
                f"{[(a.name, a.size) for a in lat.axes]}")
    csa_i = np.asarray(t0.csa_index(lat0.rho_i, lat0.ro, lat0.rt, lat0.sp_i,
                                    lat0.apx_i))
    ofu_j = np.asarray(t0.ofu_index(lat0.pipe_i, lat0.prec_i))
    packed = [B._kernel_inputs(t) for t in tables_list]
    tabs_s = tuple(np.stack([p[0][j] for p in packed], dtype=np.float64)
                   for j in range(len(packed[0][0])))
    consts_s = np.stack([p[1] for p in packed], dtype=np.float64)
    e_ofu_s = np.stack([p[2] for p in packed], dtype=np.float64)
    e_align_s = np.stack([p[3] for p in packed], dtype=np.float64)
    idx = (lat0.mem_i, lat0.mm_i, csa_i, ofu_j, lat0.prec_i)
    return PackedGroup(lattices=tuple(lattices),
                       tables_list=tuple(tables_list), csa_i=csa_i,
                       ofu_j=ofu_j, idx=idx,
                       operands=(tabs_s, consts_s, e_ofu_s, e_align_s))


def _lane(out: dict, s: int) -> dict:
    """Spec row ``s`` of a group's host outputs (nested dicts of arrays)."""
    return {k: (_lane(v, s) if isinstance(v, dict) else v[s])
            for k, v in out.items()}


def unpack_group(packed: PackedGroup, out: dict) -> list[BatchedPPA]:
    """The shared single-spec numpy tail, applied per spec row of one
    group's kernel outputs (bit-identity by construction)."""
    return [B._finish(packed.lattices[s], packed.tables_list[s], packed.csa_i,
                      packed.ofu_j, _lane(out, s))
            for s in range(len(packed))]


def pad_lanes(arr: np.ndarray, pad: int) -> np.ndarray:
    """Pad the leading spec axis with copies of lane 0 (cheap, NaN-free
    filler — padded lanes are computed and discarded, never compared)."""
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], pad, axis=0)], axis=0)


# ---------------------------------------------------------------------------
# Place: mode dispatch + strategy registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Placement:
    """A resolved execution mode bound to its torch device and, for a
    sharded mode, to its mesh (each mesh entry is one shard; ``device`` is
    then the first entry's)."""

    mode: str
    device: torch.device
    mesh: Mesh | None = None

    @property
    def n_dev(self) -> int:
        """Shards the placement spans: the mesh's entry count, else one."""
        return 1 if self.mesh is None else int(self.mesh.devices.size)


@dataclass(frozen=True)
class Strategy:
    """One way to run a packed group: ``run(packed, placement)`` returns the
    kernel outputs as host numpy with a leading spec axis of exactly
    ``len(packed)`` lanes.  ``default_mesh(device)`` (sharded strategies)
    builds the mesh :func:`place` binds when the caller passes none — each
    sharded strategy owns its placement geometry."""

    name: str
    available: Callable[[], bool]
    run: Callable[[PackedGroup, Placement], dict]
    sharded: bool = False
    default_mesh: Callable[[object], Mesh] | None = None


#: The strategy registry — a new way to execute is a
#: :func:`register_strategy` call, not another execution-path module.
STRATEGIES: dict[str, Strategy] = {}


def register_strategy(strategy: Strategy) -> Strategy:
    STRATEGIES[strategy.name] = strategy
    return strategy


#: Public mode names of the sharded surface (shardspec and the sharded
#: Pareto mask): "jit" = one lane slice per mesh entry, "pmap" = the JAX
#: package's name for the same split, "multihost" = the ('host', 'spec')
#: mesh strategy.
SHARDED_MODES = ("auto", "jit", "pmap", "multihost")

#: Public sharded mode -> engine strategy name.
_SHARDED_STRATEGY = {"jit": "sharded-jit", "pmap": "pmap",
                     "multihost": "multihost"}


def resolve_sharded_mode(mode: str = "auto") -> str:
    """'auto' picks the sharded-jit strategy — the one dispatcher every
    sharded surface (spec sweeps and Pareto extraction) resolves through.
    "multihost" falls back to the single-host pick when the multi-host
    strategy is unavailable on this runtime (no ``torch.distributed``)."""
    if mode not in SHARDED_MODES:
        raise ValueError(f"unknown shardspec mode: {mode!r}; "
                         f"pick from {SHARDED_MODES}")
    if mode == "auto" or (mode == "multihost"
                          and not STRATEGIES["multihost"].available()):
        return "jit"
    return mode


def device_mesh(device=None) -> Mesh:
    """The default ``('spec',)`` mesh of ``device``: every visible CUDA
    card for the bare card (``None`` or ``"cuda"``; an error where there is
    none), else one entry of the device named (``"cuda:1"``, ``"cpu"``)."""
    dev = resolve_device(device)       # no card: the error names "cpu"
    if device is None or str(device) == "cuda":
        return spec_sweep_mesh()
    return spec_sweep_mesh([dev])


def place(mode: str = "auto", mesh: Mesh | None = None, *,
          sharded: bool = False, device=None) -> Placement:
    """Resolve an execution mode and bind it to devices.

    ``mode`` is an engine strategy name or ``"auto"``; ``sharded=True`` makes
    "auto" resolve across devices (:func:`resolve_sharded_mode`) instead of
    to the single-device vmap strategy.  A sharded strategy runs on
    ``mesh``, or without one on its own ``default_mesh`` of ``device``
    (every visible card for the bare card, else the one device named).  An
    unsharded strategy runs on ``device`` and takes no mesh.
    ``device=None`` means the CUDA card and raises where there is none
    (pass ``device="cpu"`` to run on the CPU)."""
    if mode == "auto":
        mode = (_SHARDED_STRATEGY[resolve_sharded_mode("auto")] if sharded
                else "vmap")
    if mode not in STRATEGIES:
        raise ValueError(f"unknown engine mode: {mode!r}; "
                         f"pick from {sorted(STRATEGIES)}")
    strategy = STRATEGIES[mode]
    if not strategy.available():
        raise ValueError(f"engine mode {mode!r} is not available "
                         "on this runtime")
    if not strategy.sharded:
        if mesh is not None:
            raise ValueError(f"engine mode {mode!r} runs on one device; a "
                             "mesh places only the sharded modes")
        return Placement(mode=mode, device=resolve_device(device))
    if mesh is None:
        mesh = strategy.default_mesh(device)
    return Placement(mode=mode, device=mesh.devices.flat[0], mesh=mesh)


# ---------------------------------------------------------------------------
# Execute: the registered strategies
# ---------------------------------------------------------------------------


def _host(x):
    """Device outputs -> host numpy, keeping the dict nesting."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.cpu().numpy()


def _merge(outs: list[dict], join: Callable[[list], np.ndarray]) -> dict:
    """Per-shard host outputs -> one output tree, each leaf ``join``-ed
    from the shards' leaves in shard order."""
    return {k: (_merge([o[k] for o in outs], join) if isinstance(v, dict)
                else join([o[k] for o in outs]))
            for k, v in outs[0].items()}


def _gather_index(packed: PackedGroup, device: torch.device) -> tuple:
    """The group's shared gather tuple as int64 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 .to(torch.int64) for a in packed.idx)


def _dispatch(idx: tuple, operands: tuple, device: torch.device) -> dict:
    """Copy one lane stack's operands to ``device`` and launch the kernel
    over it; the outputs stay on the device."""
    tabs_s, consts_s, e_ofu_s, e_align_s = operands

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return B.eval_lattice(idx, tuple(f64(t) for t in tabs_s), f64(consts_s),
                          f64(e_ofu_s), f64(e_align_s))


def _launch(packed: PackedGroup, device: torch.device) -> dict:
    """Copy one packed group to ``device``, run the kernel once over its
    whole spec stack, and bring the outputs back to the host."""
    return _host(_dispatch(_gather_index(packed, device), packed.operands,
                        device))


def _run_jit(packed: PackedGroup, placement: Placement) -> dict:
    """Single-spec launch — the :mod:`repro_torch.core.batched` path."""
    if len(packed) != 1:
        raise ValueError("the 'jit' strategy runs exactly one spec; "
                         "use 'vmap' or a sharded mode for groups")
    return _launch(packed, placement.device)


def _run_vmap(packed: PackedGroup, placement: Placement) -> dict:
    """One kernel launch for a group of same-shape specs, stacked along the
    kernel's leading spec axis."""
    return _launch(packed, placement.device)


def _padded_operands(packed: PackedGroup, n_dev: int):
    """Pad the ragged spec count of a packed group up to the entry count."""
    tabs_s, consts_s, e_ofu_s, e_align_s = packed.operands
    pad = (-len(packed)) % n_dev
    return (pad, tuple(pad_lanes(t, pad) for t in tabs_s),
            pad_lanes(consts_s, pad), pad_lanes(e_ofu_s, pad),
            pad_lanes(e_align_s, pad))


def _map_entries(packed: PackedGroup, devices, shard_operands) -> list[dict]:
    """The kernel once per mesh entry, on that entry's lane operands and
    device.  Every entry's copies and launches are issued before any output
    is copied back, so entries on distinct cards overlap; the shared gather
    tuple goes to each distinct device once."""
    index: dict[torch.device, tuple] = {}
    outs = []
    for dev, ops in zip(devices, shard_operands):
        if dev not in index:
            index[dev] = _gather_index(packed, dev)
        outs.append(_dispatch(index[dev], ops, dev))
    return [_host(o) for o in outs]


def _lane_slice(operands: tuple, lo: int, hi: int) -> tuple:
    tabs_s, consts_s, e_ofu_s, e_align_s = operands
    return (tuple(t[lo:hi] for t in tabs_s), consts_s[lo:hi],
            e_ofu_s[lo:hi], e_align_s[lo:hi])


def _run_sharded_jit(packed: PackedGroup, placement: Placement) -> dict:
    """The group's spec axis split into one contiguous lane slice per mesh
    entry (row-major over the mesh), each run on its entry's device — the
    kernel is elementwise per spec lane, so splitting the lane axis cannot
    change per-lane float64 arithmetic."""
    if placement.mesh is None:
        raise ValueError(f"the {placement.mode!r} strategy needs a mesh "
                         "(use engine.place to resolve one)")
    n_dev = placement.n_dev
    pad, *operands = _padded_operands(packed, n_dev)
    per = (len(packed) + pad) // n_dev
    outs = _map_entries(packed, placement.mesh.devices.flat,
                        [_lane_slice(operands, i * per, (i + 1) * per)
                         for i in range(n_dev)])
    return _merge(outs, lambda a: np.concatenate(a)[:len(packed)])


register_strategy(Strategy("jit", lambda: True, _run_jit))
register_strategy(Strategy("vmap", lambda: True, _run_vmap))
register_strategy(Strategy("sharded-jit", lambda: True, _run_sharded_jit,
                           sharded=True, default_mesh=device_mesh))
register_strategy(Strategy("pmap", lambda: True, _run_sharded_jit,
                           sharded=True, default_mesh=device_mesh))


# ---------------------------------------------------------------------------
# The plan object + end-to-end execution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecutionPlan:
    """A placed evaluation of N specs: characterized lattices/tables, the
    spec grouping, and the resolved device placement."""

    lattices: tuple[DesignLattice, ...]
    tables: tuple[SpecTables, ...]
    groups: tuple[tuple[int, ...], ...]
    placement: Placement

    def __len__(self) -> int:
        return len(self.lattices)


def plan_for(lattices: Sequence[DesignLattice],
             tables: Sequence[SpecTables], mode: str = "auto",
             mesh: Mesh | None = None, sharded: bool = False,
             placement: Placement | None = None, device=None
             ) -> ExecutionPlan:
    """Group already-characterized specs into an :class:`ExecutionPlan`.
    An already-resolved ``placement`` skips the :func:`place` call (callers
    that time planning and placement as separate phases resolve it first)."""
    groups: dict[tuple, list[int]] = {}
    for i, (lat, tab) in enumerate(zip(lattices, tables)):
        groups.setdefault(group_key(lat, tab), []).append(i)
    if placement is None:
        placement = place(mode, mesh, sharded=sharded, device=device)
    return ExecutionPlan(lattices=tuple(lattices), tables=tuple(tables),
                         groups=tuple(tuple(m) for m in groups.values()),
                         placement=placement)


def plan(specs: Sequence[MacroSpec], tech: TechModel,
         memcells: tuple[sc.MemCellKind, ...] | None = None,
         mode: str = "auto", mesh: Mesh | None = None,
         sharded: bool = False, config: "B.LatticeConfig | None" = None,
         device=None) -> ExecutionPlan:
    """Characterize every spec and bucket them into groups — the one
    grouping every execution path shares, so all paths group identically.
    ``config`` selects the lattice axis set (seed when None); ``memcells``
    overrides its memcell axis (the historical argument)."""
    if config is None:
        config = B.seed_config(memcells)
    elif memcells is not None:
        config = config.with_memcells(memcells)
    # Resolve the placement first: a missing card fails before the tables
    # are characterized.
    placement = place(mode, mesh, sharded=sharded, device=device)
    lattices = [DesignLattice.enumerate(s, config=config) for s in specs]
    tables = [SpecTables(s, tech, config=config) for s in specs]
    return plan_for(lattices, tables, placement=placement)


#: Observers fired once per :func:`execute` call with the plan being run —
#: the instrumentation point for counting engine entries.
_EXECUTE_HOOKS: list[Callable[[ExecutionPlan], None]] = []


def add_execute_hook(hook: Callable[[ExecutionPlan], None]
                     ) -> Callable[[ExecutionPlan], None]:
    """Register an observer called with every :class:`ExecutionPlan` the
    engine runs.  Returns ``hook`` so it can be used as a decorator."""
    _EXECUTE_HOOKS.append(hook)
    return hook


def remove_execute_hook(hook: Callable[[ExecutionPlan], None]) -> None:
    _EXECUTE_HOOKS.remove(hook)


#: Observers fired once per :func:`execute` call with the plan and the
#: wall-clock seconds the pass took.
_LATENCY_HOOKS: list[Callable[[ExecutionPlan, float], None]] = []


def add_latency_hook(hook: Callable[[ExecutionPlan, float], None]
                     ) -> Callable[[ExecutionPlan, float], None]:
    """Register an observer called with ``(plan, elapsed_s)`` after every
    :func:`execute` pass completes.  Returns ``hook`` so it can be used as
    a decorator."""
    _LATENCY_HOOKS.append(hook)
    return hook


def remove_latency_hook(hook: Callable[[ExecutionPlan, float], None]) -> None:
    _LATENCY_HOOKS.remove(hook)


def execute(p: ExecutionPlan
            ) -> list[tuple[DesignLattice, SpecTables, BatchedPPA]]:
    """Run every group of the plan under its placed strategy and finish with
    the shared numpy tail.  Results are returned in input order and are
    bit-identical per spec across every strategy.  Hooks run over a
    snapshot of their registry, so a hook that removes itself cannot skip
    or double-fire its peers."""
    for hook in tuple(_EXECUTE_HOOKS):
        hook(p)
    t0 = time.perf_counter()
    strategy = STRATEGIES[p.placement.mode]
    out: list = [None] * len(p)
    for members in p.groups:
        packed = pack_group([p.lattices[i] for i in members],
                            [p.tables[i] for i in members])
        ppas = unpack_group(packed, strategy.run(packed, p.placement))
        for i, ppa in zip(members, ppas):
            out[i] = (p.lattices[i], p.tables[i], ppa)
    elapsed = time.perf_counter() - t0
    for hook in tuple(_LATENCY_HOOKS):
        hook(p, elapsed)
    return out


# ---------------------------------------------------------------------------
# Extract: the shared frontier tail
# ---------------------------------------------------------------------------


def extract_frontier(objs, mask_fn: Callable[[np.ndarray], np.ndarray]
                     ) -> list[int]:
    """The numpy frontier tail every sweep shares: a survivor mask from
    ``mask_fn`` (host :func:`repro_torch.core.pareto.nondominated_mask`,
    the on-device chunked :func:`repro_torch.core.batched.pareto_mask`, or
    the mesh-sharded :func:`repro_torch.core.pareto.
    nondominated_mask_sharded` — bit-identical by construction), then the
    exact dedup/order pass of :func:`repro_torch.core.pareto.
    pareto_indices` on the survivors.
    Returns indices into ``objs`` sorted by objective tuple."""
    objs = np.asarray(objs, dtype=np.float64)
    mask = np.asarray(mask_fn(objs)).astype(bool)
    survivors = np.flatnonzero(mask)
    order = pareto_indices([tuple(o) for o in objs[mask]])
    return [int(survivors[i]) for i in order]


# The multi-host strategy registers itself against this module's registry;
# importing it last keeps the registration a plain `register_strategy` call
# without a circular-import dance.
from . import multihost as _multihost  # noqa: E402,F401
