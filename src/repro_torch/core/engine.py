"""Unified synthesis execution engine: one plan → place → execute → extract
pipeline shared by every way the compiler runs Algorithm 1's evaluation.

The path modules are thin strategies over this one pipeline:

  plan      characterize specs (``DesignLattice`` + ``SpecTables``) and
            bucket them into spec-stacked groups by lattice signature
            (:func:`group_key` / :func:`plan`);
  place     resolve an execution mode and bind it to a torch device
            (:func:`place` / :class:`Placement`);
  execute   pack each group's operands (:func:`pack_group`), run the shared
            float64 kernel (:func:`repro_torch.core.batched._eval_kernel`)
            under the placed strategy, and finish with the shared single-spec
            numpy tail (:func:`unpack_group`) — per-spec results are
            bit-identical across strategies because the kernel is
            elementwise per spec row (:func:`execute`);
  extract   the frontier tail: a survivor mask (host predicate or on-device
            chunked, both computing the same eps-band verdicts) followed by
            the exact dedup/order pass (:func:`extract_frontier`).

Execution strategies live in a registry (:data:`STRATEGIES`,
:func:`register_strategy`):

  ``"jit"``    one spec, one kernel launch (the :mod:`repro_torch.core.
               batched` path);
  ``"vmap"``   a same-shape group of specs on one device in one launch, the
               spec axis written out as the kernel's leading dimension
               (:mod:`repro_torch.core.multispec`).

The JAX package's device-sharded strategies (``"sharded-jit"``, ``"pmap"``,
``"multihost"``) belong to the port's sharded slice (ROADMAP queue 1,
item 4); asking for them raises :class:`NotImplementedError`.

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
from . import batched as B
from . import subcircuits as sc
from .batched import BatchedPPA, DesignLattice, SpecTables
from .macro import MacroSpec
from .pareto import pareto_indices
from .tech import TechModel

#: Where the device-sharded engine modes are queued.
_SHARDED_QUEUE_ITEM = ("ROADMAP.md queue 1, item 4 (core/shardspec.py and "
                       "core/multihost.py)")

#: Engine modes of the JAX package that wait for the sharded slice.
SHARDED_MODES = ("sharded-jit", "pmap", "multihost")


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
    """Pack one group's kernel operands (both strategies execute from this
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
    """A resolved execution mode bound to its torch device."""

    mode: str
    device: torch.device

    @property
    def n_dev(self) -> int:
        """Devices the placement spans: one, until the sharded engine."""
        return 1


@dataclass(frozen=True)
class Strategy:
    """One way to run a packed group: ``run(packed, placement)`` returns the
    kernel outputs as host numpy with a leading spec axis of exactly
    ``len(packed)`` lanes."""

    name: str
    available: Callable[[], bool]
    run: Callable[[PackedGroup, Placement], dict]


#: The strategy registry — a new way to execute is a
#: :func:`register_strategy` call, not another execution-path module.
STRATEGIES: dict[str, Strategy] = {}


def register_strategy(strategy: Strategy) -> Strategy:
    STRATEGIES[strategy.name] = strategy
    return strategy


def _sharded_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {_SHARDED_QUEUE_ITEM}")


def place(mode: str = "auto", device=None, *, sharded: bool = False
          ) -> Placement:
    """Resolve an execution mode and bind it to a device.

    ``mode`` is an engine strategy name or ``"auto"`` (the spec-stacked
    ``"vmap"`` strategy).  ``device=None`` means the CUDA card and raises
    where there is none (pass ``device="cpu"`` to run on the CPU)."""
    if sharded:
        raise _sharded_not_ported("sharded execution (sharded=True)")
    if mode in SHARDED_MODES:
        raise _sharded_not_ported(f"engine mode {mode!r}")
    if mode == "auto":
        mode = "vmap"
    if mode not in STRATEGIES:
        raise ValueError(f"unknown engine mode: {mode!r}; "
                         f"pick from {sorted(STRATEGIES)}")
    if not STRATEGIES[mode].available():
        raise ValueError(f"engine mode {mode!r} is not available "
                         "on this runtime")
    return Placement(mode=mode, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Execute: the registered strategies
# ---------------------------------------------------------------------------


def _host(x):
    """Device outputs -> host numpy, keeping the dict nesting."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x.cpu().numpy()


def _launch(packed: PackedGroup, device: torch.device) -> dict:
    """Copy one packed group to ``device``, run the kernel once over its
    whole spec stack, and bring the outputs back to the host."""
    tabs_s, consts_s, e_ofu_s, e_align_s = packed.operands

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    idx = tuple(torch.as_tensor(np.asarray(a), device=device)
                .to(torch.int64) for a in packed.idx)
    out = B._eval_kernel(idx, tuple(f64(t) for t in tabs_s), f64(consts_s),
                         f64(e_ofu_s), f64(e_align_s))
    return _host(out)


def _run_jit(packed: PackedGroup, placement: Placement) -> dict:
    """Single-spec launch — the :mod:`repro_torch.core.batched` path."""
    if len(packed) != 1:
        raise ValueError("the 'jit' strategy runs exactly one spec; "
                         "use 'vmap' for groups")
    return _launch(packed, placement.device)


def _run_vmap(packed: PackedGroup, placement: Placement) -> dict:
    """One kernel launch for a group of same-shape specs, stacked along the
    kernel's leading spec axis."""
    return _launch(packed, placement.device)


register_strategy(Strategy("jit", lambda: True, _run_jit))
register_strategy(Strategy("vmap", lambda: True, _run_vmap))


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
             tables: Sequence[SpecTables], mode: str = "auto", device=None,
             sharded: bool = False,
             placement: Placement | None = None) -> ExecutionPlan:
    """Group already-characterized specs into an :class:`ExecutionPlan`.
    An already-resolved ``placement`` skips the :func:`place` call (callers
    that time planning and placement as separate phases resolve it first)."""
    groups: dict[tuple, list[int]] = {}
    for i, (lat, tab) in enumerate(zip(lattices, tables)):
        groups.setdefault(group_key(lat, tab), []).append(i)
    if placement is None:
        placement = place(mode, device, sharded=sharded)
    return ExecutionPlan(lattices=tuple(lattices), tables=tuple(tables),
                         groups=tuple(tuple(m) for m in groups.values()),
                         placement=placement)


def plan(specs: Sequence[MacroSpec], tech: TechModel,
         memcells: tuple[sc.MemCellKind, ...] | None = None,
         mode: str = "auto", device=None, sharded: bool = False,
         config: "B.LatticeConfig | None" = None) -> ExecutionPlan:
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
    placement = place(mode, device, sharded=sharded)
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
    ``mask_fn`` (host :func:`repro_torch.core.pareto.nondominated_mask` or
    the on-device chunked :func:`repro_torch.core.batched.pareto_mask` —
    bit-identical by construction), then the exact dedup/order pass of
    :func:`repro_torch.core.pareto.pareto_indices` on the survivors.
    Returns indices into ``objs`` sorted by objective tuple."""
    objs = np.asarray(objs, dtype=np.float64)
    mask = np.asarray(mask_fn(objs)).astype(bool)
    survivors = np.flatnonzero(mask)
    order = pareto_indices([tuple(o) for o in objs[mask]])
    return [int(survivors[i]) for i in order]
