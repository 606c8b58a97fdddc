"""Device-sharded multi-spec co-synthesis (100+-spec sweeps).

:mod:`repro_torch.core.multispec` fuses N same-shape specs into one
spec-stacked kernel launch; this module is the **sharded strategy pair**
over the shared execution engine (:mod:`repro_torch.core.engine`), placing
that launch *across the entries of a device mesh*
(:mod:`repro_torch.parallel.sharding`) so spec sweeps keep scaling past
what one card holds.  The stacked spec axis of each group is padded to the
entry count and the *same* float64 kernel runs on each entry's lanes — the
kernel is elementwise per spec lane, so splitting the lane axis cannot
change per-lane arithmetic and results stay bit-identical to the unsharded
path on one entry and on N (``["cpu"] * 8`` in the tests).

Modes, resolved by the engine's :func:`repro_torch.core.engine.
resolve_sharded_mode`:

  ``"jit"``        the engine's ``"sharded-jit"`` strategy — one contiguous
                   lane slice per mesh entry, the preferred path;
  ``"pmap"``       the JAX package's name for the same split, kept as a
                   mode (it runs the sharded-jit path);
  ``"multihost"``  the ``('host', 'spec')`` mesh strategy
                   (:mod:`repro_torch.core.multihost`).

Entry points mirror the unsharded engine one-for-one: ``evaluate_many`` ->
:func:`evaluate_many_sharded`, ``mso_search_many`` ->
:func:`mso_search_many_sharded`, ``design_space_sweep_many`` ->
:func:`design_space_sweep_many_sharded` (whose sweeps also extract their
frontiers sharded, via :func:`repro_torch.core.pareto.
nondominated_mask_sharded`).  Each takes ``mesh=`` or, without one,
builds the strategy's default mesh from ``device=`` (``None``: every
visible CUDA card, an error where there is none; ``"cpu"``: one CPU entry).
:func:`spec_variants` generates the deterministic 100+-spec request the
sweeps drive this with.  Padding, placement and packing live in the engine
layer — this module registers nothing of its own.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from . import batched as B
from . import engine as E
from . import multispec as MS
from . import subcircuits as sc
from .batched import BatchedPPA, BatchedSweep, DesignLattice, SpecTables
from .macro import MacroSpec
from .pareto import (SHARDED_EXTRACT_MIN_POINTS, nondominated_mask,
                     nondominated_mask_sharded)
from .searcher import SearchResult
from .tech import TechModel

#: Execution modes accepted by the sharded entry points.
MODES = E.SHARDED_MODES

#: Public sharded mode -> engine strategy (the engine owns the dispatch).
_ENGINE_MODE = dict(E._SHARDED_STRATEGY)

# One dispatcher for every sharded surface — the engine's, re-exported
# under the JAX package's name.
resolve_mode = E.resolve_sharded_mode


def _plan(specs, tech, memcells, mesh, mode, config, device
          ) -> E.ExecutionPlan:
    return E.plan(list(specs), tech, tuple(memcells),
                  mode=_ENGINE_MODE[resolve_mode(mode)], mesh=mesh,
                  config=config, device=device)


def evaluate_many_sharded(specs: Sequence[MacroSpec], tech: TechModel,
                          memcells: tuple[sc.MemCellKind, ...] = B.MEMCELLS,
                          mesh=None, mode: str = "auto",
                          config: B.LatticeConfig | None = None,
                          device=None
                          ) -> list[tuple[DesignLattice, SpecTables,
                                          BatchedPPA]]:
    """Sharded counterpart of :func:`repro_torch.core.multispec.
    evaluate_many`: same grouping, same kernel, same numpy tail — the spec
    axis of each group is split across ``mesh`` (default: the mode's mesh
    of ``device``).  Results are returned in input order, bit-identical per
    spec to the unsharded path.  ``config`` selects the registered axis set
    (seed when None)."""
    return E.execute(_plan(specs, tech, memcells, mesh, mode, config,
                           device))


def mso_search_many_sharded(specs: Sequence[MacroSpec], scl=None,
                            tech: TechModel = None, resolution: int = 4,
                            mesh=None, mode: str = "auto",
                            config: B.LatticeConfig | None = None,
                            device=None) -> list[SearchResult]:
    """Synthesize 100+ macro specs in one sharded pass.

    Per-spec results (explored set, frontier, every PPA field, Alg.-1
    selection order) are bit-identical to :func:`repro_torch.core.
    multispec.mso_search_many`.  ``scl`` is accepted for signature parity
    with the other search entry points."""
    if tech is None:
        raise ValueError("tech model required")
    evals = evaluate_many_sharded(specs, tech,
                                  memcells=(sc.MemCellKind.SRAM_6T,),
                                  mesh=mesh, mode=mode, config=config,
                                  device=device)
    return [B._alg1_replay(lat, tab, T, resolution)
            for lat, tab, T in evals]


def _sharded_extract(objs, mode: str, mesh) -> np.ndarray:
    """Survivor mask for a sharded sweep's frontier: the mesh-sharded
    map-reduce at lattice scale, the host pass below the sharding payoff
    point (:data:`repro_torch.core.pareto.SHARDED_EXTRACT_MIN_POINTS` —
    feasible candidate sets are often small after the validity filter).
    Same bits either way; the sweep's own mesh bounds which devices
    extraction may touch."""
    if len(objs) < SHARDED_EXTRACT_MIN_POINTS:
        return nondominated_mask(objs)
    return nondominated_mask_sharded(objs, mode=mode, mesh=mesh)


def design_space_sweep_many_sharded(specs: Sequence[MacroSpec],
                                    tech: TechModel,
                                    memcells: tuple[sc.MemCellKind, ...]
                                    = B.MEMCELLS,
                                    mesh=None, mode: str = "auto",
                                    config: B.LatticeConfig | None = None,
                                    device=None) -> list[BatchedSweep]:
    """Exhaustive sweeps for N specs, spec axis sharded across a mesh.

    The returned sweeps extract their frontiers sharded too
    (:func:`repro_torch.core.pareto.nondominated_mask_sharded`, same mode
    and mesh as the evaluation, host pass below the payoff point) —
    bit-identical membership and order to the unsharded sweeps."""
    plan = _plan(specs, tech, memcells, mesh, mode, config, device)
    extract = functools.partial(_sharded_extract, mode=resolve_mode(mode),
                                mesh=plan.placement.mesh)
    return [BatchedSweep(lattice=lat, tables=tab, ppa=T,
                         device=plan.placement.device, extract_mask=extract)
            for lat, tab, T in E.execute(plan)]


# ---------------------------------------------------------------------------
# Deterministic 100+-spec sweep requests
# ---------------------------------------------------------------------------

#: Perturbation lattice for spec variants: deployment-posture knobs that keep
#: the macro geometry (and hence the spec group) fixed.
_VARIANT_F_MAC = (250e6, 400e6, 600e6, 800e6, 1.0e9, 1.1e9)
_VARIANT_VDD = (0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
_VARIANT_MCR = (1, 2, 4)

#: Reachable (f_mac, f_wupdate, vdd, mcr) keys: f_wupdate is clamped to
#: min(f_mac, draw), so an f_mac at ascending rank i admits i+1 distinct
#: f_wupdate values — NOT |F_MAC|^2 pairs.  Past this count the generator
#: must allow duplicates or it would spin forever.
_N_REACHABLE = (sum(i + 1 for i in range(len(_VARIANT_F_MAC)))
                * len(_VARIANT_VDD) * len(_VARIANT_MCR))


def spec_variants(n: int, base: MacroSpec | None = None,
                  seed: int = 0) -> list[MacroSpec]:
    """``n`` deterministic macro-spec variants of ``base`` (default: the §I
    vision scenario) — the shape of a real 100+-spec co-synthesis request.

    Variants perturb deployment posture (clock, update rate, voltage, MCR)
    while sharing the base geometry, so they all land in one spec group and
    exercise the sharded spec axis rather than the grouping.  Seeded, and
    duplicate-free in (f_mac, f_wupdate, vdd, mcr) until the reachable
    posture lattice is exhausted (``n`` beyond that repeats postures), so
    sweeps are reproducible across runs and equal to the JAX package's."""
    if base is None:
        base = MS.scenario_specs()["vision"]
    rng = np.random.default_rng(seed)
    out: list[MacroSpec] = []
    seen: set[tuple] = set()
    while len(out) < n:
        f_mac = float(rng.choice(_VARIANT_F_MAC))
        f_wup = float(min(f_mac, rng.choice(_VARIANT_F_MAC)))
        vdd = float(rng.choice(_VARIANT_VDD))
        mcr = int(rng.choice(_VARIANT_MCR))
        key = (f_mac, f_wup, vdd, mcr)
        if key in seen and len(seen) < _N_REACHABLE:
            continue
        seen.add(key)
        out.append(dataclasses.replace(base, f_mac_hz=f_mac,
                                       f_wupdate_hz=f_wup, vdd=vdd, mcr=mcr))
    return out
