"""Spec canonicalization and content-addressed cache keys.

A synthesis result is fully determined by four ingredients: the macro spec,
the calibrated tech model, the enumerated lattice shape (the registered axis
set, :mod:`repro_torch.core.axes`), and the search configuration (preference-grid
resolution, Pareto eps band).  This module turns each ingredient into a
deterministic canonical form and hashes them into the content address the
:class:`repro_torch.service.cache.FrontierCache` stores frontiers under:

  :func:`spec_key`          sha256 of the canonical ``MacroSpec`` encoding —
                            two structurally equal specs (however they were
                            constructed) share one key;
  :func:`axis_signatures`   one sha256 per registered sliceable axis plus a
                            ``"__global__"`` digest (see below) — the unit of
                            scoped cache invalidation;
  :func:`lattice_signature` sha256 over the per-axis signature map — a
                            recalibrated tech or a changed axis set can never
                            alias a cached frontier;
  :func:`cache_key`         the composite ``(spec_key, lattice signature,
                            resolution, PARETO_EPS)`` address of one search
                            frontier;
  :func:`sweep_key` /       the addresses of one exhaustive sweep frontier
  :func:`slice_key`         and of one per-axis-value *slice* frontier — the
                            incremental re-synthesis units.

Per-axis cache-invalidation semantics
-------------------------------------

Each sliceable axis (:data:`repro_torch.core.axes.SLICEABLE_AXES`) signs exactly
the inputs that can change *its own* per-value PPA contributions: the axis's
value list and the tech-model fields attributed to those values
(:data:`repro_torch.core.axes.MEMCELL_TECH_FIELDS` /
:data:`~repro_torch.core.axes.MULTMUX_TECH_FIELDS`).  Every tech field *not*
attributed to a single axis — wordline drivers, sense amps, adder-tree cells,
OFU/alignment constants, the shared mux — lands in the ``"__global__"``
digest, because a change there moves every lattice point.

A *slice* key (axis ``A`` restricted to one value ``v``) hashes ``v``'s own
value digest together with the full digests of every OTHER axis and the
global digest — but NOT the rest of ``A``'s values.  Consequences, which
:class:`repro_torch.service.service.SynthesisService` exploits for incremental
re-synthesis:

  * recalibrating a field scoped to one value of ``A`` (say the 6T cell
    area) invalidates exactly the ``A=SRAM_6T`` slice — every other
    ``A``-slice key is unchanged and still hits;
  * growing axis ``A`` by a value leaves all existing ``A``-slices valid
    (their keys never covered ``A``'s sibling values) — only the new value's
    slice is evaluated;
  * both changes invalidate every *other* axis's slices and the full-sweep
    key (their digests cover ``A`` as a whole), so nothing stale can ever be
    served — the degradation is re-derivation cost, never correctness.

Canonical encodings are JSON with sorted keys and no NaN/Inf; Python's float
repr round-trips IEEE-754 doubles exactly, so equal float fields hash
equally and nothing is quantized.  Everything here is numpy/json-only — key
computation never touches jax.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Sequence

from ..core.axes import (MEMCELL_TECH_FIELDS, MULTMUX_TECH_FIELDS,
                         SCOPED_TECH_FIELDS, LatticeConfig, seed_config)
from ..core.macro import MacroSpec
from ..core.pareto import PARETO_EPS
from ..core.subcircuits import MemCellKind
from ..core.tech import TechModel


def _digest(obj) -> str:
    """sha256 hex digest of the canonical JSON encoding of ``obj``."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)
    return hashlib.sha256(blob.encode()).hexdigest()


def canonical_spec(spec: MacroSpec) -> dict:
    """The canonical plain-data encoding of a spec: every dataclass field,
    container types normalized (tuples as lists, precisions in declaration
    order — order is semantic: it defines the mode list)."""
    out = dataclasses.asdict(spec)
    out["int_precisions"] = [int(b) for b in spec.int_precisions]
    out["fp_precisions"] = [str(f) for f in spec.fp_precisions]
    return out


def spec_key(spec: MacroSpec) -> str:
    """Deterministic content hash of a spec — the per-request half of the
    cache address."""
    return _digest(canonical_spec(spec))


def canonical_tech(tech: TechModel) -> dict:
    """Every calibration knob and relative constant of the tech model."""
    return {k: (float(v) if isinstance(v, float) else v)
            for k, v in dataclasses.asdict(tech).items()}


def _normalize_config(memcells: Sequence[MemCellKind] | None,
                      config: LatticeConfig | None) -> LatticeConfig:
    if config is None:
        return seed_config(tuple(memcells) if memcells is not None else None)
    if memcells is not None:
        return config.with_memcells(tuple(memcells))
    return config


def axis_value_payloads(tech: TechModel,
                        config: LatticeConfig | None = None
                        ) -> dict[str, list[dict]]:
    """Canonical per-value payload of every sliceable axis the config
    enables: the value identity plus the tech fields scoped to it.  This is
    what a single axis value's PPA table contribution depends on besides the
    spec and the global tech digest."""
    config = _normalize_config(None, config)
    techd = canonical_tech(tech)
    out: dict[str, list[dict]] = {
        "memcell": [{"value": m.value,
                     "tech": {f: techd[f] for f in MEMCELL_TECH_FIELDS[m]}}
                    for m in config.memcells],
        "multmux": [{"value": v.value,
                     "tech": {f: techd[f] for f in MULTMUX_TECH_FIELDS[v]
                              if f in SCOPED_TECH_FIELDS}}
                    for v in config.multmuxes],
        "rho": [{"value": float(r)} for r in config.rho_steps],
        "pipe": [{"value": int(p)} for p in config.pipe_steps],
    }
    if config.precision_modes:
        # The plan *recipe* per mode index is deterministic given the spec,
        # and the spec is hashed separately in every composite key.
        out["precision"] = [{"value": i}
                            for i in range(config.precision_modes)]
    if config.approx_cells:
        out["approx_cell"] = [{"name": c.name, "k_delay": float(c.k_delay),
                               "k_energy": float(c.k_energy),
                               "k_area": float(c.k_area)}
                              for c in config.approx_cells]
    return out


def axis_signatures(tech: TechModel,
                    config: LatticeConfig | None = None) -> dict[str, str]:
    """One content digest per sliceable axis (its value-payload list) plus
    the ``"__global__"`` digest of every tech field not scoped to a single
    axis — the complete invalidation map of a lattice (see the module
    docstring for the semantics)."""
    sigs = {axis: _digest(payloads)
            for axis, payloads in axis_value_payloads(tech, config).items()}
    techd = canonical_tech(tech)
    sigs["__global__"] = _digest({k: v for k, v in techd.items()
                                  if k not in SCOPED_TECH_FIELDS})
    return sigs


def lattice_signature(tech: TechModel,
                      memcells: Sequence[MemCellKind] | None = None,
                      config: LatticeConfig | None = None) -> str:
    """Content hash of everything the enumerated design lattice and its PPA
    tables depend on besides the spec: the digest of the per-axis signature
    map, so it changes exactly when some :func:`axis_signatures` entry
    does."""
    return _digest(axis_signatures(tech, _normalize_config(memcells, config)))


def cache_key(spec: MacroSpec, tech: TechModel,
              memcells: Sequence[MemCellKind] | None = None,
              resolution: int = 4, eps: float = PARETO_EPS,
              config: LatticeConfig | None = None) -> str:
    """The content address of one synthesized search frontier:
    ``(spec_key, lattice signature, resolution, eps)`` hashed together."""
    return _digest({
        "spec": spec_key(spec),
        "lattice": lattice_signature(tech, memcells, config),
        "resolution": int(resolution),
        "pareto_eps": float(eps),
    })


def key_scope(tech: TechModel, config: LatticeConfig | None = None,
              axis: str | None = None,
              value_index: int | None = None) -> dict[str, str]:
    """The invalidation scope of one cache entry: every named content digest
    the entry depends on, published alongside its shared-registry copy
    (:meth:`repro_torch.service.registry.ArtifactRegistry.publish`).

    Without ``axis``, the scope of a full search/sweep entry: one
    ``axis:<name>`` digest per sliceable axis, the ``__global__`` tech
    digest, and the composite ``lattice`` signature (so eviction can also be
    scoped by :func:`lattice_signature` alone).  With ``axis``/
    ``value_index``, the scope of one per-axis-value *slice* entry: the
    value's OWN payload digest (``value:<axis>``) plus every OTHER axis's
    digest and the global digest — exactly the ingredients
    :func:`slice_key` hashes, so an entry is evicted iff its key became
    unreachable."""
    config = _normalize_config(None, config)
    sigs = axis_signatures(tech, config)

    def named(a: str) -> str:
        return a if a == "__global__" else f"axis:{a}"

    if axis is None:
        scope = {named(a): s for a, s in sigs.items()}
        scope["lattice"] = _digest(sigs)       # == lattice_signature
        return scope
    payloads = axis_value_payloads(tech, config)
    if axis not in payloads:
        raise KeyError(f"axis {axis!r} is not sliceable under this config "
                       f"(have {sorted(payloads)})")
    values = payloads[axis]
    if value_index is None or not 0 <= value_index < len(values):
        raise IndexError(f"axis {axis!r} has {len(values)} values; "
                         f"got index {value_index}")
    scope = {named(a): s for a, s in sigs.items() if a != axis}
    scope[f"value:{axis}"] = _digest(values[value_index])
    return scope


def stale_digests(old_tech: TechModel, new_tech: TechModel,
                  config: LatticeConfig | None = None,
                  new_config: LatticeConfig | None = None) -> set[str]:
    """The content digests a recalibration (or axis-set change) retired:
    every digest that appears in some entry's :func:`key_scope` under the
    OLD (tech, config) but no longer holds under the new one.  Feeding this
    set to :meth:`repro_torch.service.registry.ArtifactRegistry.
    invalidate_digests` evicts exactly the entries whose cache keys became
    unreachable — a change scoped to one axis value keeps every other value's
    slice entries warm, fleet-wide.

    Digest classes compared: per-axis signatures (retired when the axis's
    value-payload list changed), per-value payload digests (retired when the
    value's own payload no longer appears anywhere on the axis — growth and
    reordering keep surviving values' slice entries warm, since
    :func:`slice_key` hashes payloads, not positions), the ``__global__``
    tech digest, and the composite lattice signature."""
    old_config = _normalize_config(None, config)
    new_cfg = old_config if new_config is None else new_config
    old_sigs = axis_signatures(old_tech, old_config)
    new_sigs = axis_signatures(new_tech, new_cfg)
    stale = {d for a, d in old_sigs.items() if new_sigs.get(a) != d}
    if old_sigs != new_sigs:
        stale.add(_digest(old_sigs))           # the old lattice_signature
    old_payloads = axis_value_payloads(old_tech, old_config)
    new_payloads = axis_value_payloads(new_tech, new_cfg)
    for axis, values in old_payloads.items():
        new_values = new_payloads.get(axis, [])
        for payload in values:
            if payload not in new_values:
                stale.add(_digest(payload))
    return stale


def sweep_key(spec: MacroSpec, tech: TechModel,
              config: LatticeConfig | None = None,
              eps: float = PARETO_EPS) -> str:
    """The content address of one exhaustive-sweep frontier (no preference
    resolution — a sweep covers the whole lattice)."""
    return _digest({
        "kind": "sweep",
        "spec": spec_key(spec),
        "axes": axis_signatures(tech, config),
        "pareto_eps": float(eps),
    })


def slice_key(spec: MacroSpec, tech: TechModel, axis: str, value_index: int,
              config: LatticeConfig | None = None,
              eps: float = PARETO_EPS) -> str:
    """The content address of one per-axis-value slice frontier: the sweep
    of the sublattice where ``axis`` is pinned to its ``value_index``-th
    value.  Hashes the value's OWN payload digest plus every OTHER axis's
    digest and the global digest — deliberately not the rest of ``axis``'s
    values, which is what keeps unchanged slices warm across a scoped
    recalibration or an axis growth (module docstring)."""
    config = _normalize_config(None, config)
    payloads = axis_value_payloads(tech, config)
    if axis not in payloads:
        raise KeyError(f"axis {axis!r} is not sliceable under this config "
                       f"(have {sorted(payloads)})")
    values = payloads[axis]
    if not 0 <= value_index < len(values):
        raise IndexError(f"axis {axis!r} has {len(values)} values; "
                         f"got index {value_index}")
    sigs = axis_signatures(tech, config)
    return _digest({
        "kind": "slice",
        "spec": spec_key(spec),
        "axis": axis,
        "value": _digest(values[value_index]),
        "others": {a: s for a, s in sigs.items() if a != axis},
        "pareto_eps": float(eps),
    })
