"""Batched design-space evaluation engine (vectorized Algorithm 1), in torch.

The scalar compiler path (:mod:`repro_torch.core.searcher`) evaluates one preference
point at a time, re-running the full subcircuit characterization on every
candidate it probes.  This module evaluates the *entire* discrete macro design
space in one fused pass instead:

  ``SpecTables``
      per-spec subcircuit characterization, factored along the lattice axes —
      the CSA family (rho x reorder x retimed x split), the mult/mux variants,
      the OFU pipeline depths, plus the spec-constant blocks (WL/BL drivers,
      S&A, alignment).  Every table entry is produced by the *same* scalar
      model functions the reference path uses, so the two paths share one
      ground truth.

  ``DesignLattice``
      structure-of-arrays enumeration of the discrete design space
      (memcell x mult/mux x CSA x OFU pipe x retiming/fusion flags), with a
      mixed-radix ``index_of`` so searches address points in O(1).

  ``evaluate``
      the PPA roll-up and timing-path checks of :mod:`repro_torch.core.macro`
      reimplemented as vectorized float64 torch over the whole lattice, on
      the device the caller names.  Term
      gathering and accumulation mirror the scalar arithmetic operation for
      operation, so results are bit-identical to :func:`repro_torch.core.macro.rollup`.

  ``mso_search_batched``
      Algorithm 1 (steps 1-4) layered on top as masked first-feasible
      selection over the batched tensors: the tt1→tt3 critical-path walk, the
      tt4/tt5 OFU walk, register fusion, and the ft1-ft3 preference
      fine-tuning all become per-preference gathers into the precomputed
      timing arrays.  The returned frontier is identical to the scalar
      :func:`repro_torch.core.searcher.mso_search`.

  ``design_space_sweep`` / ``pareto_mask``
      exhaustive sweeps with chunked vectorized Pareto extraction — the entry
      point the JAX package's ``repro.core.dse`` uses for many-workload
      co-design.

Execution (packing, kernel launch, numpy tail) and frontier extraction are
routed through the shared engine layer (:mod:`repro_torch.core.engine`):
this module is the single-spec ``"jit"`` strategy,
:mod:`repro_torch.core.multispec` the ``"vmap"`` strategy.

Bit-identity with the scalar roll-up rests on four rules, kept in
:func:`_eval_kernel` and its callers: every tensor is created as float64
explicitly; each step is one eager single-op torch call (exact IEEE float64
on CPU and on CUDA; no ``addcmul``, ``lerp`` or ``torch.compile``, which
would fuse a multiply into an add); gather indices are int64 on the device;
and no division runs on the device (CUDA's ``tensor / scalar`` multiplies by
the reciprocal), which is why :func:`_finish` stays in numpy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np

import torch

from ..device import resolve_device
from . import subcircuits as sc
from .axes import (LatticeConfig, PrecisionPlan, ResolvedAxis, dims_of,
                   resolve_axes, seed_config, strides_of)
from .csa import CSADesign, CSAReport, characterize
from .macro import (ACT_IN_MEAS, ACT_WT_MEAS, MacroDesign, MacroPPA,
                    MacroSpec, PathReport, _mode_bits, _product_bits,
                    reporting_frequency)
from .pareto import (PARETO_EPS, chunk_dominated, nondominated_mask,
                     pareto_chunk_size, preference_grid)
from .searcher import SearchResult, _throughput_overdrive, max_crit_rel
from .tech import TechModel, delay_scale, energy_scale, leakage_scale

# CSA characterization is pure in (design, rows, product_bits, tech); memoize
# it so multi-spec table builds sharing an H re-use one family characterization
# instead of re-walking the analytical model per spec.
_characterize = functools.lru_cache(maxsize=None)(characterize)

MEMCELLS: tuple[sc.MemCellKind, ...] = tuple(sc.MemCellKind)
MULTMUXES: tuple[sc.MultMuxKind, ...] = tuple(sc.MultMuxKind)
BOOLS: tuple[bool, bool] = (False, True)

_MM_INDEX = {k: i for i, k in enumerate(MULTMUXES)}


# ---------------------------------------------------------------------------
# Per-spec subcircuit tables
# ---------------------------------------------------------------------------


class SpecTables:
    """Subcircuit PPA factored along the *registered* lattice axes for one
    spec (:mod:`repro_torch.core.axes`).

    All entries come from the scalar model functions (``characterize``,
    ``multmux_ppa``, ``ofu_ppa``, ...) with exactly the arguments the scalar
    roll-up would pass, and the derived per-term constants reproduce the
    scalar accumulation expressions float-for-float.

    Axis-dependent tables are flattened so the device kernel needs no new
    gathers when an optional axis is enabled:

      * CSA tables are ``approx_cell``-major: flat index
        ``csa_index(rho_i, ro, rt, sp_i, apx_i) = apx_i*n_csa_base + base``;
        with the approx axis disabled ``n_apx == 1`` and the layout is the
        seed layout bit-for-bit.
      * OFU tables are ``precision``-plan-major: flat index
        ``ofu_index(pipe_i, prec_i) = prec_i*n_pipe + pipe_i``; with the
        precision axis disabled ``n_prec == 1`` — the seed layout.
      * Alignment-unit area/energy become per-plan vectors gathered by the
        precision coordinate (a single seed entry when disabled).
    """

    def __init__(self, spec: MacroSpec, tech: TechModel,
                 config: LatticeConfig | None = None,
                 axes: tuple[ResolvedAxis, ...] | None = None):
        self.spec = spec
        self.tech = tech
        self.config = config if config is not None else seed_config()
        self.axes = axes if axes is not None else resolve_axes(spec,
                                                               self.config)
        by_name = {a.name: a for a in self.axes}
        self.memcells: tuple[sc.MemCellKind, ...] = by_name["memcell"].values
        self.multmuxes: tuple[sc.MultMuxKind, ...] = by_name["multmux"].values
        self.rho_steps: tuple[float, ...] = by_name["rho"].values
        self.splits: tuple[int, ...] = by_name["split"].values
        self.pipe_steps: tuple[int, ...] = by_name["pipe"].values
        prec_ax = by_name.get("precision")
        apx_ax = by_name.get("approx_cell")
        # Effective values when the axis is disabled: one seed entry, so the
        # flattened tables reduce to the seed layout.
        self.plans: tuple[PrecisionPlan, ...] = (
            prec_ax.values if prec_ax is not None
            else (PrecisionPlan(tuple(spec.int_precisions),
                                tuple(spec.fp_precisions)),))
        self.approx_cells: tuple[sc.ApproxCellSpec, ...] = (
            apx_ax.values if apx_ax is not None else (sc.EXACT_CELL,))
        self.n_rho = len(self.rho_steps)
        self.n_sp = len(self.splits)
        self.n_pipe = len(self.pipe_steps)
        self.n_prec = len(self.plans)
        self.n_apx = len(self.approx_cells)
        self.n_csa_base = self.n_rho * 2 * 2 * self.n_sp

        # --- CSA family axis (approx_cell x rho x reorder x retimed x split) -
        self.csa_designs: list[CSADesign] = []
        self.csa_reports: list[CSAReport] = []
        for cell in self.approx_cells:
            for rho in self.rho_steps:
                for ro in BOOLS:
                    for rt in BOOLS:
                        for sp in self.splits:
                            d = CSADesign(rho=rho, reorder=ro, retimed=rt,
                                          split=sp)
                            self.csa_designs.append(d)
                            self.csa_reports.append(sc.approx_tree_report(
                                _characterize(d, spec.h, _product_bits(spec),
                                              tech), cell))
        self.csa_crit = np.array([r.crit_path_rel for r in self.csa_reports])
        self.csa_energy = np.array([r.energy_rel for r in self.csa_reports])
        self.csa_area = np.array([r.area_um2 for r in self.csa_reports])
        self.csa_lat = np.array([r.latency_cycles for r in self.csa_reports])
        self.acc_width = self.csa_reports[0].acc_width
        self.out_w = self.acc_width + spec.max_input_bits

        # --- mult/mux axis ---------------------------------------------------
        self.mm_valid = np.array([sc.multmux_valid(k, spec.mcr)
                                  for k in self.multmuxes])
        mm_ppa = [sc.multmux_ppa(k, spec.mcr, tech) if v else None
                  for k, v in zip(self.multmuxes, self.mm_valid)]
        nanppa = sc.PPA(float("nan"), float("nan"), float("nan"))
        self.mm_ppa = [p if p is not None else nanppa for p in mm_ppa]

        # --- memcell axis (area only: timing/energy use the array drivers) --
        self.cell_area = np.array([sc.memcell_ppa(k, tech).area_um2
                                   for k in self.memcells])

        # --- OFU pipeline x precision-plan axes ------------------------------
        self.ofu_ppa = [sc.ofu_ppa(spec.w, plan.ints, self.out_w, ps, tech)
                        for plan in self.plans for ps in self.pipe_steps]

        # --- spec-constant subcircuits ---------------------------------------
        self.wl = sc.wl_driver_ppa(spec.h, spec.w, spec.mcr, tech)
        self.bl = sc.bl_driver_ppa(spec.h, spec.w, spec.mcr, tech)
        # _mode_energy_rel uses base-unit BL constants (rel consts only):
        self.bl_base = sc.bl_driver_ppa(spec.h, spec.w, spec.mcr, TechModel())
        self.sa = sc.shift_adder_ppa(self.acc_width, spec.max_input_bits, tech)
        # Alignment unit per precision plan (plan 0 == the spec's own FP set).
        self.align_t = [sc.align_ppa(spec.w, plan.fps, tech)
                        for plan in self.plans]
        self.align = self.align_t[0]

        self.modes = ["int_lo", "int_hi"] + list(spec.fp_precisions)
        self._build_terms()

    def csa_index(self, rho_i, ro, rt, sp_i, apx_i=0):
        """Flat index into the CSA tables (vectorized-friendly)."""
        base = ((np.asarray(rho_i) * 2 + np.asarray(ro)) * 2
                + np.asarray(rt)) * self.n_sp + np.asarray(sp_i)
        return np.asarray(apx_i) * self.n_csa_base + base

    def ofu_index(self, pipe_i, prec_i=0):
        """Flat index into the OFU tables (vectorized-friendly)."""
        return np.asarray(prec_i) * self.n_pipe + np.asarray(pipe_i)

    def compatible_with(self, lattice: "DesignLattice") -> bool:
        """Whether this table set can serve gathers for ``lattice`` — the
        lattice's axis values must prefix-match the table axes (the seed
        service path enumerates a memcell subset against full tables)."""
        mine = {a.name: a.values for a in self.axes}
        for ax in lattice.axes:
            vals = mine.get(ax.name)
            if vals is None or vals[:len(ax.values)] != tuple(ax.values):
                return False
        return True

    # -- per-term constants mirroring the scalar accumulation expressions ----
    def _build_terms(self) -> None:
        spec, tech = self.spec, self.tech
        act_in, act_wt = ACT_IN_MEAS, ACT_WT_MEAS

        # timing: scalar mac path is (wl + mm) + tree
        self.t_wl_mm = np.array([self.wl.delay_rel + p.delay_rel
                                 for p in self.mm_ppa])
        self.t_ofu = np.array([p.delay_rel for p in self.ofu_ppa])
        self.t_sa = self.sa.delay_rel

        # area: scalar breakdown entries in roll-up order
        n_cells = spec.h * spec.w * spec.mcr
        self.a_array = np.array([n_cells * a for a in self.cell_area])
        self.a_mult = np.array([spec.h * spec.w * p.area_um2
                                for p in self.mm_ppa])
        self.a_tree = np.array([a * spec.w for a in self.csa_area])
        self.a_sa = self.sa.area_um2 * spec.w
        self.a_ofu = np.array([p.area_um2 for p in self.ofu_ppa])
        self.a_align_t = np.array([p.area_um2 for p in self.align_t])
        self.a_align = float(self.a_align_t[0])
        self.a_drv = self.wl.area_um2 + self.bl.area_um2

        # energy: term tables per _mode_energy_rel accumulation step
        self.e_wl = self.wl.energy_rel * act_in
        self.e_mm = np.array([spec.h * spec.w * p.energy_rel * act_in * act_wt
                              for p in self.mm_ppa])
        tree_act = min(1.0, act_in * act_wt + 0.02)
        self.e_tree = np.array([(e * spec.w) * tree_act
                                for e in self.csa_energy])
        self.e_sa = (self.sa.energy_rel * spec.w) * 0.55
        duty = (min(1.0, spec.f_wupdate_hz / max(spec.f_mac_hz, 1.0))
                * 1.0 / (spec.h * spec.mcr))
        self.e_bl = (self.bl_base.energy_rel / (spec.h * spec.mcr)) * duty
        self.e_ofu: dict[str, np.ndarray] = {}
        self.e_align: dict[str, np.ndarray] = {}
        for m in self.modes:
            ib = _mode_bits(spec, m)
            self.e_ofu[m] = np.array([p.energy_rel * (0.5 / max(1, ib))
                                      for p in self.ofu_ppa])
            per_plan = []
            for plan, align in zip(self.plans, self.align_t):
                if m in sc.FP_FORMATS:
                    exp, man = sc.FP_FORMATS[m]
                    emax = max(sc.FP_FORMATS[f][0] for f in plan.fps)
                    mmax = max(sc.FP_FORMATS[f][1] for f in plan.fps)
                    frac = (exp + 0.5 * man) / (emax + 0.5 * mmax)
                    per_plan.append(align.energy_rel * 0.62 * frac)
                else:
                    per_plan.append(align.energy_rel * 0.04)
            self.e_align[m] = np.array(per_plan)

        # latency components (ints)
        self.l_csa = self.csa_lat
        self.l_sa = self.sa.latency_cycles
        self.l_ofu = np.array([p.latency_cycles for p in self.ofu_ppa])


# ---------------------------------------------------------------------------
# Design lattice (structure-of-arrays)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class DesignLattice:
    """Flattened enumeration of the discrete macro design space.

    The lattice is a composition of the *registered* axes
    (:mod:`repro_torch.core.axes`): dims, strides, the mixed-radix flat-index
    round-trip, per-point validity and the materialized ``MacroDesign`` are
    all derived from the resolved axis tuple.  The seed ten axes keep their
    historical coordinate attributes (``mem_i`` ... ``fso``); optional axes
    (``precision``, ``approx_cell``) append after them, so seed flat indices
    — and any caller passing only the leading coordinates to
    :meth:`index_of` — are unchanged (missing trailing coordinates address
    the axis default, index 0).
    """

    spec: MacroSpec
    config: LatticeConfig
    axes: tuple[ResolvedAxis, ...]
    coords: tuple[np.ndarray, ...]   # one flat coordinate array per axis
    valid: np.ndarray                # per-point validity (axis masks ANDed)
    # Satellite bugfix: dims/strides used to be properties recomputed on
    # every index_of call (hot in the oracle harness) — now computed once
    # at construction.
    dims: tuple[int, ...]
    strides: tuple[int, ...]

    @classmethod
    def enumerate(cls, spec: MacroSpec,
                  memcells: tuple[sc.MemCellKind, ...] | None = None,
                  config: LatticeConfig | None = None) -> "DesignLattice":
        if config is None:
            config = seed_config(memcells)
        elif memcells is not None:
            config = config.with_memcells(memcells)
        return cls.from_axes(spec, config, resolve_axes(spec, config))

    @classmethod
    def from_axes(cls, spec: MacroSpec, config: LatticeConfig,
                  axes: tuple[ResolvedAxis, ...]) -> "DesignLattice":
        dims = dims_of(axes)
        grids = np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")
        coords = []
        valid = None
        for ax, g in zip(axes, grids):
            c = g.ravel()
            if ax.validity is not None:
                v = np.asarray(ax.validity, dtype=bool)[c]
                valid = v if valid is None else (valid & v)
            coords.append(c.astype(bool) if ax.bool_coords else c)
        n = coords[0].shape[0] if coords else 0
        if valid is None:
            valid = np.ones(n, dtype=bool)
        return cls(spec=spec, config=config, axes=axes, coords=tuple(coords),
                   valid=valid, dims=dims, strides=strides_of(dims))

    def __len__(self) -> int:
        return self.coords[0].shape[0]

    # -- axis access ---------------------------------------------------------

    def axis(self, name: str) -> ResolvedAxis | None:
        for ax in self.axes:
            if ax.name == name:
                return ax
        return None

    def axis_pos(self, name: str) -> int:
        for k, ax in enumerate(self.axes):
            if ax.name == name:
                return k
        raise KeyError(name)

    def coord(self, name: str) -> np.ndarray | None:
        for ax, c in zip(self.axes, self.coords):
            if ax.name == name:
                return c
        return None

    def _coord_or_zeros(self, name: str) -> np.ndarray:
        c = self.coord(name)
        return c if c is not None else np.zeros(len(self), dtype=np.int64)

    # Historical coordinate attributes (seed axes; always present).
    @property
    def mem_i(self) -> np.ndarray:
        return self.coord("memcell")

    @property
    def mm_i(self) -> np.ndarray:
        return self.coord("multmux")

    @property
    def rho_i(self) -> np.ndarray:
        return self.coord("rho")

    @property
    def ro(self) -> np.ndarray:
        return self.coord("reorder")

    @property
    def rt(self) -> np.ndarray:
        return self.coord("retimed")

    @property
    def sp_i(self) -> np.ndarray:
        return self.coord("split")

    @property
    def pipe_i(self) -> np.ndarray:
        return self.coord("pipe")

    @property
    def ort(self) -> np.ndarray:
        return self.coord("ofu_retime")

    @property
    def fts(self) -> np.ndarray:
        return self.coord("fuse_tree_sa")

    @property
    def fso(self) -> np.ndarray:
        return self.coord("fuse_sa_ofu")

    # Optional-axis coordinates (zeros when the axis is disabled — the
    # seed design).
    @property
    def prec_i(self) -> np.ndarray:
        return self._coord_or_zeros("precision")

    @property
    def apx_i(self) -> np.ndarray:
        return self._coord_or_zeros("approx_cell")

    @property
    def memcells(self) -> tuple[sc.MemCellKind, ...]:
        return self.axis("memcell").values

    @property
    def splits(self) -> tuple[int, ...]:
        return self.axis("split").values

    def index_of(self, *coords):
        """Mixed-radix flat index — O(1) addressing for masked selection.
        Bool flags participate directly (False=0/True=1).  Callers may pass
        only the leading coordinates: missing trailing axes address index 0
        (their default value), so seed-axis call sites work unchanged on an
        extended lattice."""
        if len(coords) > len(self.strides):
            raise ValueError(f"got {len(coords)} coordinates for "
                             f"{len(self.strides)} axes")
        total = 0
        for c, s in zip(coords, self.strides):
            total = total + c * s
        return total

    def coords_of(self, i: int) -> tuple[int, ...]:
        """Inverse of :meth:`index_of` (per-axis coordinates of a point)."""
        return tuple(int((i // s) % n)
                     for s, n in zip(self.strides, self.dims))

    def design_at(self, i: int, audit: tuple[str, ...] = ()) -> MacroDesign:
        rho_ax = self.axis("rho")
        pipe_ax = self.axis("pipe")
        mm_ax = self.axis("multmux")
        csa = CSADesign(rho=rho_ax.values[self.rho_i[i]],
                        reorder=bool(self.ro[i]),
                        retimed=bool(self.rt[i]),
                        split=self.splits[self.sp_i[i]])
        kw = {}
        prec_ax = self.axis("precision")
        if prec_ax is not None and self.prec_i[i] != 0:
            plan = prec_ax.values[self.prec_i[i]]
            kw["ofu_precisions"] = plan.ints
            kw["align_fp"] = plan.fps
        apx_ax = self.axis("approx_cell")
        if apx_ax is not None:
            cell = apx_ax.values[self.apx_i[i]]
            if not cell.is_exact():
                kw["approx_cell"] = cell
        return MacroDesign(spec=self.spec,
                           memcell=self.memcells[self.mem_i[i]],
                           multmux=mm_ax.values[self.mm_i[i]], csa=csa,
                           ofu_pipe_stages=pipe_ax.values[self.pipe_i[i]],
                           ofu_retimed_into_sa=bool(self.ort[i]),
                           fuse_tree_sa=bool(self.fts[i]),
                           fuse_sa_ofu=bool(self.fso[i]), audit=audit,
                           **kw)

    def index_of_design(self, design: MacroDesign) -> int:
        """Flat index of the point that materializes ``design`` — the inverse
        of :meth:`design_at` up to the audit trail.  The incremental merge
        uses this to re-anchor cached slice-frontier points in the parent
        lattice's flat order (deterministic duplicate collapse).  Raises
        ``ValueError`` when a design coordinate is not on this lattice."""
        coords = []
        for ax in self.axes:
            if ax.name == "precision":
                if design.ofu_precisions is None and design.align_fp is None:
                    coords.append(0)
                    continue
                v = next((k for k, p in enumerate(ax.values)
                          if p.ints == design.ofu_precisions
                          and p.fps == design.align_fp), None)
                if v is None:
                    raise ValueError(f"precision plan "
                                     f"{design.ofu_precisions}/"
                                     f"{design.align_fp} not on this lattice")
                coords.append(v)
                continue
            if ax.name == "approx_cell":
                cell = design.approx_cell
                if cell is None:
                    v = next((k for k, c in enumerate(ax.values)
                              if c.is_exact()), None)
                else:
                    v = next((k for k, c in enumerate(ax.values)
                              if c == cell), None)
                if v is None:
                    raise ValueError(f"approx cell {cell!r} not on this "
                                     "lattice")
                coords.append(v)
                continue
            value = {
                "memcell": design.memcell,
                "multmux": design.multmux,
                "rho": design.csa.rho,
                "reorder": design.csa.reorder,
                "retimed": design.csa.retimed,
                "split": design.csa.split,
                "pipe": design.ofu_pipe_stages,
                "ofu_retime": design.ofu_retimed_into_sa,
                "fuse_tree_sa": design.fuse_tree_sa,
                "fuse_sa_ofu": design.fuse_sa_ofu,
            }[ax.name]
            try:
                coords.append(ax.values.index(value))
            except ValueError:
                raise ValueError(f"{ax.name} value {value!r} not on this "
                                 "lattice") from None
        return int(self.index_of(*coords))

    def sublattice(self, axis_name: str, value_indices: tuple[int, ...]
                   ) -> tuple["DesignLattice", np.ndarray]:
        """Restrict one axis to a subset of its values.

        Returns ``(sub, parent_flat)`` where ``sub`` is a proper product
        lattice over the restricted axis (evaluable by every strategy) and
        ``parent_flat[j]`` is the flat index of ``sub`` point ``j`` in this
        lattice.  This is the unit of incremental re-synthesis: when one
        axis's cache signature changes, only the invalidated value slices
        are re-evaluated and merged with the cached per-slice frontiers.
        """
        value_indices = tuple(int(v) for v in value_indices)
        pos = self.axis_pos(axis_name)
        src = self.axes[pos]
        if not value_indices or not all(0 <= v < src.size
                                        for v in value_indices):
            raise ValueError(f"bad value indices {value_indices} for axis "
                             f"{axis_name} of size {src.size}")
        sub_axis = ResolvedAxis(
            name=src.name,
            values=tuple(src.values[v] for v in value_indices),
            payloads=tuple(src.payloads[v] for v in value_indices),
            tech_fields=(tuple(src.tech_fields[v] for v in value_indices)
                         if src.tech_fields else ()),
            validity=(tuple(src.validity[v] for v in value_indices)
                      if src.validity is not None else None),
            bool_coords=src.bool_coords)
        axes = self.axes[:pos] + (sub_axis,) + self.axes[pos + 1:]
        sub = DesignLattice.from_axes(self.spec, self.config, axes)
        remap = np.asarray(value_indices, dtype=np.int64)
        parent_flat = np.zeros(len(sub), dtype=np.int64)
        for k, (st, c) in enumerate(zip(self.strides, sub.coords)):
            ci = remap[c.astype(np.int64)] if k == pos else c
            parent_flat = parent_flat + ci * st
        return sub, parent_flat


# ---------------------------------------------------------------------------
# Vectorized timing + PPA roll-up
# ---------------------------------------------------------------------------


@dataclass
class BatchedPPA:
    """Roll-up of the whole lattice as structure-of-arrays (float64)."""

    lattice: DesignLattice
    tables: SpecTables
    mac: np.ndarray
    sa: np.ndarray
    ofu: np.ndarray
    crit: np.ndarray
    fmax: np.ndarray
    meets: np.ndarray
    area: np.ndarray
    breakdown: dict[str, np.ndarray]
    e_cycle: dict[str, np.ndarray]
    latency: np.ndarray
    tops_1b: np.ndarray
    tops_w: dict[str, np.ndarray]
    tops_mm2: np.ndarray

    def materialize(self, i: int, audit: tuple[str, ...] = ()) -> MacroPPA:
        """Reconstruct the scalar MacroPPA view of lattice point ``i``."""
        design = self.lattice.design_at(i, audit)
        paths = PathReport(float(self.mac[i]), float(self.sa[i]),
                           float(self.ofu[i]), float(self.crit[i]))
        return MacroPPA(
            design=design, paths=paths, fmax_hz=float(self.fmax[i]),
            area_um2=float(self.area[i]),
            area_breakdown={k: float(v[i])
                            for k, v in self.breakdown.items()},
            e_cycle_fj={m: float(v[i]) for m, v in self.e_cycle.items()},
            latency_cycles=int(self.latency[i]),
            tops_1b=float(self.tops_1b[i]),
            tops_per_w_1b={m: float(v[i]) for m, v in self.tops_w.items()},
            tops_per_mm2_1b=float(self.tops_mm2[i]),
            meets_timing=bool(self.meets[i]),
            csa_report=self.tables.csa_reports[
                int(self.tables.csa_index(self.lattice.rho_i[i],
                                          self.lattice.ro[i],
                                          self.lattice.rt[i],
                                          self.lattice.sp_i[i],
                                          self.lattice.apx_i[i]))])


# Scalar constants packed into one f64 operand so every (spec, tech) change
# reaches the kernel as data, in one host-to-device copy per group.
_CONST_FIELDS = ("apr", "a_sa", "a_drv", "e_wl", "e_sa", "e_bl",
                 "eps_fj", "escale")


def _eval_kernel(idx, tabs, consts, e_ofu_m, e_align_m):
    """Fused gather + area + per-mode-energy roll-up over the lattice, in
    float64 on the operands' device, for a stack of S specs at once.

    ``idx`` holds the shared int64 gather indices (one lattice for the whole
    group); every table, constant and mode array carries a leading spec axis
    of S rows (the JAX package's ``vmap`` over specs, written out).  The
    kernel is elementwise per spec row, so a row computes exactly what a
    one-spec call would.

    Arithmetic mirrors macro.rollup operation for operation so results are
    bit-identical to the scalar reference path.  Each line is one eager torch
    op: gathers, additions of precomputed terms, and multiplies that never
    feed an add in the same op.  The timing fixup chain and every division
    run in numpy in :func:`_finish`.

    Axis-generic addressing: ``csa_j`` indexes the approx-cell-flattened CSA
    tables, ``ofu_j`` the precision-plan-flattened OFU tables, and ``prec_j``
    gathers the per-plan alignment-unit terms.  With the optional axes
    disabled these degenerate to the seed gathers (index 0 everywhere) and
    every gathered value equals the former scalar constant — bit-identical.
    """
    mem_i, mm_i, csa_j, ofu_j, prec_j = idx
    (t_wl_mm, csa_crit, t_ofu, a_array_t, a_mult_t, a_tree_t, a_ofu_t,
     a_align_t, e_mm_t, e_tree_t) = tabs
    # (S, 1) columns broadcast against the (S, n) gathered terms
    c = {k: consts[:, i:i + 1] for i, k in enumerate(_CONST_FIELDS)}

    # ---- raw timing components (the fixup chain runs in numpy) -------------
    mac_base = t_wl_mm[:, mm_i] + csa_crit[:, csa_j]
    ofu_base = t_ofu[:, ofu_j]

    # ---- area (accumulated in the scalar breakdown order) -------------------
    a_array = a_array_t[:, mem_i]
    a_mult = a_mult_t[:, mm_i]
    a_tree = a_tree_t[:, csa_j]
    a_ofu = a_ofu_t[:, ofu_j]
    a_align = a_align_t[:, prec_j]
    placed = a_array + a_mult
    placed = placed + a_tree
    placed = placed + c["a_sa"]
    placed = placed + a_ofu
    placed = placed + a_align
    placed = placed + c["a_drv"]
    area = placed * c["apr"]
    n = mm_i.shape[0]
    breakdown = {
        "sram_array": a_array, "multmux": a_mult, "adder_tree": a_tree,
        "shift_adder": c["a_sa"].expand(-1, n),
        "ofu": a_ofu,
        "align": a_align,
        "drivers": c["a_drv"].expand(-1, n),
    }

    # ---- per-cycle energy by mode (macro._mode_energy_rel order) ------------
    e_mm = e_mm_t[:, mm_i]
    e_tree = e_tree_t[:, csa_j]
    e_cycle = []
    for m in range(e_ofu_m.shape[1]):
        e = 0.0 + c["e_wl"]
        e = e + e_mm
        e = e + e_tree
        e = e + c["e_sa"]
        e = e + e_ofu_m[:, m, ofu_j]
        e = e + e_align_m[:, m, prec_j]
        e = e + c["e_bl"]
        e_cycle.append((e * c["eps_fj"]) * c["escale"])
    e_cycle = torch.stack(e_cycle, dim=1)                  # (S, M, n)

    return {"mac_base": mac_base, "ofu_base": ofu_base, "area": area,
            "breakdown": breakdown, "e_cycle": e_cycle}


def _kernel_inputs(tables: SpecTables
                   ) -> tuple[tuple[np.ndarray, ...], np.ndarray,
                              np.ndarray, np.ndarray]:
    """numpy-side operands for :func:`_eval_kernel`, in argument order
    (tabs, consts, e_ofu_m, e_align_m).  The engine stacks these along a
    leading spec axis, for one spec or a group."""
    spec, tech = tables.spec, tables.tech
    consts = np.array([
        tech.apr_overhead,
        tables.a_sa, tables.a_drv,
        tables.e_wl, tables.e_sa, tables.e_bl,
        tech.eps_fj,
        energy_scale(spec.vdd),
    ], dtype=np.float64)
    tabs = (tables.t_wl_mm, tables.csa_crit, tables.t_ofu,
            tables.a_array, tables.a_mult, tables.a_tree,
            tables.a_ofu, tables.a_align_t, tables.e_mm, tables.e_tree)
    e_ofu_m = np.stack([tables.e_ofu[m] for m in tables.modes])
    e_align_m = np.stack([tables.e_align[m] for m in tables.modes])
    return tabs, consts, e_ofu_m, e_align_m


def evaluate(lattice: DesignLattice, tables: SpecTables,
             device=None) -> BatchedPPA:
    """One fused pass on ``device``: timing paths + full PPA roll-up for
    every lattice point, mirroring :func:`repro_torch.core.macro.rollup`
    float-for-float.

    Routed through the shared execution engine's single-spec ``"jit"``
    strategy (:mod:`repro_torch.core.engine`), so this path packs, launches
    and finishes through exactly the code the multi-spec path uses."""
    from . import engine as E          # lazy: the engine imports this module
    (_, _, ppa), = E.execute(E.plan_for([lattice], [tables], mode="jit",
                                        device=device))
    return ppa


def _finish(lattice: DesignLattice, tables: SpecTables, csa_i: np.ndarray,
            ofu_j: np.ndarray, out: dict) -> BatchedPPA:
    """numpy tail of the roll-up, applied to one spec's kernel outputs."""
    spec, tech = tables.spec, tables.tech
    e_cycle = {m: out["e_cycle"][k] for k, m in enumerate(tables.modes)}
    # The timing fixup chain and throughput derivations run in numpy: their
    # multiply-add chains and constant divisors are FMA / reciprocal targets
    # on the device (CUDA divides a tensor by a scalar through its
    # reciprocal), which would perturb the last ulp vs the scalar reference.
    # numpy f64 executes op-for-op; the op count is tiny.
    ort, fts, fso = lattice.ort, lattice.fts, lattice.fso
    mac = out["mac_base"]
    sa_p = np.full(len(lattice), tables.t_sa)
    ofu_p = out["ofu_base"]
    moved = 0.3 * ofu_p
    ofu_p = np.where(ort, ofu_p - moved, ofu_p)
    sa_p = np.where(ort, sa_p + moved, sa_p)
    mac = np.where(fts, mac + sa_p, mac)
    sa_p = np.where(fts, 0.0, sa_p)
    sa_p = np.where(fso, sa_p + ofu_p, sa_p)
    ofu_p = np.where(fso, 0.0, ofu_p)
    crit = np.maximum(mac, np.maximum(sa_p, ofu_p))

    area = out["area"]
    dscale = delay_scale(spec.vdd, tech.vth, tech.alpha)
    fmax = 1e12 / ((crit * tech.tau_ps) * dscale)
    meets = fmax >= spec.f_mac_hz * 0.999
    f_rep = reporting_frequency(fmax, spec.f_mac_hz, meets)
    tops_1b = ((2.0 * spec.h * spec.w) * f_rep) / 1e12
    leak_mw = (area * tech.leak_mw_per_um2) * leakage_scale(spec.vdd)
    tops_w = {}
    for m, efj in e_cycle.items():
        p_mw = ((efj * 1e-15) * f_rep) * 1e3 + leak_mw
        tops_w[m] = np.where(p_mw > 0, tops_1b / (p_mw * 1e-3), np.inf)
    tops_mm2 = tops_1b / (area / 1e6)

    # latency is pure integer bookkeeping.
    ib = max(spec.int_precisions)
    pipe_lat = (tables.l_csa[csa_i] + tables.l_sa
                + tables.l_ofu[ofu_j]
                - lattice.fts.astype(np.int64)
                - lattice.fso.astype(np.int64))
    latency = ib + np.maximum(1, pipe_lat)

    return BatchedPPA(lattice=lattice, tables=tables, mac=mac,
                      sa=sa_p, ofu=ofu_p, crit=crit,
                      fmax=fmax, meets=meets, area=area,
                      # key-sorted, as the reference's jitted kernel returns
                      # it: the frontier artifact's bytes and the floorplan's
                      # ``sum`` over it follow this order.
                      breakdown=dict(sorted(out["breakdown"].items())),
                      e_cycle=e_cycle,
                      latency=latency, tops_1b=tops_1b, tops_w=tops_w,
                      tops_mm2=tops_mm2)


@functools.lru_cache(maxsize=32)
def _evaluated(spec: MacroSpec, tech: TechModel, config: LatticeConfig,
               device: str) -> tuple[DesignLattice, SpecTables, BatchedPPA]:
    """Characterize-once cache (the SCL-LUT philosophy): the evaluated
    lattice for a (spec, tech, config) triple is immutable and reused by
    every preference sweep and co-design query against it.  The device is
    part of the key, so a CPU result never answers a CUDA call."""
    lattice = DesignLattice.enumerate(spec, config=config)
    tables = SpecTables(spec, tech, config=config)
    return lattice, tables, evaluate(lattice, tables, device=device)


# ---------------------------------------------------------------------------
# Vectorized Pareto extraction
# ---------------------------------------------------------------------------


def pareto_mask(objs: np.ndarray, eps: float = PARETO_EPS,
                chunk: int = 512, device=None) -> np.ndarray:
    """Non-dominated mask over an (n, k) objective matrix (minimization),
    computed on ``device`` in chunks so lattice-sized sweeps stay in memory
    (size the chunk for the device with :func:`repro_torch.core.pareto.
    pareto_chunk_size`).  Dominance semantics match
    :func:`repro_torch.core.pareto.dominates` through the shared
    :data:`repro_torch.core.pareto.PARETO_EPS` band — near-tie objectives
    land on the same frontier in the scalar and batched paths by
    construction.  The verdicts stay on the device until the last chunk and
    come back to the host in one copy."""
    objs = np.asarray(objs, dtype=np.float64)
    n = objs.shape[0]
    if n == 0:
        return np.ones(0, dtype=bool)
    all_o = torch.as_tensor(objs, dtype=torch.float64,
                            device=resolve_device(device))
    dominated = torch.cat([chunk_dominated(all_o, all_o[s:s + chunk], eps)
                           for s in range(0, n, chunk)])
    return ~dominated.cpu().numpy()


# ---------------------------------------------------------------------------
# Exhaustive sweep
# ---------------------------------------------------------------------------


@dataclass
class BatchedSweep:
    """A fully evaluated design space for one spec."""

    lattice: DesignLattice
    tables: SpecTables
    ppa: BatchedPPA
    #: The device the lattice was evaluated on; frontier extraction runs its
    #: chunked mask there too.
    device: torch.device
    #: Optional survivor-mask override for frontier extraction.  Every mask
    #: implementation returns the same bits; only the wall-clock differs.
    extract_mask: Callable[[np.ndarray], np.ndarray] | None = None

    def objectives(self) -> np.ndarray:
        """(n, 3) frontier objectives — (energy/cycle INT-lo, area, period),
        the scalar searcher's ordering."""
        return np.stack([self.ppa.e_cycle["int_lo"], self.ppa.area,
                         1.0 / self.ppa.fmax], axis=1)

    def frontier_indices(self, feasible_only: bool = True,
                         chunk: int | None = None) -> list[int]:
        cand = np.flatnonzero(self.lattice.valid
                              & (self.ppa.meets if feasible_only else True))
        if cand.size == 0:
            cand = np.flatnonzero(self.lattice.valid)
        objs = self.objectives()[cand]
        mask_fn = self.extract_mask
        if mask_fn is None:
            if chunk is None:   # size for the device-memory budget
                chunk = pareto_chunk_size(len(objs), objs.shape[1])
            mask_fn = functools.partial(pareto_mask, chunk=chunk,
                                        device=self.device)
        from . import engine as E
        return [int(cand[i]) for i in E.extract_frontier(objs, mask_fn)]

    def materialize(self, i: int) -> MacroPPA:
        return self.ppa.materialize(i, audit=("batched: exhaustive sweep",))


def design_space_sweep(spec: MacroSpec, tech: TechModel,
                       memcells: tuple[sc.MemCellKind, ...] | None = None,
                       config: LatticeConfig | None = None,
                       device=None) -> BatchedSweep:
    """Evaluate every discrete design point for ``spec`` in one fused pass
    on ``device`` (``None``: the CUDA card)."""
    if config is None:
        config = seed_config(memcells)
    elif memcells is not None:
        config = config.with_memcells(memcells)
    dev = resolve_device(device)
    lattice, tables, ppa = _evaluated(spec, tech, config, str(dev))
    return BatchedSweep(lattice=lattice, tables=tables, ppa=ppa, device=dev)


# ---------------------------------------------------------------------------
# Algorithm 1 as masked selection over the batched tensors
# ---------------------------------------------------------------------------


def _first_feasible(values: np.ndarray, budget: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """For each row budget, index of the first chain entry meeting it; the
    last entry (UNMET) when none does.  values: (n_chain,) or (P, n_chain)."""
    if values.ndim == 1:
        ok = values[None, :] <= budget[:, None]
    else:
        ok = values <= budget[:, None]
    any_ok = ok.any(axis=1)
    idx = np.where(any_ok, ok.argmax(axis=1), ok.shape[1] - 1)
    return idx, any_ok


def mso_search_batched(spec: MacroSpec, scl=None, tech: TechModel = None,
                       resolution: int = 4,
                       config: LatticeConfig | None = None,
                       device=None) -> SearchResult:
    """Multi-spec sweep with the hierarchical search replayed as masked
    selection over the batched lattice tensors.  Frontier is identical to the
    scalar :func:`repro_torch.core.searcher.mso_search` (``scl`` is accepted
    for signature parity; the batched path reads the same models directly).
    The lattice is evaluated on ``device`` (``None``: the CUDA card).

    ``config`` may enable optional axes: the replay walks the seed axes with
    every optional coordinate pinned at its default (index 0), so the result
    stays identical to the scalar search while the evaluated lattice covers
    the extended space."""
    if tech is None:
        raise ValueError("tech model required")
    if config is None:
        config = seed_config((sc.MemCellKind.SRAM_6T,))
    else:
        config = config.with_memcells((sc.MemCellKind.SRAM_6T,))
    lattice, tables, T = _evaluated(spec, tech, config,
                                    str(resolve_device(device)))
    return _alg1_replay(lattice, tables, T, resolution)


def _alg1_replay(lattice: DesignLattice, tables: SpecTables, T: BatchedPPA,
                 resolution: int) -> SearchResult:
    """Algorithm 1 (steps 1-4) as masked first-feasible selection over an
    already-evaluated lattice.  Split out of :func:`mso_search_batched` so the
    multi-spec engine can run one fused evaluation for N specs and replay the
    hierarchy per spec against it."""
    spec, tech = tables.spec, tables.tech

    prefs = preference_grid(resolution)
    P = len(prefs)
    base_budget = max_crit_rel(spec, tech)
    budget = np.array([base_budget / _throughput_overdrive(p) for p in prefs])

    mm_tg = _MM_INDEX[sc.MultMuxKind.TG_NOR]
    zeros = np.zeros(P, dtype=np.int64)

    def gather(arr, mm_i, rho_i, ro, rt, sp_i, pipe_i, ort, fts, fso):
        idx = lattice.index_of(zeros, mm_i, rho_i, ro, rt, sp_i, pipe_i, ort,
                               fts, fso)
        return arr[idx]

    n_rho, n_pipe = tables.n_rho, tables.n_pipe

    # ---- step 2, MAC path: tt1 -> tt2 -> tt3 as a first-feasible chain -----
    # cumulative transform chain from the step-1 state
    chain: list[tuple[int, int, int, int]] = [(0, 0, 0, 0), (0, 1, 0, 0)]
    for ri in range(1, n_rho):
        chain.append((ri, 1, 0, 0))
    last_rho = n_rho - 1
    chain.append((last_rho, 1, 1, 0))
    for sp_i in range(1, len(tables.splits)):
        chain.append((last_rho, 1, 1, sp_i))
    chain_arr = np.array(chain, dtype=np.int64)
    mac_chain = np.array([
        T.mac[lattice.index_of(0, mm_tg, r, ro, rt, s, 0, 0, 0, 0)]
        for r, ro, rt, s in chain])
    pick, mac_ok = _first_feasible(mac_chain, budget)
    rho_i = chain_arr[pick, 0]
    ro = chain_arr[pick, 1]
    rt = chain_arr[pick, 2]
    sp_i = chain_arr[pick, 3]
    unmet_mac = ~mac_ok

    # tt1-relax: cheapest adder mix (highest rho) still meeting timing.
    mac_rho = np.stack([gather(T.mac, np.full(P, mm_tg), np.full(P, j), ro,
                               rt, sp_i, zeros, zeros, zeros, zeros)
                        for j in range(n_rho)], axis=1)
    elig = (np.arange(n_rho)[None, :] < rho_i[:, None]) \
        & (mac_rho <= budget[:, None])
    has_relax = elig.any(axis=1) & mac_ok
    rho_i = np.where(has_relax, elig.argmax(axis=1), rho_i)

    # ---- step 2, OFU path: tt4 -> tt5 as a first-feasible chain ------------
    ofu_states = [(0, 0), (1, 0)] + [(1, p) for p in range(1, n_pipe)]
    ofu_chain = np.array([
        max(T.ofu[lattice.index_of(0, mm_tg, 0, 0, 0, 0, p, o, 0, 0)],
            T.sa[lattice.index_of(0, mm_tg, 0, 0, 0, 0, p, o, 0, 0)])
        for o, p in ofu_states])
    opick, ofu_ok = _first_feasible(ofu_chain, budget)
    ostates = np.array(ofu_states, dtype=np.int64)
    ort = ostates[opick, 0]
    pipe = ostates[opick, 1]
    unmet_ofu = ~ofu_ok

    # ---- step 3: register fusion as masked selection -----------------------
    mm_cur = np.full(P, mm_tg, dtype=np.int64)
    ones = np.ones(P, dtype=np.int64)
    crit_full = gather(T.crit, mm_cur, rho_i, ro, rt, sp_i, pipe, ort, ones,
                       ones)
    crit_part = gather(T.crit, mm_cur, rho_i, ro, rt, sp_i, pipe, ort, zeros,
                       ones)
    full_ok = crit_full <= budget
    part_ok = crit_part <= budget
    fts = np.where(full_ok, 1, 0).astype(np.int64)
    fso = np.where(full_ok | part_ok, 1, 0).astype(np.int64)

    # ---- step 4: preference-oriented fine-tuning ---------------------------
    # preference masks evaluated with the scalar searcher's exact comparisons
    power_pref = np.array([p[0] >= max(p[1], p[2]) * 0.999 for p in prefs])
    area_any = np.array([p[1] > 0 for p in prefs])
    area_dom = np.array([p[1] > max(p[0], p[2]) for p in prefs])
    area_ge = np.array([p[1] >= max(p[0], p[2]) for p in prefs])
    area_ge_power = np.array([p[1] >= p[0] for p in prefs])

    def meets(mm_i_, rho_i_, ro_, rt_, sp_i_, pipe_, ort_, fts_, fso_):
        return gather(T.crit, mm_i_, rho_i_, ro_, rt_, sp_i_, pipe_, ort_,
                      fts_, fso_) <= budget

    # ft1 (power): rho back up, then un-split, then drop OFU pipe stages.
    crit_rho = np.stack([meets(mm_cur, np.full(P, j), ro, rt, sp_i, pipe, ort,
                               fts, fso)
                         for j in range(n_rho)], axis=1)
    elig = (np.arange(n_rho)[None, :] < rho_i[:, None]) & crit_rho
    take = elig.any(axis=1) & power_pref
    rho_i = np.where(take, elig.argmax(axis=1), rho_i)

    active = power_pref.copy()
    for _ in range(len(tables.splits) - 1):
        can = active & (sp_i > 0)
        ok = meets(mm_cur, rho_i, ro, rt, np.maximum(sp_i - 1, 0), pipe, ort,
                   fts, fso)
        apply_ = can & ok
        sp_i = np.where(apply_, sp_i - 1, sp_i)
        active = apply_     # a failed halving stops the walk

    active = power_pref.copy()
    for _ in range(n_pipe - 1):
        can = active & (pipe > 0)
        ok = meets(mm_cur, rho_i, ro, rt, sp_i, np.maximum(pipe - 1, 0), ort,
                   fts, fso)
        apply_ = can & ok
        pipe = np.where(apply_, pipe - 1, pipe)
        active = apply_

    # ft2 (area): OAI22 substitution (MCR permitting), 1T pass-gate mux,
    # un-split columns.
    if spec.mcr <= 2:
        mm_oai = _MM_INDEX[sc.MultMuxKind.OAI22_FUSED]
        ok = meets(np.full(P, mm_oai), rho_i, ro, rt, sp_i, pipe, ort, fts,
                   fso)
        apply_ = area_any & ok & area_ge_power
        mm_cur = np.where(apply_, mm_oai, mm_cur)
    mm_pass = _MM_INDEX[sc.MultMuxKind.PASS_1T]
    ok = meets(np.full(P, mm_pass), rho_i, ro, rt, sp_i, pipe, ort, fts, fso)
    apply_ = area_any & area_dom & (mm_cur != mm_pass) & ok
    mm_cur = np.where(apply_, mm_pass, mm_cur)

    active = area_any & area_ge
    for _ in range(len(tables.splits) - 1):
        can = active & (sp_i > 0)
        ok = meets(mm_cur, rho_i, ro, rt, np.maximum(sp_i - 1, 0), pipe, ort,
                   fts, fso)
        apply_ = can & ok
        sp_i = np.where(apply_, sp_i - 1, sp_i)
        active = apply_

    # ---- materialize + frontier (same dedup/pool/objectives as scalar) -----
    final_idx = lattice.index_of(zeros, mm_cur, rho_i, ro, rt, sp_i, pipe,
                                 ort, fts, fso)
    explored: list[MacroPPA] = []
    seen: set[str] = set()
    seen_idx: set[int] = set()
    for p in range(P):
        i = int(final_idx[p])
        if i in seen_idx:        # distinct lattice points can share a name;
            continue             # same point never needs re-materializing
        seen_idx.add(i)
        audit = ("batched: Alg. 1 replay",)
        if unmet_mac[p]:
            audit += ("tt: MAC path UNMET (exhausted techniques)",)
        if unmet_ofu[p]:
            audit += ("tt: OFU path UNMET (exhausted techniques)",)
        ppa = T.materialize(i, audit=audit)
        if ppa.design.name() not in seen:
            seen.add(ppa.design.name())
            explored.append(ppa)

    feasible = [p for p in explored if p.meets_timing]
    pool = feasible if feasible else explored
    objs = [(p.e_cycle_fj["int_lo"], p.area_um2, 1.0 / p.fmax_hz)
            for p in pool]
    # The shared frontier tail (mask + exact dedup/order) — identical to
    # pareto_indices(objs) on these small pools, and the same tail the
    # lattice-scale sweeps run with their device/sharded masks.
    from . import engine as E
    frontier = [pool[i] for i in E.extract_frontier(objs, nondominated_mask)]
    return SearchResult(spec=spec, frontier=tuple(frontier),
                        explored=tuple(explored), n_evaluated=len(explored))
