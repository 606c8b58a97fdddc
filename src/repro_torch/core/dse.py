"""System-level design-space exploration: mapping AI workloads onto arrays of
SynDCIM macros (the paper's §I framing — "system-level acceleration that DCIM
can offer", with distinct optimizations for vision / language / cloud /
wearable scenarios); the counterpart of the JAX package's
``repro/core/dse.py``.

Given a workload (the GEMM inventory of one of the assigned model
architectures) and a synthesized macro design point, this module computes the
accelerator-level throughput/energy/area of an N-macro array executing the
workload — the bridge between the paper's circuit compiler and the model
zoo.  All of it is float64 numpy on the host, op for op as the JAX package
computes it, so every report is bit-identical to the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

# reporting_frequency is defined next to rollup (which also applies it); the
# scalar and batched reports below clamp through that one definition so the
# two paths can never drift.
from .macro import MacroPPA, reporting_frequency
from .pareto import nondominated_mask_auto, pareto_indices


@dataclass(frozen=True)
class GemmShape:
    """One GEMM in a model: out[m, n] += a[m, k] @ w[k, n], executed
    ``count`` times per model step."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count


def gemm_inventory(cfg, seq: int = 256) -> list[GemmShape]:
    """Model-zoo GEMM inventory: the per-token-batch weight-side GEMMs of one
    decoder layer x n_layers for an assigned architecture config (attention
    score/value matmuls are activation-activation and stay outside the
    weight-stationary CIM mapping).  This is the workload description the
    co-design sweep and serving-time macro selection map onto macro arrays."""
    d, hd = cfg.d_model, cfg.hd
    gs = [
        GemmShape("wq", seq, d, cfg.n_heads * hd, cfg.n_layers),
        GemmShape("wk", seq, d, cfg.n_kv_heads * hd, cfg.n_layers),
        GemmShape("wv", seq, d, cfg.n_kv_heads * hd, cfg.n_layers),
        GemmShape("wo", seq, cfg.n_heads * hd, d, cfg.n_layers),
    ]
    if cfg.family == "moe":
        e_active = cfg.moe.top_k
        gs += [GemmShape("moe_up", seq, d, 2 * cfg.moe.d_expert,
                         cfg.n_layers * e_active),
               GemmShape("moe_down", seq, cfg.moe.d_expert, d,
                         cfg.n_layers * e_active)]
    else:
        gs += [GemmShape("mlp_up", seq, d, 2 * cfg.d_ff, cfg.n_layers),
               GemmShape("mlp_down", seq, cfg.d_ff, d, cfg.n_layers)]
    return gs


@dataclass(frozen=True)
class MappingReport:
    gemm: GemmShape
    tiles: int                 # weight tiles (k x n) across macro array
    passes: int                # sequential tile waves on n_macros
    cycles: int                # total macro cycles for the GEMM
    weight_reloads: int        # tile swaps requiring BL writes (MCR-aware)
    energy_pj: float
    util: float                # MAC-lane utilization


@dataclass(frozen=True)
class AcceleratorReport:
    macro: str
    n_macros: int
    ib: int
    wb: int
    reports: tuple[MappingReport, ...]
    total_cycles: int
    total_energy_pj: float
    wallclock_s: float
    effective_tops: float      # at the workload's real precision
    avg_util: float
    area_mm2: float

    def summary(self) -> dict:
        return {
            "macro": self.macro,
            "n_macros": self.n_macros,
            "precision": f"INT{self.ib}xINT{self.wb}",
            "total_cycles": self.total_cycles,
            "energy_uj": round(self.total_energy_pj / 1e6, 3),
            "wallclock_ms": round(self.wallclock_s * 1e3, 4),
            "effective_tops": round(self.effective_tops, 4),
            "avg_util": round(self.avg_util, 4),
            "area_mm2": round(self.area_mm2, 3),
        }


def map_gemm(g: GemmShape, ppa: MacroPPA, n_macros: int, ib: int, wb: int
             ) -> MappingReport:
    """Weight-stationary tiling: the (k, n) weight matrix is cut into
    H x (W/wb) tiles held in the macro arrays; activations stream bit-serially
    (ib cycles per row of m).  MCR>1 lets a macro hold ``mcr`` tiles resident
    and switch per cycle, reducing weight reloads (the paper's MCR-aware
    memory-density argument)."""
    spec = ppa.design.spec
    cols_per_out = max(1, spec.w // wb)
    tiles_k = math.ceil(g.k / spec.h)
    tiles_n = math.ceil(g.n / cols_per_out)
    tiles = tiles_k * tiles_n
    resident = n_macros * spec.mcr
    passes = math.ceil(tiles / resident)
    weight_reloads = max(0, tiles - resident) * g.count

    cycles_per_tilewave = g.m * ib
    active_waves = math.ceil(tiles / min(tiles, resident))
    cycles = cycles_per_tilewave * active_waves * g.count
    # Weight reload cost: one row per cycle through BL drivers.
    reload_cycles = weight_reloads * spec.h
    cycles += reload_cycles

    # Energy: per-cycle macro energy (int mode) x active macros x cycles.
    e_cycle_fj = ppa.e_cycle_fj["int_hi" if ib > 4 else "int_lo"]
    active_macros = min(tiles, n_macros)
    energy_pj = (cycles - reload_cycles) * e_cycle_fj * active_macros / 1e3
    # BL write energy estimate per reload: ~array write energy.
    energy_pj += weight_reloads * spec.h * spec.w * 3.6 * ppa.design.spec.mcr / 1e3

    lanes_used = (min(g.k, tiles_k * spec.h) / (tiles_k * spec.h)) * \
                 (min(g.n, tiles_n * cols_per_out) / (tiles_n * cols_per_out))
    util = lanes_used * min(1.0, tiles / resident)
    return MappingReport(gemm=g, tiles=tiles, passes=passes, cycles=cycles,
                         weight_reloads=weight_reloads, energy_pj=energy_pj,
                         util=util)


# ---------------------------------------------------------------------------
# Batched workload x design mapping (vectorized map_gemm / accelerator_report)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadMatrix:
    """All (GEMM, design) mappings of one workload in structure-of-arrays.

    Row g, column d mirrors ``map_gemm(gemms[g], ppas[d], ...)`` exactly; the
    per-design totals mirror ``accelerator_report``.  Produced in one
    vectorized float64 numpy pass executing op-for-op, so values are
    bit-identical to the scalar path (see batched_workload_matrix for why
    this map must not be jitted)."""

    designs: tuple[str, ...]
    n_macros: int
    ib: int
    wb: int
    # All arrays are float64 computed op-for-op like the scalar path, so
    # integer-valued quantities (cycles, reloads) are exact.
    cycles: np.ndarray            # (G, D)
    energy_pj: np.ndarray         # (G, D)
    weight_reloads: np.ndarray    # (G, D)
    tiles: np.ndarray             # (G, D)
    util: np.ndarray              # (G, D)
    total_cycles: np.ndarray      # (D,)
    total_energy_pj: np.ndarray   # (D,)
    wallclock_s: np.ndarray       # (D,)
    effective_tops: np.ndarray    # (D,)
    avg_util: np.ndarray          # (D,)
    area_mm2: np.ndarray          # (D,)


def batched_workload_matrix(gemms: Sequence[GemmShape],
                            ppas: Sequence[MacroPPA], n_macros: int,
                            ib: int = 8, wb: int = 8) -> WorkloadMatrix:
    """Map every GEMM of a workload onto every candidate design point in one
    fused pass — the batched counterpart of calling ``accelerator_report``
    per design.  Arithmetic mirrors :func:`map_gemm` operation for operation
    (float ceils included) so totals are bit-identical.  Runs on vectorized
    float64 numpy: at these shapes per-op dispatch dominates, so the
    lattice-scale device pass lives in :mod:`repro_torch.core.batched`
    while this map stays on the host."""
    G, D = len(gemms), len(ppas)
    m = np.array([g.m for g in gemms], dtype=np.float64)[:, None]
    k = np.array([g.k for g in gemms], dtype=np.float64)[:, None]
    n = np.array([g.n for g in gemms], dtype=np.float64)[:, None]
    count = np.array([g.count for g in gemms], dtype=np.float64)[:, None]

    h = np.array([p.design.spec.h for p in ppas], dtype=np.float64)[None, :]
    w = np.array([p.design.spec.w for p in ppas], dtype=np.float64)[None, :]
    mcr = np.array([p.design.spec.mcr for p in ppas],
                   dtype=np.float64)[None, :]
    cpo = np.array([max(1, p.design.spec.w // wb) for p in ppas],
                   dtype=np.float64)[None, :]
    e_cyc = np.array([p.e_cycle_fj["int_hi" if ib > 4 else "int_lo"]
                      for p in ppas], dtype=np.float64)[None, :]

    tiles_k = np.ceil(k / h)
    tiles_n = np.ceil(n / cpo)
    tiles = tiles_k * tiles_n
    resident = n_macros * mcr
    weight_reloads = np.maximum(0.0, tiles - resident) * count
    cpt = m * ib
    active_waves = np.ceil(tiles / np.minimum(tiles, resident))
    cycles = cpt * active_waves * count
    reload_cycles = weight_reloads * h
    cycles = cycles + reload_cycles
    active_macros = np.minimum(tiles, float(n_macros))
    energy_pj = (cycles - reload_cycles) * e_cyc * active_macros / 1e3
    energy_pj = energy_pj + (weight_reloads * h * w * 3.6 * mcr / 1e3)
    lanes = (np.minimum(k, tiles_k * h) / (tiles_k * h)) \
        * (np.minimum(n, tiles_n * cpo) / (tiles_n * cpo))
    util = lanes * np.minimum(1.0, tiles / resident)

    # per-design totals, accumulated in scalar summation order
    total_cycles = np.zeros(D)
    total_energy = np.zeros(D)
    util_cycles = np.zeros(D)
    for g in range(G):
        total_cycles = total_cycles + cycles[g]
        total_energy = total_energy + energy_pj[g]
        util_cycles = util_cycles + util[g] * cycles[g]

    f = reporting_frequency(
        np.array([p.fmax_hz for p in ppas]),
        np.array([p.design.spec.f_mac_hz for p in ppas]),
        np.array([p.meets_timing for p in ppas]))
    wall = total_cycles / f
    macs = sum(g.macs for g in gemms)
    tops = np.where(wall > 0, 2.0 * macs / wall / 1e12, 0.0)
    avg_util = np.where(total_cycles != 0, util_cycles / total_cycles, 0.0)
    area_mm2 = np.array([n_macros * p.area_um2 / 1e6 for p in ppas])

    return WorkloadMatrix(
        designs=tuple(p.design.name() for p in ppas), n_macros=n_macros,
        ib=ib, wb=wb, cycles=cycles, energy_pj=energy_pj,
        weight_reloads=weight_reloads, tiles=tiles,
        util=util, total_cycles=total_cycles,
        total_energy_pj=total_energy, wallclock_s=wall,
        effective_tops=tops, avg_util=avg_util, area_mm2=area_mm2)


@dataclass(frozen=True)
class CodesignReport:
    """Cross-scenario co-design: every workload of the model zoo mapped onto
    every candidate macro design point (paper Fig. 8 extended across
    vision/language/MoE scenarios).  Frontier indices minimize
    (total wallclock, total energy, array area) across the whole inventory."""

    workloads: tuple[str, ...]
    designs: tuple[str, ...]
    n_macros: int
    wallclock_s: np.ndarray       # (W, D)
    energy_pj: np.ndarray         # (W, D)
    effective_tops: np.ndarray    # (W, D)
    avg_util: np.ndarray          # (W, D)
    area_mm2: np.ndarray          # (D,)
    total_wallclock_s: np.ndarray   # (D,)
    total_energy_pj: np.ndarray     # (D,)
    frontier: tuple[int, ...]       # design indices on the co-design frontier

    def best_for(self, workload: str) -> int:
        """Design index with the lowest wallclock for one workload."""
        wi = self.workloads.index(workload)
        return int(np.argmin(self.wallclock_s[wi]))

    def summary(self) -> dict:
        return {
            "workloads": len(self.workloads),
            "designs": len(self.designs),
            "frontier": [self.designs[i] for i in self.frontier],
            "wallclock_spread": float(self.total_wallclock_s.max()
                                      / self.total_wallclock_s.min()),
            "energy_spread": float(self.total_energy_pj.max()
                                   / self.total_energy_pj.min()),
        }


def cross_workload_codesign(workloads: Mapping[str, Sequence[GemmShape]],
                            ppas: Sequence[MacroPPA], n_macros: int = 256,
                            ib: int = 8, wb: int = 8) -> CodesignReport:
    """Batch-map a whole GEMM inventory (workload x design) and extract the
    cross-scenario Pareto frontier over (latency, energy, area)."""
    if not workloads:
        raise ValueError("need at least one workload")
    if not ppas:
        raise ValueError("need at least one candidate design point")
    names = tuple(workloads)
    mats = [batched_workload_matrix(workloads[nm], ppas, n_macros, ib, wb)
            for nm in names]
    wall = np.stack([m.wallclock_s for m in mats])
    energy = np.stack([m.total_energy_pj for m in mats])
    tops = np.stack([m.effective_tops for m in mats])
    util = np.stack([m.avg_util for m in mats])
    area = mats[0].area_mm2
    # Totals accumulate in canonical (name-sorted) order so the frontier is
    # invariant under permutation of the workloads mapping — dict-insertion
    # order must never move a design on or off the co-design frontier.
    total_wall = np.zeros(len(ppas))
    total_energy = np.zeros(len(ppas))
    for wi in sorted(range(len(names)), key=lambda i: names[i]):
        total_wall = total_wall + wall[wi]
        total_energy = total_energy + energy[wi]
    objs = [(float(total_wall[d]), float(total_energy[d]), float(area[d]))
            for d in range(len(ppas))]
    # The auto mask: the host mask in the port (the sharded extraction is
    # not ported) — the same bits as the JAX package's either way.
    frontier = tuple(pareto_indices(objs, mask_fn=nondominated_mask_auto))
    return CodesignReport(
        workloads=names, designs=mats[0].designs, n_macros=n_macros,
        wallclock_s=wall, energy_pj=energy, effective_tops=tops,
        avg_util=util, area_mm2=area, total_wallclock_s=total_wall,
        total_energy_pj=total_energy, frontier=frontier)


def accelerator_report(gemms: list[GemmShape], ppa: MacroPPA, n_macros: int,
                       ib: int = 8, wb: int = 8) -> AcceleratorReport:
    reports = tuple(map_gemm(g, ppa, n_macros, ib, wb) for g in gemms)
    total_cycles = sum(r.cycles for r in reports)
    total_energy = sum(r.energy_pj for r in reports)
    f = float(reporting_frequency(ppa.fmax_hz, ppa.design.spec.f_mac_hz,
                                  ppa.meets_timing))
    wall = total_cycles / f
    macs = sum(r.gemm.macs for r in reports)
    tops = 2.0 * macs / wall / 1e12 if wall > 0 else 0.0
    avg_util = (sum(r.util * r.cycles for r in reports) / total_cycles
                if total_cycles else 0.0)
    return AcceleratorReport(
        macro=ppa.design.name(), n_macros=n_macros, ib=ib, wb=wb,
        reports=reports, total_cycles=total_cycles,
        total_energy_pj=total_energy, wallclock_s=wall,
        effective_tops=tops, avg_util=avg_util,
        area_mm2=n_macros * ppa.area_um2 / 1e6)
