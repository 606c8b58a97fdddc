"""DCIM macro specification, assembly, and PPA roll-up (paper §III-A/§III-D).

``MacroSpec`` is the compiler *input* (architecture parameters + performance
constraints); ``MacroDesign`` is one synthesized design point: a concrete
choice of subcircuit variants plus its rolled-up PPA.  The roll-up composes
the subcircuit models of :mod:`repro_torch.core.subcircuits` and applies voltage and
switching-activity scaling from :mod:`repro_torch.core.tech`.

Throughput conventions (match Table II footnotes):
  * ``tops_1b(v)``    — 2·H·W·f(v), the "scaled to 1b input / 1b weight" TOPS
  * ``macs_per_s``    — real ib×wb MAC rate: H·(W/wb)·f/ib
The silicon anchors (1.1 GHz @1.2 V -> 9.0 TOPS; 1921 TOPS/W @0.7 V; 0.112 mm²)
are reproduced by construction via :func:`calibrated_tech_for_reference`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np

from . import subcircuits as sc
from .csa import CSADesign, CSAReport
from .tech import TechModel

# Table II measurement conditions (used for calibration + default reporting).
ACT_IN_MEAS = 0.125    # input sparsity 12.5%
ACT_WT_MEAS = 0.5      # weight sparsity 50%


@dataclass(frozen=True)
class MacroSpec:
    """User-facing compiler input (paper Fig. 2 'Input Specifications')."""

    h: int = 64                     # rows (accumulation depth)
    w: int = 64                     # columns (1-bit weight lanes)
    mcr: int = 2                    # memory-compute ratio
    int_precisions: tuple[int, ...] = (1, 2, 4, 8)
    fp_precisions: tuple[str, ...] = ("FP4", "FP8")
    f_mac_hz: float = 800e6         # required MAC frequency
    f_wupdate_hz: float = 800e6     # required weight-update frequency
    vdd: float = 0.9                # voltage at which constraints apply
    # PPA preference weights (power, area, throughput) — §III-C "chosen based
    # on PPA preferences":
    w_power: float = 1.0
    w_area: float = 1.0
    w_throughput: float = 1.0

    def __post_init__(self):
        if self.h < 4 or self.w < 4:
            raise ValueError("macro dims must be >= 4")
        if self.h & (self.h - 1) or self.w & (self.w - 1):
            raise ValueError("macro dims must be powers of two")
        if self.mcr < 1:
            raise ValueError("MCR must be >= 1")
        if not self.int_precisions:
            raise ValueError("need at least one INT precision")
        bad = [f for f in self.fp_precisions if f not in sc.FP_FORMATS]
        if bad:
            raise ValueError(f"unknown FP formats: {bad}")

    @property
    def max_input_bits(self) -> int:
        fp_int = [sc.FP_FORMATS[f][1] + 2 for f in self.fp_precisions]
        return max(list(self.int_precisions) + fp_int)

    @property
    def array_kbit(self) -> float:
        return self.h * self.w / 1024.0


def reference_chip_spec() -> MacroSpec:
    """The fabricated 40nm test chip (paper §IV-B)."""
    return MacroSpec(h=64, w=64, mcr=2, int_precisions=(1, 2, 4, 8),
                     fp_precisions=("FP4", "FP8"), f_mac_hz=1.1e9,
                     f_wupdate_hz=1.1e9, vdd=1.2)


def pareto_experiment_spec() -> MacroSpec:
    """Fig. 8 experiment spec: H=W=64, MCR=2, INT4/8 + FP4/8, 800 MHz @0.9 V."""
    return MacroSpec(h=64, w=64, mcr=2, int_precisions=(4, 8),
                     fp_precisions=("FP4", "FP8"), f_mac_hz=800e6,
                     f_wupdate_hz=800e6, vdd=0.9)


# ---------------------------------------------------------------------------
# Design point
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MacroDesign:
    """A concrete subcircuit selection for a spec."""

    spec: MacroSpec
    memcell: sc.MemCellKind = sc.MemCellKind.SRAM_6T
    multmux: sc.MultMuxKind = sc.MultMuxKind.TG_NOR
    csa: CSADesign = CSADesign(rho=1.0)
    ofu_pipe_stages: int = 0              # tt5 (repeatable)
    ofu_retimed_into_sa: bool = False     # tt4
    fuse_tree_sa: bool = False            # Step 3 register fusion
    fuse_sa_ofu: bool = False
    # Precision provisioning (lattice "precision" axis): the weight-precision
    # set the OFU fusion chain is built for and the FP format set the
    # alignment unit is built for.  None means the spec's own lists — the
    # seed behavior, bit-identical.
    ofu_precisions: tuple[int, ...] | None = None
    align_fp: tuple[str, ...] | None = None
    # Approximate adder-tree cell (lattice "approx_cell" axis); None/exact
    # reproduces the characterized exact tree bit-for-bit.
    approx_cell: sc.ApproxCellSpec | None = None
    audit: tuple[str, ...] = ()           # searcher decision log

    def name(self) -> str:
        bits = [self.memcell.value, self.multmux.value, self.csa.name()]
        if self.approx_cell is not None and not self.approx_cell.is_exact():
            bits.append(self.approx_cell.name)
        if self.ofu_pipe_stages:
            bits.append(f"ofuP{self.ofu_pipe_stages}")
        if self.ofu_precisions:
            bits.append(f"provW{max(self.ofu_precisions)}")
        if self.align_fp:
            bits.append(f"provF{len(self.align_fp)}")
        if self.fuse_tree_sa:
            bits.append("fTS")
        if self.fuse_sa_ofu:
            bits.append("fSO")
        return "-".join(bits)

    def with_audit(self, msg: str) -> "MacroDesign":
        return replace(self, audit=self.audit + (msg,))


# ---------------------------------------------------------------------------
# PPA roll-up
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PathReport:
    mac_path_rel: float       # WL -> mult -> tree (tau)
    sa_path_rel: float
    ofu_path_rel: float
    crit_rel: float


@dataclass(frozen=True)
class MacroPPA:
    design: MacroDesign
    paths: PathReport
    fmax_hz: float                  # at spec.vdd
    area_um2: float
    area_breakdown: dict
    e_cycle_fj: dict                # mode -> per-cycle energy at spec.vdd, meas activity
    latency_cycles: int             # input-bit-0 in -> fused result out (INT max-prec)
    tops_1b: float                  # at spec.vdd, fmax
    tops_per_w_1b: dict             # mode -> 1b-scaled TOPS/W at spec.vdd
    tops_per_mm2_1b: float
    meets_timing: bool
    csa_report: CSAReport = None

    def summary(self) -> dict:
        return {
            "design": self.design.name(),
            "fmax_mhz": round(self.fmax_hz / 1e6, 1),
            "area_mm2": round(self.area_um2 / 1e6, 4),
            "tops_1b": round(self.tops_1b, 2),
            "tops_w_int_lo": round(self.tops_per_w_1b["int_lo"], 1),
            "tops_mm2": round(self.tops_per_mm2_1b, 1),
            "latency_cycles": self.latency_cycles,
            "meets_timing": self.meets_timing,
        }


def _product_bits(spec: MacroSpec) -> int:
    """Bit-serial inputs: each cycle the tree reduces H 1b x 1b products per
    column lane; signed handling adds a guard bit."""
    return 2


def reporting_frequency(fmax_hz, f_mac_hz, meets_timing):
    """The clock a deployed macro is *reported* (and served) at.

    A design that meets timing is down-clocked to the spec'd MAC frequency
    (``min(fmax, f_mac)``); a timing-missing design reports its raw ``fmax``.
    This is the single clamp shared by :func:`rollup`, the scalar
    ``dse.accelerator_report``, the batched ``dse.batched_workload_matrix``,
    the lattice engine's throughput roll-up, and multi-spec serving selection
    — so the same design is never clocked differently by different reporting
    paths.  Accepts scalars or arrays."""
    fmax_hz = np.asarray(fmax_hz, dtype=np.float64)
    f_mac_hz = np.asarray(f_mac_hz, dtype=np.float64)
    meets = np.asarray(meets_timing, dtype=bool)
    return np.where(meets, np.minimum(fmax_hz, f_mac_hz), fmax_hz)


def timing_paths(design: MacroDesign, tech: TechModel) -> tuple[PathReport, CSAReport, dict]:
    spec = design.spec
    wl = sc.wl_driver_ppa(spec.h, spec.w, spec.mcr, tech)
    mm = sc.multmux_ppa(design.multmux, spec.mcr, tech)
    tree_ppa, csa_rep = sc.adder_tree_ppa(design.csa, spec.h,
                                          _product_bits(spec), tech,
                                          cell=design.approx_cell)
    sa = sc.shift_adder_ppa(csa_rep.acc_width, spec.max_input_bits, tech)
    out_w = csa_rep.acc_width + spec.max_input_bits
    ofu = sc.ofu_ppa(spec.w,
                     design.ofu_precisions or tuple(spec.int_precisions),
                     out_w, design.ofu_pipe_stages, tech)
    align = sc.align_ppa(spec.w,
                         design.align_fp or tuple(spec.fp_precisions), tech)

    mac_path = wl.delay_rel + mm.delay_rel + tree_ppa.delay_rel
    sa_path = sa.delay_rel
    ofu_path = ofu.delay_rel
    if design.ofu_retimed_into_sa:
        moved = 0.3 * ofu_path
        ofu_path -= moved
        sa_path += moved
    if design.fuse_tree_sa:
        mac_path = mac_path + sa_path
        sa_path = 0.0
    if design.fuse_sa_ofu:
        sa_path = sa_path + ofu_path
        ofu_path = 0.0
    # The alignment unit is an input-side stage with its own (internally
    # pipelineable) registers; the paper's critical paths are "the WL driver,
    # multiplier, adder tree, and OFU" (§III-C), so align is excluded here.
    crit = max(mac_path, sa_path, ofu_path)
    parts = {"wl": wl, "multmux": mm, "tree": tree_ppa, "sa": sa, "ofu": ofu,
             "align": align}
    return PathReport(mac_path, sa_path, ofu_path, crit), csa_rep, parts


def _mode_bits(spec: MacroSpec, mode: str) -> int:
    """Bit-serial input cycles per result in a given mode."""
    if mode == "int_lo":
        return min(spec.int_precisions)
    if mode == "int_hi":
        return max(spec.int_precisions)
    exp, man = sc.FP_FORMATS[mode]
    return man + 2  # aligned mantissa (+hidden bit +sign) streams bit-serially


def _mode_energy_rel(design: MacroDesign, parts: dict, mode: str,
                     act_in: float, act_wt: float) -> float:
    """Per-cycle switching energy (eps units, at VDD_NOM) in a given mode.

    Modes: 'int_lo' (min INT), 'int_hi' (max INT), and each FP format.
    FP modes activate the alignment unit — the source of the ~+10% (FP8 vs
    INT4) and ~+20% (BF16 vs INT8) power overheads in Fig. 7.
    """
    spec = design.spec
    wl, mm, tree, sa, ofu, align = (parts["wl"], parts["multmux"],
                                    parts["tree"], parts["sa"], parts["ofu"],
                                    parts["align"])
    e = 0.0
    e += wl.energy_rel * act_in                      # rows toggle with inputs
    e += spec.h * spec.w * mm.energy_rel * act_in * act_wt
    tree_act = min(1.0, act_in * act_wt + 0.02)      # glitch floor
    e += tree.energy_rel * tree_act
    e += sa.energy_rel * 0.55                        # active every cycle
    # OFU fires once per completed bit-serial result:
    ib = _mode_bits(spec, mode)
    e += ofu.energy_rel * (0.5 / max(1, ib))
    if mode in sc.FP_FORMATS:
        # Alignment activity scales with the active format's width relative to
        # the widest format the unit was built for.
        exp, man = sc.FP_FORMATS[mode]
        built_for = design.align_fp or spec.fp_precisions
        emax = max(sc.FP_FORMATS[f][0] for f in built_for)
        mmax = max(sc.FP_FORMATS[f][1] for f in built_for)
        frac = (exp + 0.5 * man) / (emax + 0.5 * mmax)
        e += align.energy_rel * 0.62 * frac
    else:
        e += align.energy_rel * 0.04                 # clock gating residue
    # Weight update (BL drivers + SRAM write) at the spec'd update duty:
    duty = min(1.0, spec.f_wupdate_hz / max(spec.f_mac_hz, 1.0)) * 1.0 / (spec.h * spec.mcr)
    # (one row re-written per update event)
    bl = sc.bl_driver_ppa(spec.h, spec.w, spec.mcr, TechModel())  # rel consts only
    e += (bl.energy_rel / (spec.h * spec.mcr)) * duty
    return e


def rollup(design: MacroDesign, tech: TechModel,
           act_in: float = ACT_IN_MEAS, act_wt: float = ACT_WT_MEAS) -> MacroPPA:
    spec = design.spec
    paths, csa_rep, parts = timing_paths(design, tech)
    fmax = tech.fmax_hz(paths.crit_rel, spec.vdd)
    meets = fmax >= spec.f_mac_hz * 0.999

    # ---- area ---------------------------------------------------------------
    cell = sc.memcell_ppa(design.memcell, tech)
    n_cells = spec.h * spec.w * spec.mcr
    a_array = n_cells * cell.area_um2
    a_mult = spec.h * spec.w * parts["multmux"].area_um2
    a_tree = parts["tree"].area_um2 * spec.w
    a_sa = parts["sa"].area_um2 * spec.w
    a_ofu = parts["ofu"].area_um2
    a_align = parts["align"].area_um2
    a_drv = (sc.wl_driver_ppa(spec.h, spec.w, spec.mcr, tech).area_um2
             + sc.bl_driver_ppa(spec.h, spec.w, spec.mcr, tech).area_um2)
    breakdown = {"sram_array": a_array, "multmux": a_mult, "adder_tree": a_tree,
                 "shift_adder": a_sa, "ofu": a_ofu, "align": a_align,
                 "drivers": a_drv}
    area = sum(breakdown.values()) * tech.apr_overhead

    # ---- per-cycle energy by mode --------------------------------------------
    # Tree/S&A energies above are per *column*; scale to W columns here.
    parts_scaled = dict(parts)
    parts_scaled["tree"] = parts["tree"].scaled(k_energy=spec.w)
    parts_scaled["sa"] = parts["sa"].scaled(k_energy=spec.w)
    modes = ["int_lo", "int_hi"] + list(spec.fp_precisions)
    e_cycle = {}
    for m in modes:
        rel = _mode_energy_rel(design, parts_scaled, m, act_in, act_wt)
        e_cycle[m] = tech.energy_fj(rel, spec.vdd)

    # ---- latency --------------------------------------------------------------
    ib = max(spec.int_precisions)
    pipe = csa_rep.latency_cycles + parts["sa"].latency_cycles + parts["ofu"].latency_cycles
    if design.fuse_tree_sa:
        pipe -= 1
    if design.fuse_sa_ofu:
        pipe -= 1
    latency = ib + max(1, pipe)

    # ---- throughput -------------------------------------------------------------
    f_rep = float(reporting_frequency(fmax, spec.f_mac_hz, meets))
    tops_1b = 2.0 * spec.h * spec.w * f_rep / 1e12
    leak_mw = tech.leakage_mw(area, spec.vdd)
    tops_w = {}
    for m, efj in e_cycle.items():
        p_mw = efj * 1e-15 * f_rep * 1e3 + leak_mw
        tops_w[m] = tops_1b / (p_mw * 1e-3) if p_mw > 0 else float("inf")
    tops_mm2 = tops_1b / (area / 1e6)

    return MacroPPA(design=design, paths=paths, fmax_hz=fmax, area_um2=area,
                    area_breakdown=breakdown, e_cycle_fj=e_cycle,
                    latency_cycles=latency, tops_1b=tops_1b,
                    tops_per_w_1b=tops_w, tops_per_mm2_1b=tops_mm2,
                    meets_timing=meets, csa_report=csa_rep)


# ---------------------------------------------------------------------------
# Calibration against the test chip
# ---------------------------------------------------------------------------


def reference_chip_design() -> MacroDesign:
    """The silicon-validated design point: mixed CSA with reordering and a
    retimed final RCA (paper §III-B + §IV-B)."""
    return MacroDesign(spec=reference_chip_spec(),
                       memcell=sc.MemCellKind.SRAM_6T,
                       multmux=sc.MultMuxKind.TG_NOR,
                       csa=CSADesign(rho=0.5, reorder=True, retimed=True),
                       ofu_pipe_stages=1,
                       fuse_sa_ofu=False)


@functools.lru_cache(maxsize=1)
def calibrated_tech_for_reference() -> TechModel:
    """Solve (tau, eps, apr) so the reference design reproduces the measured
    silicon exactly (see tech.py anchors).  Three-step, deterministic:

      1. tau  <- 1.1 GHz @ 1.2 V on the reference critical path;
      2. apr  <- 0.112 mm^2 on the reference placed area;
      3. eps  <- 1921 TOPS/W @ 0.7 V *after* subtracting leakage of the
                 calibrated area (leakage is ~5% at 0.7 V — ignoring it would
                 bias the dynamic-energy unit).
    """
    from . import tech as T

    base = TechModel()
    ref = reference_chip_design()
    paths, _csa, parts = timing_paths(ref, base)

    # Step 1: delay unit.
    tau = (1e12 / T.F_ANCHOR_HZ) / (paths.crit_rel * T.delay_scale(T.V_ANCHOR))

    # Step 2: area unit (APR/routing overhead multiplier).
    ppa0 = rollup(ref, base)
    apr = T.AREA_ANCHOR_UM2 / ppa0.area_um2

    # Step 3: energy unit at the Table II operating point (0.7 V).
    f_low = 1e12 / (paths.crit_rel * tau * T.delay_scale(T.V_LOW))
    tops_low = 2.0 * ref.spec.h * ref.spec.w * f_low / 1e12
    p_target_mw = tops_low / T.EEFF_ANCHOR_TOPS_W * 1e3          # W -> mW
    leak_mw = (T.AREA_ANCHOR_UM2 * base.leak_mw_per_um2
               * T.leakage_scale(T.V_LOW))
    e_cycle_fj = max(p_target_mw - leak_mw, 1e-9) * 1e-3 / f_low * 1e15

    parts_scaled = dict(parts)
    parts_scaled["tree"] = parts["tree"].scaled(k_energy=ref.spec.w)
    parts_scaled["sa"] = parts["sa"].scaled(k_energy=ref.spec.w)
    e_rel = _mode_energy_rel(ref, parts_scaled, "int_lo", ACT_IN_MEAS, ACT_WT_MEAS)
    eps = e_cycle_fj / (e_rel * T.energy_scale(T.V_LOW))

    return base.with_calibration(tau_ps=tau, eps_fj=eps, apr_overhead=apr)


def at_voltage(design: MacroDesign, vdd: float) -> MacroDesign:
    """Re-target a design's reporting voltage (shmoo / Table II sweeps)."""
    return replace(design, spec=replace(design.spec, vdd=vdd))


def reference_chip_ppa(vdd: float | None = None) -> MacroPPA:
    tech = calibrated_tech_for_reference()
    design = reference_chip_design()
    if vdd is not None:
        design = at_voltage(design, vdd)
    return rollup(design, tech)
