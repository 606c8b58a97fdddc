"""The seven DCIM subcircuit types and their PPA models (paper §II-B, Fig. 3).

Every subcircuit type offers several *variants* (circuit topologies from the
paper's survey) and a parametric PPA model.  The Subcircuit Library
(``repro_torch.core.scl``) characterizes these models over a grid of dimensions and
timing constraints into lookup tables — mirroring the paper's
"custom cell characterization flow" + "parameterized RTL templates ...
estimated and scaled from synthesis data".

PPA conventions (see tech.py): delay in tau units (relative), energy in eps
units per cycle at 100% activity, area in um^2.  Voltage and activity scaling
are applied by the macro roll-up.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace

from . import csa as csa_mod
from .tech import TechModel


class SC(enum.Enum):
    """Subcircuit types (paper §II-B)."""

    ALIGN = "fp_int_alignment"
    WLBL_DRIVER = "wl_bl_driver"
    MEMCELL = "memory_cell"
    MULTMUX = "multiplier_multiplexer"
    ADDER_TREE = "adder_tree"
    SHIFT_ADDER = "shift_adder"
    OFU = "output_fusion_unit"


@dataclass(frozen=True)
class PPA:
    delay_rel: float       # critical path through the subcircuit, tau units
    energy_rel: float      # per cycle at 100% activity, eps units
    area_um2: float
    latency_cycles: int = 0
    meta: tuple = ()

    def scaled(self, k_energy: float = 1.0, k_area: float = 1.0) -> "PPA":
        return PPA(self.delay_rel, self.energy_rel * k_energy,
                   self.area_um2 * k_area, self.latency_cycles, self.meta)


# ---------------------------------------------------------------------------
# Memory cells (paper §II-B "Memory Cell")
# ---------------------------------------------------------------------------


class MemCellKind(enum.Enum):
    SRAM_6T = "6T"          # foundry cell + read-select (TSMC ISSCC'24 style)
    DLATCH_8T = "8T"        # robust simultaneous read/write ([3])
    OAI_12T = "12T"         # OAI-gate based, design-feasibility oriented ([10])


def memcell_ppa(kind: MemCellKind, tech: TechModel) -> PPA:
    if kind is MemCellKind.SRAM_6T:
        return PPA(delay_rel=0.9, energy_rel=tech.e_sram_read_bit,
                   area_um2=tech.a_sram6t)
    if kind is MemCellKind.DLATCH_8T:
        return PPA(delay_rel=0.7, energy_rel=tech.e_sram_read_bit * 1.25,
                   area_um2=tech.a_sram8t)
    return PPA(delay_rel=0.8, energy_rel=tech.e_sram_read_bit * 1.45,
               area_um2=tech.a_sram12t)


MEMCELL_SUPPORTS_MACWRITE = {
    # simultaneous MAC + weight write (Table II "MAC-Write")
    MemCellKind.SRAM_6T: True,
    MemCellKind.DLATCH_8T: True,
    MemCellKind.OAI_12T: False,
}


# ---------------------------------------------------------------------------
# Bitwise multiplier + multiplexer (paper §II-B, three options)
# ---------------------------------------------------------------------------


class MultMuxKind(enum.Enum):
    PASS_1T = "1t_pass"       # area-efficient; voltage drop -> power/latency hit
    OAI22_FUSED = "oai22"     # fused mult+mux ([3]); scalable only to MCR<=2
    TG_NOR = "tg2t_nor"       # 2T transmission gate + NOR mult (common choice)


def multmux_ppa(kind: MultMuxKind, mcr: int, tech: TechModel) -> PPA:
    """Per-cell-site multiplier+mux PPA.  ``mcr`` memory rows share one
    compute row; the mux selects among them."""
    mux_levels = max(1, math.ceil(math.log2(max(2, mcr))))
    if kind is MultMuxKind.PASS_1T:
        d = tech.d_mult_pass1t + 0.6 * mux_levels
        e = tech.e_mult_pass1t + 0.3 * mux_levels
        a = tech.a_mult_pass1t * mcr + tech.a_mult_nor
    elif kind is MultMuxKind.OAI22_FUSED:
        if mcr > 2:
            raise ValueError("OAI22 fused mult+mux does not scale beyond MCR=2 "
                             "(paper §II-B)")
        d = tech.d_mult_oai22
        e = tech.e_mult_oai22
        a = tech.a_mult_oai22
    else:
        d = tech.d_mux2 * mux_levels + tech.d_mult_nor
        e = tech.e_mux2 * 0.4 * mux_levels + tech.e_mult_nor
        a = tech.a_tg2t * mcr + tech.a_mult_nor
    return PPA(delay_rel=d, energy_rel=e, area_um2=a)


def multmux_valid(kind: MultMuxKind, mcr: int) -> bool:
    return not (kind is MultMuxKind.OAI22_FUSED and mcr > 2)


# ---------------------------------------------------------------------------
# WL / BL drivers
# ---------------------------------------------------------------------------


def wl_driver_ppa(h_rows: int, w_cols: int, mcr: int, tech: TechModel) -> PPA:
    """Word-line drivers: one per (physical) row; drive W columns of wire+gates.
    Energy reported per cycle assuming every row toggles (activity applied
    upstream)."""
    n_rows = h_rows * mcr
    d = tech.d_wl_driver_base + tech.d_wl_driver_per_log2col * math.log2(max(2, w_cols))
    e = n_rows * w_cols * tech.e_wl_per_cell
    a = n_rows * tech.a_driver_per_row
    return PPA(delay_rel=d, energy_rel=e, area_um2=a)


def bl_driver_ppa(h_rows: int, w_cols: int, mcr: int, tech: TechModel) -> PPA:
    """Bit-line write drivers: one per column pair; active only on weight
    updates (duty factor applied by the macro roll-up)."""
    d = tech.d_wl_driver_base + tech.d_wl_driver_per_log2col * math.log2(max(2, h_rows * mcr))
    e = h_rows * mcr * w_cols * tech.e_bl_per_cell  # full-array write energy
    a = w_cols * tech.a_driver_per_col
    return PPA(delay_rel=d, energy_rel=e, area_um2=a)


# ---------------------------------------------------------------------------
# Shift & Adder (bit-serial accumulator, paper §II-B "S&A")
# ---------------------------------------------------------------------------


def shift_adder_ppa(acc_width: int, input_bits: int, tech: TechModel) -> PPA:
    """Accumulates bit-serial partial sums: width grows with input bit-width
    and tree accumulator width."""
    w = acc_width + input_bits
    d = tech.d_rca_per_bit * w + tech.d_reg_cq_su
    e = w * (tech.e_fa * 0.8 + tech.e_reg * 0.3 + tech.e_clk_per_reg)
    a = w * (tech.a_fa + tech.a_reg)
    return PPA(delay_rel=d, energy_rel=e, area_um2=a, latency_cycles=1)


# ---------------------------------------------------------------------------
# Output Fusion Unit (multi-precision reconfigurability, paper §II-B "OFU")
# ---------------------------------------------------------------------------


def ofu_ppa(w_cols: int, weight_precisions: tuple[int, ...], out_width: int,
            pipe_stages: int, tech: TechModel) -> PPA:
    """Fuses S&A outputs across columns stage by stage, low to high precision
    ([9]).  ``weight_precisions`` e.g. (1,2,4,8): fusion stages = log2(max/min).
    ``pipe_stages`` extra pipeline registers (tt5) split the fusion chain.
    """
    pmax, pmin = max(weight_precisions), min(weight_precisions)
    stages = max(1, int(math.log2(pmax // pmin))) if pmax > pmin else 1
    groups = w_cols // 2  # adders at the widest fusion stage
    w = out_width + int(math.log2(max(2, pmax)))
    d_stage = tech.d_rca_per_bit * w + tech.d_mux2
    cuts = max(0, min(pipe_stages, stages - 1))
    d = d_stage * math.ceil(stages / (cuts + 1)) + tech.d_reg_cq_su
    lat = 1 + cuts
    n_adders = sum(max(1, groups >> s) for s in range(stages))
    e = n_adders * w * (tech.e_fa * 0.7) + (w * lat) * tech.e_clk_per_reg
    a = n_adders * w * tech.a_fa * 0.6 + w * lat * tech.a_reg
    return PPA(delay_rel=d, energy_rel=e, area_um2=a, latency_cycles=lat)


# ---------------------------------------------------------------------------
# FP & INT Alignment Unit (paper §II-B)
# ---------------------------------------------------------------------------

FP_FORMATS = {
    # name: (exp_bits, man_bits)
    "FP4": (2, 1),
    "FP8": (4, 3),      # E4M3
    "BF16": (8, 7),
}


def align_ppa(w_cols: int, fp_formats: tuple[str, ...], tech: TechModel) -> PPA:
    """Comparator tree (max exponent across the column group) + mantissa
    shifters ([9]).  Complexity depends on the *combination* of FP precisions
    supported."""
    if not fp_formats:
        return PPA(0.0, 0.0, 0.0)
    emax = max(FP_FORMATS[f][0] for f in fp_formats)
    mmax = max(FP_FORMATS[f][1] for f in fp_formats)
    cmp_levels = math.ceil(math.log2(max(2, w_cols)))
    d = tech.d_cmp_per_bit * emax * cmp_levels + tech.d_mux2 * math.ceil(math.log2(mmax + 2))
    # One comparator per pair per level + a barrel shifter per column.
    n_cmp = w_cols - 1
    shift_stages = math.ceil(math.log2(mmax + 2))
    e = (n_cmp * emax * tech.e_xor * 1.2
         + w_cols * (mmax + 1) * shift_stages * tech.e_mux2)
    a = (n_cmp * emax * tech.a_xor * 1.5
         + w_cols * (mmax + 1) * shift_stages * tech.a_mux2)
    # Extra formats beyond the first add mode-mux overhead:
    k = 1.0 + 0.18 * (len(fp_formats) - 1)
    return PPA(delay_rel=d, energy_rel=e * k, area_um2=a * k, latency_cycles=1)


# ---------------------------------------------------------------------------
# Adder tree (delegates to csa.py) + approximate compressor cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ApproxCellSpec:
    """An approximate adder-tree cell variant (OpenACM-style): the exact
    4:2 compressor / full-adder cells are swapped for approximate ones whose
    error is absorbed by the workload.  PPA is modeled as first-order scale
    factors on the characterized exact tree — the tree *structure* (stage
    count, register placement, accumulator widths, latency) is unchanged, so
    an approximate variant slots into the same lattice point shape."""

    name: str = "exact"
    k_delay: float = 1.0
    k_energy: float = 1.0
    k_area: float = 1.0

    def __post_init__(self):
        if min(self.k_delay, self.k_energy, self.k_area) <= 0.0:
            raise ValueError("approximate-cell scale factors must be > 0")

    def is_exact(self) -> bool:
        return self.k_delay == self.k_energy == self.k_area == 1.0


#: The exact (seed) cell — scale factors of 1.0 reproduce the characterized
#: tree bit-for-bit.
EXACT_CELL = ApproxCellSpec()

#: A small catalog of approximate compressor variants (first-order numbers in
#: the spirit of the OpenACM lower-part-OR / truncation families).
APPROX_CELLS: tuple[ApproxCellSpec, ...] = (
    EXACT_CELL,
    ApproxCellSpec(name="loa4", k_delay=0.92, k_energy=0.71, k_area=0.78),
    ApproxCellSpec(name="trunc8", k_delay=0.85, k_energy=0.55, k_area=0.64),
)


def approx_tree_report(rep: csa_mod.CSAReport,
                       cell: ApproxCellSpec | None) -> csa_mod.CSAReport:
    """Apply an approximate cell's scale factors to a characterized exact
    tree.  ``None`` or the exact cell returns the report unchanged (the same
    object — bit-identity with the pre-approximation path)."""
    if cell is None or cell.is_exact():
        return rep
    return replace(rep,
                   crit_path_rel=rep.crit_path_rel * cell.k_delay,
                   energy_rel=rep.energy_rel * cell.k_energy,
                   area_um2=rep.area_um2 * cell.k_area)


def adder_tree_ppa(design: csa_mod.CSADesign, h_rows: int, product_bits: int,
                   tech: TechModel,
                   cell: ApproxCellSpec | None = None
                   ) -> tuple[PPA, csa_mod.CSAReport]:
    rep = approx_tree_report(
        csa_mod.characterize(design, h_rows, product_bits, tech), cell)
    meta = (design.name(),) if cell is None or cell.is_exact() \
        else (design.name(), cell.name)
    ppa = PPA(delay_rel=rep.crit_path_rel, energy_rel=rep.energy_rel,
              area_um2=rep.area_um2, latency_cycles=rep.latency_cycles,
              meta=meta)
    return ppa, rep
