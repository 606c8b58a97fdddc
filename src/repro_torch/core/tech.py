"""40nm CMOS technology model for SynDCIM PPA estimation.

The paper characterizes subcircuits with a foundry PDK (custom cell
characterization -> LEF/LIB) and validates with a 40nm test chip.  This module
replaces the PDK with an analytical technology model whose free constants are
calibrated against the paper's *measured* silicon:

  * f_max = 1.1 GHz @ 1.2 V and 300 MHz @ 0.7 V        (Fig. 9 shmoo)
  * 9.0 TOPS (1b x 1b scaled, 4 Kb array) @ 1.2 V      (Fig. 9)
  * 1921 TOPS/W @ 0.7 V, INT4, 12.5% input / 50% weight activity (Table II)
  * macro area 0.112 mm^2 (455 x 246 um) for the 64x64 MCR=2 macro (Fig. 10)

Voltage/frequency scaling follows the alpha-power law

    delay(V) ∝ V / (V - Vth)^alpha

with (Vth, alpha) fit to the two shmoo anchor points, and dynamic energy
follows E ∝ V^2.  All per-gate constants below are expressed at VDD_NOM and
scaled from there.

Units used throughout ``repro_torch.core``:
  delay  : ps
  energy : fJ (per event, at VDD_NOM unless stated)
  area   : um^2
  power  : mW (derived)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Voltage scaling
# ---------------------------------------------------------------------------

VDD_NOM = 1.1     # V   — characterization voltage for all base constants
VTH = 0.35        # V   — fit (see DESIGN.md §7)
ALPHA = 2.05      # alpha-power-law exponent — fit to the Fig. 9 shmoo anchors


def delay_scale(vdd: float, vth: float = VTH, alpha: float = ALPHA) -> float:
    """Multiplier on delay when running at ``vdd`` instead of VDD_NOM."""
    if vdd <= vth:
        return float("inf")

    def d(v: float) -> float:
        return v / (v - vth) ** alpha

    return d(vdd) / d(VDD_NOM)


def energy_scale(vdd: float) -> float:
    """Multiplier on dynamic energy when running at ``vdd`` (E ∝ V^2)."""
    return (vdd / VDD_NOM) ** 2


def leakage_scale(vdd: float) -> float:
    """Sub-threshold leakage grows superlinearly with VDD; a V^3-ish fit is
    adequate over the paper's 0.7—1.2 V window."""
    return (vdd / VDD_NOM) ** 3


# ---------------------------------------------------------------------------
# Technology model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TechModel:
    """Per-gate PPA constants at 40nm, VDD_NOM.

    The ``tau`` delay unit and ``eps`` energy unit are the two calibration
    knobs solved by :func:`calibrated_tech` so the reference macro reproduces
    the paper's measured silicon exactly; the *relative* constants (an XOR is
    ~1.4x an NAND, a 4-2 compressor is ~1.9x an FA, ...) come from standard
    40nm standard-cell-library ratios.
    """

    node_nm: int = 40
    vdd_nom: float = VDD_NOM
    vth: float = VTH
    alpha: float = ALPHA

    # Calibration knobs (solved in calibrated_tech()):
    tau_ps: float = 1.0     # base gate-delay unit (≈ loaded NAND2 delay)
    eps_fj: float = 1.0     # base gate-energy unit (≈ NAND2 switching energy)

    # --- relative delay (in tau) -------------------------------------------------
    d_nand: float = 1.0
    d_xor: float = 1.6
    d_fa_sum: float = 3.2        # two chained XORs
    d_fa_carry: float = 2.2      # majority gate path (carry is faster — §III-B)
    d_comp42_sum: float = 4.8    # 4-2 compressor through-sum path (slower than FA)
    d_comp42_carry: float = 3.4
    d_mux2: float = 1.2
    d_reg_cq_su: float = 2.6     # clk->q + setup budget
    d_wl_driver_base: float = 2.0
    d_wl_driver_per_log2col: float = 0.8   # buffer chain grows with fanout
    d_mult_nor: float = 1.1      # NOR2 bitwise multiplier
    d_mult_oai22: float = 1.5    # fused OAI22 multiplier+mux
    d_mult_pass1t: float = 2.4   # 1T pass gate: voltage-drop slows downstream
    d_rca_per_bit: float = 1.1   # ripple-carry per-bit carry delay
    d_cmp_per_bit: float = 0.9   # comparator tree per-bit

    # --- relative energy (in eps, per active event) ------------------------------
    e_nand: float = 1.0
    e_xor: float = 1.8
    e_fa: float = 4.2            # full adder total switching energy
    e_ha: float = 2.2
    e_comp42: float = 7.2        # < 2x FA: shared internal nodes (§III-B)
    e_mux2: float = 1.2
    e_reg: float = 2.8           # per flop toggle incl. local clock
    e_clk_per_reg: float = 0.9   # clock tree distribution per sink, every cycle
    e_sram_read_bit: float = 1.3
    e_sram_write_bit: float = 3.6
    e_mult_nor: float = 0.9
    e_mult_oai22: float = 1.3
    e_mult_pass1t: float = 1.6   # voltage drop -> short-circuit current penalty
    e_wl_per_cell: float = 0.35  # WL wire+driver energy amortized per cell on row
    e_bl_per_cell: float = 0.5

    # --- area (um^2, absolute — 40nm standard cell estimates) --------------------
    a_sram6t: float = 0.62
    a_sram8t: float = 0.92      # 8T D-latch cell (robust R/W, [3])
    a_sram12t: float = 1.35     # 12T OAI-gate cell ([10])
    a_fa: float = 5.2
    a_ha: float = 2.8
    a_comp42: float = 8.6       # < 2x FA area
    a_mux2: float = 1.9
    a_reg: float = 6.5
    a_nand: float = 1.1
    a_xor: float = 2.2
    a_mult_nor: float = 1.2
    a_mult_oai22: float = 2.4
    a_mult_pass1t: float = 0.45
    a_tg2t: float = 0.9
    a_driver_per_row: float = 14.0     # WL driver slice
    a_driver_per_col: float = 11.0     # BL driver slice
    # APR fill / routing overhead multiplier on placed cell area (SDP keeps the
    # array regular; peripheral logic is APR'd around it — §III-D):
    apr_overhead: float = 1.0

    # --- leakage ------------------------------------------------------------------
    # static power per um^2 of placed cells at VDD_NOM, in mW/um^2
    leak_mw_per_um2: float = 2.1e-6

    # ------------------------------------------------------------------ helpers
    def delay_ps(self, rel: float, vdd: float) -> float:
        return rel * self.tau_ps * delay_scale(vdd, self.vth, self.alpha)

    def energy_fj(self, rel: float, vdd: float) -> float:
        return rel * self.eps_fj * energy_scale(vdd)

    def fmax_hz(self, crit_path_rel: float, vdd: float) -> float:
        """Max clock for a critical path of ``crit_path_rel`` tau units."""
        d = self.delay_ps(crit_path_rel, vdd)
        return 1e12 / d

    def leakage_mw(self, area_um2: float, vdd: float) -> float:
        return area_um2 * self.leak_mw_per_um2 * leakage_scale(vdd)

    def with_calibration(self, tau_ps: float, eps_fj: float,
                         apr_overhead: float) -> "TechModel":
        return dataclasses.replace(self, tau_ps=tau_ps, eps_fj=eps_fj,
                                   apr_overhead=apr_overhead)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

# Anchors from the paper (see module docstring).
F_ANCHOR_HZ = 1.1e9        # @ 1.2 V           (Fig. 9)
V_ANCHOR = 1.2
F_LOW_HZ = 300e6           # @ 0.7 V           (Fig. 9) — check, not a knob
V_LOW = 0.7
EEFF_ANCHOR_TOPS_W = 1921.0  # 1b-1b scaled, INT4, 12.5%/50% activity @ 0.7 V
AREA_ANCHOR_UM2 = 0.112e6    # 64x64 MCR=2 macro (Fig. 10)


def _check_shmoo_consistency() -> float:
    """The (Vth, alpha) pair must map 1.1 GHz @1.2 V to ~300 MHz @0.7 V."""
    ratio = delay_scale(V_LOW) / delay_scale(V_ANCHOR)
    f_low_pred = F_ANCHOR_HZ / ratio
    return f_low_pred


def calibrated_tech(reference_crit_rel: float | None = None,
                    reference_e_cycle_rel: float | None = None,
                    reference_area_um2: float | None = None) -> TechModel:
    """Solve (tau_ps, eps_fj, apr_overhead) so the reference 64x64 macro hits
    the silicon anchors.

    Callers from :mod:`repro_torch.core.macro` pass the reference design's critical
    path (in tau), per-cycle energy (in eps, already activity-weighted at the
    Table II measurement conditions) and placed area; this function returns a
    TechModel whose units make those equal the measured values.  Called with
    no arguments it returns the uncalibrated base model (unit knobs).
    """
    base = TechModel()
    if reference_crit_rel is None:
        return base

    # tau: critical path at V_ANCHOR must be 1/F_ANCHOR.
    target_delay_ps = 1e12 / F_ANCHOR_HZ
    tau = target_delay_ps / (reference_crit_rel * delay_scale(V_ANCHOR))

    # eps: per-cycle energy at V_LOW must give EEFF_ANCHOR at 1b-1b scaling.
    #   TOPS(1b) = 2*H*W*f ; P = E_cycle * f  =>  TOPS/W = 2*H*W / E_cycle
    #   => E_cycle(V_LOW) = 2*4096 / 1921e12  J = 4.264 pJ
    eps = 1.0
    if reference_e_cycle_rel and reference_e_cycle_rel > 0:
        e_cycle_target_fj = 2.0 * 64 * 64 / (EEFF_ANCHOR_TOPS_W * 1e12) * 1e15
        eps = e_cycle_target_fj / (reference_e_cycle_rel * energy_scale(V_LOW))

    apr = 1.0
    if reference_area_um2 and reference_area_um2 > 0:
        apr = AREA_ANCHOR_UM2 / reference_area_um2

    return base.with_calibration(tau_ps=tau, eps_fj=eps, apr_overhead=apr)
