"""SDP-style structured placement (paper §III-D / Fig. 6).

The paper places the SRAM array with a scalable Structured-Data-Path TCL
script in Innovus ("regular SRAM place and uniform routing"), fills the gaps
between SRAM columns with adder cells, and APRs the peripherals around the
array.  This module reproduces that stage as an executable floorplanner:

  * deterministic coordinates for every placement region (SRAM banks,
    per-column adder strips, S&A row, OFU/alignment block, WL/BL drivers),
  * aspect-ratio solving against the measured die (455 x 246 um for the
    64x64 MCR=2 macro — Fig. 10),
  * DEF-flavored emission + the SDP script skeleton,
  * overlap/containment invariants checked by tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .macro import MacroPPA

# Fabricated macro footprint (Fig. 10): 455 x 246 um.
DIE_W_UM = 455.0
DIE_H_UM = 246.0


@dataclass(frozen=True)
class Region:
    name: str
    x: float
    y: float
    w: float
    h: float

    @property
    def area(self) -> float:
        return self.w * self.h

    def overlaps(self, other: "Region") -> bool:
        return not (self.x + self.w <= other.x + 1e-9 or
                    other.x + other.w <= self.x + 1e-9 or
                    self.y + self.h <= other.y + 1e-9 or
                    other.y + other.h <= self.y + 1e-9)


@dataclass
class Floorplan:
    die_w: float
    die_h: float
    regions: list[Region] = field(default_factory=list)

    @property
    def utilization(self) -> float:
        return sum(r.area for r in self.regions) / (self.die_w * self.die_h)

    def region(self, name: str) -> Region:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(name)


def place(ppa: MacroPPA) -> Floorplan:
    """Deterministic SDP placement for a synthesized macro.

    Layout (bottom-up, mirroring Fig. 6): BL drivers | interleaved
    [SRAM bank row / adder strip] per column group | S&A row | OFU+alignment |
    WL drivers on the left flank.
    """
    spec = ppa.design.spec
    bd = ppa.area_breakdown
    total = sum(bd.values())
    # scale the analytical areas onto the measured die aspect
    die_scale = (ppa.area_um2 / total) if total else 1.0
    die_w = DIE_W_UM * math.sqrt(ppa.area_um2 / (DIE_W_UM * DIE_H_UM * 1.0))
    die_h = ppa.area_um2 / die_w

    wl_w = bd["drivers"] * die_scale * 0.55 / die_h
    x0 = wl_w
    usable_w = die_w - wl_w

    regions = [Region("wl_drivers", 0.0, 0.0, wl_w, die_h)]

    # bottom: BL drivers strip
    bl_h = bd["drivers"] * die_scale * 0.45 / usable_w
    regions.append(Region("bl_drivers", x0, 0.0, usable_w, bl_h))
    y = bl_h

    # interleaved SRAM + adder strips: one pair per column group (SDP rows)
    array_area = (bd["sram_array"] + bd["multmux"]) * die_scale
    adder_area = bd["adder_tree"] * die_scale
    groups = max(1, spec.w // 16)            # 16 columns per SDP group
    pair_h = (array_area + adder_area) / usable_w / groups
    sram_frac = array_area / (array_area + adder_area)
    for g in range(groups):
        regions.append(Region(f"sram_bank_{g}", x0, y,
                              usable_w, pair_h * sram_frac))
        y += pair_h * sram_frac
        regions.append(Region(f"adder_strip_{g}", x0, y,
                              usable_w, pair_h * (1 - sram_frac)))
        y += pair_h * (1 - sram_frac)

    # S&A row
    sa_h = bd["shift_adder"] * die_scale / usable_w
    regions.append(Region("shift_adder", x0, y, usable_w, sa_h))
    y += sa_h
    # OFU + alignment block at the top
    top_h = (bd["ofu"] + bd["align"]) * die_scale / usable_w
    regions.append(Region("ofu_align", x0, y, usable_w, top_h))
    y += top_h

    return Floorplan(die_w=die_w, die_h=max(die_h, y), regions=regions)


def emit_def(fp: Floorplan, name: str = "dcim_macro") -> str:
    """DEF-flavored text (units: nm)."""
    lines = [f"VERSION 5.8 ;", f"DESIGN {name} ;", "UNITS DISTANCE MICRONS 1000 ;",
             f"DIEAREA ( 0 0 ) ( {int(fp.die_w * 1000)} {int(fp.die_h * 1000)} ) ;",
             f"REGIONS {len(fp.regions)} ;"]
    for r in fp.regions:
        lines.append(f"- {r.name} ( {int(r.x * 1000)} {int(r.y * 1000)} ) "
                     f"( {int((r.x + r.w) * 1000)} {int((r.y + r.h) * 1000)} ) ;")
    lines.append("END REGIONS")
    lines.append("END DESIGN")
    return "\n".join(lines)


def emit_sdp_script(ppa: MacroPPA) -> str:
    """The scalable SDP TCL skeleton of §III-D (documentation artifact)."""
    spec = ppa.design.spec
    return "\n".join([
        "# SynDCIM structured-data-path placement (Innovus)",
        f"set H {spec.h}; set W {spec.w}; set MCR {spec.mcr}",
        "createInstGroup sram_array -region [dcim_region sram]",
        "foreach col [dcim_columns $W] {",
        "  sdpCreateGroup -name bank_$col -object [dcim_cells sram $col]",
        "  sdpCreateGroup -name csa_$col  -object [dcim_cells adder $col]",
        "}",
        "sdpPlace -pattern interleave {bank csa}",
        "placeDesign -incremental   ;# peripherals APR'd around the array",
    ])
