"""Subcircuit Library (SCL) with PPA lookup tables (paper §III-B, Fig. 3).

The paper characterizes each subcircuit topology over grids of dimensions and
timing constraints into PPA LUTs ("custom cell characterization flow" for
array cells, "parameterized RTL templates ... estimated and scaled from
synthesis data" for digital blocks).  This module reproduces that flow:

  * :meth:`SubcircuitLibrary.build` runs the characterization sweep once and
    stores PPA records keyed by (type, variant, dims, ...) — the LUT.
  * Queries hit the LUT when the key is on-grid and otherwise *scale* from the
    analytical model (the paper's own fallback for off-grid configurations).
  * ``query_adder_trees`` is the searcher's entry point for "check if faster
    adders are available in the SCL" (Alg. 1, tt1).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import csa as csa_mod
from . import subcircuits as sc
from .tech import TechModel

DIM_GRID = (16, 32, 64, 128, 256, 512)
MCR_GRID = (1, 2, 4, 8)


@dataclass(frozen=True)
class LUTRecord:
    key: tuple
    delay_rel: float
    energy_rel: float
    area_um2: float
    latency_cycles: int
    meta: tuple = ()


class SubcircuitLibrary:
    """Characterized PPA LUTs for all seven subcircuit types."""

    def __init__(self, tech: TechModel):
        self.tech = tech
        self.lut: dict[tuple, LUTRecord] = {}
        self._built = False

    # ------------------------------------------------------------------ build
    def build(self) -> "SubcircuitLibrary":
        t = self.tech
        # Memory cells.
        for kind in sc.MemCellKind:
            p = sc.memcell_ppa(kind, t)
            self._put((sc.SC.MEMCELL, kind.value), p)
        # Multiplier + multiplexer variants x MCR.
        for kind in sc.MultMuxKind:
            for mcr in MCR_GRID:
                if not sc.multmux_valid(kind, mcr):
                    continue
                p = sc.multmux_ppa(kind, mcr, t)
                self._put((sc.SC.MULTMUX, kind.value, mcr), p)
        # Adder trees: full CSA family x row counts.
        for design in csa_mod.FAMILY:
            for h in DIM_GRID:
                p, rep = sc.adder_tree_ppa(design, h, 2, t)
                self._put((sc.SC.ADDER_TREE, design.name(), h), p,
                          meta=(design,))
        # Drivers.
        for h in DIM_GRID:
            for w in DIM_GRID:
                for mcr in MCR_GRID:
                    self._put((sc.SC.WLBL_DRIVER, "wl", h, w, mcr),
                              sc.wl_driver_ppa(h, w, mcr, t))
                    self._put((sc.SC.WLBL_DRIVER, "bl", h, w, mcr),
                              sc.bl_driver_ppa(h, w, mcr, t))
        # Shift & adder over accumulator widths x input bits.
        for acc_w in range(6, 22, 2):
            for ib in (1, 2, 4, 8, 16):
                self._put((sc.SC.SHIFT_ADDER, acc_w, ib),
                          sc.shift_adder_ppa(acc_w, ib, t))
        # OFU over widths x precision sets x pipeline stages.
        for w in DIM_GRID:
            for precs in ((1, 2, 4, 8), (4, 8), (8,), (2, 4), (1, 4, 8)):
                for ow in (12, 16, 20):
                    for ps in (0, 1, 2, 3):
                        self._put((sc.SC.OFU, w, precs, ow, ps),
                                  sc.ofu_ppa(w, precs, ow, ps, t))
        # Alignment units over width x FP format combos.
        combos = ((), ("FP4",), ("FP8",), ("BF16",), ("FP4", "FP8"),
                  ("FP8", "BF16"), ("FP4", "FP8", "BF16"))
        for w in DIM_GRID:
            for c in combos:
                self._put((sc.SC.ALIGN, w, c), sc.align_ppa(w, c, t))
        self._built = True
        return self

    def _put(self, key: tuple, p: sc.PPA, meta: tuple = ()) -> None:
        self.lut[key] = LUTRecord(key, p.delay_rel, p.energy_rel, p.area_um2,
                                  p.latency_cycles, meta or p.meta)

    # ---------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self.lut)

    def get(self, key: tuple) -> LUTRecord | None:
        return self.lut.get(key)

    def adder_tree(self, design: csa_mod.CSADesign, h: int) -> LUTRecord:
        """LUT hit when on-grid; otherwise scaled from the model (the paper's
        'estimated and scaled from synthesis data' path)."""
        rec = self.lut.get((sc.SC.ADDER_TREE, design.name(), h))
        if rec is not None:
            return rec
        p, rep = sc.adder_tree_ppa(design, h, 2, self.tech)
        return LUTRecord((sc.SC.ADDER_TREE, design.name(), h), p.delay_rel,
                         p.energy_rel, p.area_um2, p.latency_cycles, (design,))

    def query_adder_trees(self, h: int, max_delay_rel: float | None = None,
                          ) -> list[tuple[csa_mod.CSADesign, LUTRecord]]:
        """All tree designs for ``h`` rows meeting ``max_delay_rel``, sorted by
        energy (the searcher picks the most efficient one that meets timing)."""
        out = []
        for design in csa_mod.FAMILY:
            rec = self.adder_tree(design, h)
            if max_delay_rel is None or rec.delay_rel <= max_delay_rel:
                out.append((design, rec))
        out.sort(key=lambda dr: (dr[1].energy_rel, dr[1].area_um2))
        return out

    def fastest_adder_tree(self, h: int) -> tuple[csa_mod.CSADesign, LUTRecord]:
        best = None
        for design in csa_mod.FAMILY:
            rec = self.adder_tree(design, h)
            if best is None or rec.delay_rel < best[1].delay_rel:
                best = (design, rec)
        return best
