"""Bit-wise carry-save adder-tree designs (paper Fig. 4 / §III-B).

The paper's adder-tree contribution is a *family* of bit-wise CSAs mixing 4-2
compressors (power/area-efficient but slow) with full adders (fast but
costlier), plus two structural optimizations:

  * **port reordering** — carry outputs are faster than sum outputs, so
    re-wiring cell-to-cell connections to put late-arriving signals on
    fast-propagating ports shaves the critical path (~10%);
  * **retiming** — the register at the tree output can be moved *before* the
    final ripple-carry stage (tt2 in Alg. 1), removing the RCA from the MAC
    critical path at the cost of one extra pipeline register stage.

``CSADesign`` captures one point in that family; :func:`characterize` returns
its PPA.  ``build_netlist`` emits a gate-level structural netlist for the
functional simulator (``repro.core.gatesim``), which is how we validate that
synthesized trees actually compute Σ (the paper's post-synthesis gate-level
simulation stage).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .tech import TechModel

# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CSADesign:
    """One adder-tree design point.

    Attributes:
      rho:        fraction of reduction done by 4-2 compressors (1.0 = the
                  all-compressor tree of [11]; 0.0 = all-FA Wallace-style).
      reorder:    carry/sum port-delay-aware reordering (Fig. 4 right).
      retimed:    register moved before the final RCA stage (tt2).
      split:      column split factor (tt3): H rows are reduced by ``split``
                  independent sub-trees whose outputs merge in a registered
                  CSA stage; halving tree height shortens the critical path
                  at +1 cycle latency.
    """

    rho: float = 1.0
    reorder: bool = False
    retimed: bool = False
    split: int = 1

    def name(self) -> str:
        tag = f"csa_rho{int(round(self.rho * 100)):03d}"
        if self.reorder:
            tag += "_ro"
        if self.retimed:
            tag += "_rt"
        if self.split > 1:
            tag += f"_sp{self.split}"
        return tag


@dataclass(frozen=True)
class CSAReport:
    """PPA of one characterized tree (relative units; see tech.py)."""

    crit_path_rel: float        # tau units: operands-in -> registered output
    energy_rel: float           # eps units per cycle at 100% activity
    area_um2: float
    n_fa: int
    n_comp42: int
    n_ha: int
    n_reg_bits: int
    stages: int
    latency_cycles: int         # pipeline latency through the tree
    acc_width: int              # output width (bits)
    rca_width: int              # final RCA width


# ---------------------------------------------------------------------------
# Analytical characterization
# ---------------------------------------------------------------------------


def characterize(design: CSADesign, h_rows: int, product_bits: int,
                 tech: TechModel) -> CSAReport:
    """Analytical PPA of ``design`` reducing ``h_rows`` products of
    ``product_bits`` bits each.

    Modeling note (matches the paper's qualitative claims, §III-B): the tree
    *structure* is the 4-2 reduction tree of [11] — ceil(log2(H/2)) levels,
    each halving the operand count.  The mix parameter ``rho`` substitutes
    compressors with rebalanced full-adder pairs along the critical path:
    FA-based stage variants approach single-FA sum delay (faster), at ~2x the
    cells of a compressor (more power/area) — "for strict timing constraints,
    we replace 4-2 compressors with full adders to shorten the critical path,
    sacrificing power and area".
    """
    if h_rows < 2:
        raise ValueError(f"adder tree needs >= 2 rows, got {h_rows}")
    split = max(1, min(design.split, h_rows // 4 if h_rows >= 8 else 1))
    rows_per_tree = math.ceil(h_rows / split)

    # 4-2 tree structure: each level halves the operand count down to 2.
    n_stages = max(1, math.ceil(math.log2(max(2, rows_per_tree) / 2.0)))
    # Total 4->2 compression units: each removes 2 operands.
    n_units = max(1, (rows_per_tree - 2 + 1) // 2) * split

    # Bit growth: products enter at product_bits; widths grow ~1 bit per
    # stage of reduction.  Average active width across the tree:
    acc_width = product_bits + math.ceil(math.log2(max(2, h_rows)))
    avg_width = product_bits + math.ceil(math.log2(max(2, rows_per_tree))) / 2.0

    n_comp = int(round(n_units * design.rho))
    n_fapair = n_units - n_comp          # each realized as 2 full adders
    n_ha = n_stages * split              # column-edge half adders

    # Scale cell counts by bit width (cells are per bit column).
    n_comp_bits = int(round(n_comp * avg_width))
    n_fa_bits = int(round(n_fapair * 2 * avg_width))
    n_ha_bits = n_ha

    # --- critical path -----------------------------------------------------
    d_comp = tech.d_comp42_sum
    d_fa = tech.d_fa_sum
    if design.reorder:
        # Late signals wired onto carry ports: effective per-stage delay moves
        # toward the carry path.  (~10% observed in the paper's family.)
        d_comp = 0.65 * tech.d_comp42_sum + 0.35 * tech.d_comp42_carry
        d_fa = 0.65 * tech.d_fa_sum + 0.35 * tech.d_fa_carry
    # Critical-path cells interpolate from all-compressor (rho=1) to
    # rebalanced-FA (rho=0) stage variants.
    d_stage = design.rho * d_comp + (1.0 - design.rho) * d_fa
    tree_delay = d_stage * n_stages

    rca_width = acc_width
    rca_delay = tech.d_rca_per_bit * rca_width + tech.d_fa_sum

    # Split-merge: sub-tree outputs merge in their own *registered* CSA stage.
    merge_delay = 0.0
    latency = 1  # tree output register
    if split > 1:
        merge_delay = d_stage * math.ceil(math.log2(split)) * 2  # CS pairs
        latency += 1

    if design.retimed:
        # Register before the RCA: the RCA becomes its own pipeline stage.
        crit = max(tree_delay, merge_delay, rca_delay) + tech.d_reg_cq_su
        latency += 1
    else:
        crit = max(tree_delay, merge_delay + rca_delay) + tech.d_reg_cq_su
        if split == 1:
            crit = tree_delay + rca_delay + tech.d_reg_cq_su

    # --- energy (per cycle, 100% activity; caller applies activity factor) --
    energy = (n_comp_bits * tech.e_comp42 + n_fa_bits * tech.e_fa
              + n_ha_bits * tech.e_ha)
    energy += rca_width * tech.e_fa * split  # final RCA(s)
    n_reg_bits = acc_width * 2 * split  # carry-save pair registered
    if design.retimed:
        n_reg_bits += acc_width * split
    energy += n_reg_bits * (tech.e_reg * 0.25 + tech.e_clk_per_reg)

    # --- area ----------------------------------------------------------------
    area = (n_comp_bits * tech.a_comp42 + n_fa_bits * tech.a_fa
            + n_ha_bits * tech.a_ha + rca_width * tech.a_fa * split
            + n_reg_bits * tech.a_reg)

    return CSAReport(
        crit_path_rel=crit,
        energy_rel=energy,
        area_um2=area,
        n_fa=n_fa_bits,
        n_comp42=n_comp_bits,
        n_ha=n_ha_bits,
        n_reg_bits=n_reg_bits,
        stages=n_stages + (1 if split > 1 else 0),
        latency_cycles=latency,
        acc_width=acc_width,
        rca_width=rca_width,
    )


# Standard design-point family offered by the SCL (paper Fig. 4: "a series of
# bit-wise CSAs tailored for different PPA preferences").
FAMILY: tuple[CSADesign, ...] = tuple(
    CSADesign(rho=rho, reorder=ro, retimed=rt)
    for rho in (1.0, 0.75, 0.5, 0.25, 0.0)
    for ro in (False, True)
    for rt in (False, True)
)

# Column-split factors reachable by Alg. 1's tt3 transform (split < 4 guard).
SPLIT_STEPS: tuple[int, ...] = (1, 2, 4)


def valid_splits(h_rows: int) -> tuple[int, ...]:
    """Splits for which ``characterize`` does not clamp and tt3's
    ``h // (split) >= 4`` feasibility holds — the discrete split axis of the
    batched design lattice."""
    return tuple(s for s in SPLIT_STEPS if s == 1 or h_rows // s >= 4)


# ---------------------------------------------------------------------------
# Gate-level netlist construction (for repro.core.gatesim)
# ---------------------------------------------------------------------------


@dataclass
class Gate:
    kind: str                   # 'FA' | 'HA' | 'C42' | 'BUF'
    ins: list[str]
    outs: list[str]             # FA/HA/C42: [sum, carry(, cout)]


@dataclass
class TreeNetlist:
    """Structural netlist of one adder tree at a single bit-column granularity
    abstracted to operand granularity: each wire carries a full integer lane.

    gatesim evaluates it with integer carry-save semantics: an FA node maps
    (a, b, c) -> (a^b^c, majority<<1); a 4-2 compressor maps 5 inputs to
    (sum, carry<<1, cout<<1) using two chained FAs — exactly the paper's
    "4-2 compressor as a 5-3 carry-save adder" construction.
    """

    n_inputs: int
    gates: list[Gate] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)


def build_netlist(design: CSADesign, h_rows: int) -> TreeNetlist:
    """Build an executable carry-save reduction netlist for ``h_rows`` operand
    lanes following the design's reduction schedule."""
    nl = TreeNetlist(n_inputs=h_rows)
    wires = [f"in{i}" for i in range(h_rows)]
    uid = 0

    def fresh(prefix: str) -> str:
        nonlocal uid
        uid += 1
        return f"{prefix}{uid}"

    cout_carry = None  # chain compressor cout within a stage
    while len(wires) > 2:
        nxt: list[str] = []
        i = 0
        n = len(wires)
        want_comp_in = int(round(design.rho * n / 4.0)) * 4
        want_comp_in = min(want_comp_in, (n // 4) * 4)
        ncomp = want_comp_in // 4
        cout_carry = None
        for _ in range(ncomp):
            a, b, c, d = wires[i:i + 4]
            i += 4
            cin = cout_carry if cout_carry is not None else "zero"
            s, cy, co = fresh("s"), fresh("c"), fresh("co")
            nl.gates.append(Gate("C42", [a, b, c, d, cin], [s, cy, co]))
            nxt += [s, cy]
            cout_carry = co
        if cout_carry is not None:
            nxt.append(cout_carry)
            cout_carry = None
        while len(wires) - i >= 3:
            a, b, c = wires[i:i + 3]
            i += 3
            s, cy = fresh("s"), fresh("c")
            nl.gates.append(Gate("FA", [a, b, c], [s, cy]))
            nxt += [s, cy]
        nxt += wires[i:]
        if len(nxt) >= len(wires):  # force progress on degenerate mixes
            a, b, c = nxt[0], nxt[1], nxt[2] if len(nxt) > 2 else "zero"
            s, cy = fresh("s"), fresh("c")
            nl.gates.append(Gate("FA", [a, b, c], [s, cy]))
            nxt = [s, cy] + nxt[3:]
        wires = nxt
    # Final RCA: modeled as one ADD node (gatesim evaluates exactly).
    out = fresh("rca")
    nl.gates.append(Gate("RCA", list(wires), [out]))
    nl.outputs = [out]
    return nl
