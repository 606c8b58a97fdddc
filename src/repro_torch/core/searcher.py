"""Multi-Spec-Oriented (MSO) searcher — paper Algorithm 1 (§III-C).

Faithful implementation of the heuristic hierarchical search:

  Step 1  set subcircuit configuration from SPEC (defaults otherwise)
  Step 2  critical-path optimization
            MAC/adder path:  tt1 faster adders from SCL (incl. carry/sum port
                             reordering), tt2 retiming the output register
                             before the final RCA, tt3 column split H -> H/2
            OFU path:        tt4 retime combinational logic into the S&A,
                             tt5 add an extra OFU pipeline stage
  Step 3  latency optimization — remove pipeline registers between adder tree,
          S&A and OFU when the fused combinational path still meets timing
  Step 4  preference-oriented PPA fine-tuning ft1 (power), ft2 (area),
          ft3 (throughput)

Objective (verbatim from Alg. 1): minimize power/area such that
TOPS(Macro) > TOPS(SPEC).  The multi-spec sweep runs the hierarchy over a
preference grid and returns the Pareto frontier (Fig. 8).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from . import subcircuits as sc
from .csa import CSADesign
from .macro import (MacroDesign, MacroPPA, MacroSpec, rollup, timing_paths)
from .pareto import pareto_front, preference_grid
from .scl import SubcircuitLibrary
from .tech import TechModel, delay_scale

RHO_STEPS = (1.0, 0.75, 0.5, 0.25, 0.0)


@dataclass(frozen=True)
class SearchResult:
    spec: MacroSpec
    frontier: tuple[MacroPPA, ...]       # Pareto-optimal design points
    explored: tuple[MacroPPA, ...]       # everything evaluated (Fig. 8 scatter)
    n_evaluated: int


def max_crit_rel(spec: MacroSpec, tech: TechModel) -> float:
    """Clock-period budget in tau units at the spec voltage."""
    period_ps = 1e12 / spec.f_mac_hz
    return period_ps / (tech.tau_ps * delay_scale(spec.vdd, tech.vth, tech.alpha))


# ---------------------------------------------------------------------------
# Step 1 — subcircuit configuration from SPEC
# ---------------------------------------------------------------------------


def step1_initial_design(spec: MacroSpec,
                         overrides: dict | None = None) -> MacroDesign:
    """SPEC-defined configuration where given, defaults otherwise.

    Default posture is the power/area-lean corner: all-compressor CSA, TG+NOR
    mult/mux, 6T cells, no extra pipeline — Step 2 then *spends* power/area to
    buy timing only where needed.
    """
    overrides = overrides or {}
    d = MacroDesign(
        spec=spec,
        memcell=overrides.get("memcell", sc.MemCellKind.SRAM_6T),
        multmux=overrides.get("multmux", sc.MultMuxKind.TG_NOR),
        csa=overrides.get("csa", CSADesign(rho=1.0)),
        ofu_pipe_stages=overrides.get("ofu_pipe_stages", 0),
    )
    if not sc.multmux_valid(d.multmux, spec.mcr):
        d = replace(d, multmux=sc.MultMuxKind.TG_NOR)
        d = d.with_audit("step1: OAI22 invalid for MCR>2 -> TG_NOR")
    return d.with_audit(f"step1: init {d.name()}")


# ---------------------------------------------------------------------------
# Step 2 — critical-path optimization
# ---------------------------------------------------------------------------


def _mac_path_ok(design: MacroDesign, tech: TechModel, budget: float) -> bool:
    paths, _, _ = timing_paths(design, tech)
    return paths.mac_path_rel <= budget


def _ofu_path_ok(design: MacroDesign, tech: TechModel, budget: float) -> bool:
    paths, _, _ = timing_paths(design, tech)
    return max(paths.ofu_path_rel, paths.sa_path_rel) <= budget


def step2_critical_path(design: MacroDesign, scl: SubcircuitLibrary,
                        tech: TechModel, budget: float) -> MacroDesign:
    # ---- adder/MAC path: tt1 -> tt2 -> tt3 in sequence (Alg. 1) -------------
    guard = 0
    while not _mac_path_ok(design, tech, budget) and guard < 32:
        guard += 1
        csa = design.csa
        # tt1a: port reordering (free speedup from the SCL's characterized
        # carry-vs-sum path data).
        if not csa.reorder:
            design = replace(design, csa=replace(csa, reorder=True))
            design = design.with_audit("tt1: enable carry/sum port reordering")
            continue
        # tt1b: next-faster adder mix from the SCL.
        faster = [r for r in RHO_STEPS if r < csa.rho]
        if faster:
            design = replace(design, csa=replace(csa, rho=faster[0]))
            design = design.with_audit(f"tt1: faster adders rho={faster[0]}")
            continue
        # tt2: retime output register before the final RCA stage.
        if not csa.retimed:
            design = replace(design, csa=replace(csa, retimed=True))
            design = design.with_audit("tt2: retime register before final RCA")
            continue
        # tt3: split the column H -> H/2.
        if csa.split < 4 and design.spec.h // (csa.split * 2) >= 4:
            design = replace(design, csa=replace(csa, split=csa.split * 2))
            design = design.with_audit(f"tt3: column split -> {csa.split * 2}")
            continue
        design = design.with_audit("tt: MAC path UNMET (exhausted techniques)")
        break

    # Relaxation toward the Alg. 1 objective ("minimum power/area such that
    # TOPS(Macro) > TOPS(SPEC)"): once timing is met, walk the adder mix back
    # to the most compressor-heavy (cheapest) point that still meets.
    if _mac_path_ok(design, tech, budget):
        for rho in RHO_STEPS:  # descending: 1.0 first
            if rho <= design.csa.rho:
                break
            cand = replace(design, csa=replace(design.csa, rho=rho))
            if _mac_path_ok(cand, tech, budget):
                design = cand.with_audit(
                    f"tt1-relax: cheapest adder mix meeting timing rho={rho}")
                break

    # ---- OFU path: tt4 -> tt5 in sequence -----------------------------------
    guard = 0
    while not _ofu_path_ok(design, tech, budget) and guard < 8:
        guard += 1
        if not design.ofu_retimed_into_sa:
            cand = replace(design, ofu_retimed_into_sa=True)
            paths, _, _ = timing_paths(cand, tech)
            if max(paths.ofu_path_rel, paths.sa_path_rel) <= budget or \
                    paths.ofu_path_rel < timing_paths(design, tech)[0].ofu_path_rel:
                design = cand.with_audit("tt4: retime OFU logic into S&A")
                continue
        if design.ofu_pipe_stages < 3:
            design = replace(design, ofu_pipe_stages=design.ofu_pipe_stages + 1)
            design = design.with_audit(
                f"tt5: extra OFU pipeline stage -> {design.ofu_pipe_stages}")
            continue
        design = design.with_audit("tt: OFU path UNMET (exhausted techniques)")
        break
    return design


# ---------------------------------------------------------------------------
# Step 3 — latency optimization (register fusion)
# ---------------------------------------------------------------------------


def step3_latency(design: MacroDesign, tech: TechModel,
                  budget: float) -> MacroDesign:
    # Try fusing adder tree + S&A + OFU, then S&A + OFU (Alg. 1 order).
    full = replace(design, fuse_tree_sa=True, fuse_sa_ofu=True)
    paths, _, _ = timing_paths(full, tech)
    if paths.crit_rel <= budget:
        return full.with_audit("step3: fused adder+S&A+OFU registers")
    part = replace(design, fuse_sa_ofu=True)
    paths, _, _ = timing_paths(part, tech)
    if paths.crit_rel <= budget:
        return part.with_audit("step3: fused S&A+OFU registers")
    return design.with_audit("step3: no fusion possible -> power fine-tuning")


# ---------------------------------------------------------------------------
# Step 4 — preference-oriented fine-tuning
# ---------------------------------------------------------------------------


def _meets(design: MacroDesign, tech: TechModel, budget: float) -> bool:
    paths, _, _ = timing_paths(design, tech)
    return paths.crit_rel <= budget


def step4_fine_tune(design: MacroDesign, scl: SubcircuitLibrary,
                    tech: TechModel, budget: float,
                    prefs: tuple[float, float, float]) -> MacroDesign:
    w_power, w_area, w_tput = prefs
    # ft1 (power): substitute the most compressor-heavy CSA that still meets
    # timing; un-split columns and drop surplus OFU pipeline stages (register
    # + clock power) when slack allows.
    if w_power >= max(w_area, w_tput) * 0.999:
        for rho in RHO_STEPS:  # descending power cost
            if rho <= design.csa.rho:
                break
            cand = replace(design, csa=replace(design.csa, rho=rho))
            if _meets(cand, tech, budget):
                design = cand.with_audit(f"ft1: power — rho back up to {rho}")
                break
        while design.csa.split > 1:
            cand = replace(design, csa=replace(design.csa,
                                               split=design.csa.split // 2))
            if _meets(cand, tech, budget):
                design = cand.with_audit("ft1: power — un-split column")
            else:
                break
        while design.ofu_pipe_stages > 0:
            cand = replace(design, ofu_pipe_stages=design.ofu_pipe_stages - 1)
            if _meets(cand, tech, budget):
                design = cand.with_audit("ft1: power — drop OFU pipe stage")
            else:
                break
    # ft2 (area): area-efficient mult/mux substitution; prefer the fused OAI22
    # when MCR allows, the 1T pass gate when area dominates everything.
    if w_area > 0:
        if design.spec.mcr <= 2:
            cand = replace(design, multmux=sc.MultMuxKind.OAI22_FUSED)
            if _meets(cand, tech, budget) and w_area >= w_power:
                design = cand.with_audit("ft2: area — OAI22 fused mult/mux")
        if w_area > max(w_power, w_tput) and design.multmux is not sc.MultMuxKind.PASS_1T:
            cand = replace(design, multmux=sc.MultMuxKind.PASS_1T)
            if _meets(cand, tech, budget):
                design = cand.with_audit("ft2: area — 1T pass-gate mux")
        while w_area >= max(w_power, w_tput) and design.csa.split > 1:
            cand = replace(design, csa=replace(design.csa,
                                               split=design.csa.split // 2))
            if _meets(cand, tech, budget):
                design = cand.with_audit("ft2: area — un-split column")
            else:
                break
    return design


def _throughput_overdrive(prefs: tuple[float, float, float]) -> float:
    """ft3: throughput-leaning preferences retarget synthesis to a frequency
    above spec (the paper's right-corner, high-throughput designs).  Returns
    the frequency multiplier (1.0 = exactly the spec)."""
    w_power, w_area, w_tput = prefs
    if w_tput <= max(w_power, w_area):
        return 1.0
    return 1.0 + 0.35 * w_tput


# ---------------------------------------------------------------------------
# Full hierarchy + multi-spec sweep
# ---------------------------------------------------------------------------


def synthesize_one(spec: MacroSpec, scl: SubcircuitLibrary, tech: TechModel,
                   prefs: tuple[float, float, float],
                   overrides: dict | None = None) -> MacroPPA:
    # ft3 manifests as an overdriven timing target for throughput-leaning
    # preference corners.
    overdrive = _throughput_overdrive(prefs)
    budget = max_crit_rel(spec, tech) / overdrive
    d = step1_initial_design(spec, overrides)
    if overdrive > 1.0:
        d = d.with_audit(f"ft3: throughput overdrive x{overdrive:.2f} "
                         f"(target {spec.f_mac_hz * overdrive / 1e6:.0f} MHz)")
    d = step2_critical_path(d, scl, tech, budget)
    d = step3_latency(d, tech, budget)
    d = step4_fine_tune(d, scl, tech, budget, prefs)
    return rollup(d, tech)


def mso_search(spec: MacroSpec, scl: SubcircuitLibrary, tech: TechModel,
               resolution: int = 4, backend: str = "scalar",
               device=None) -> SearchResult:
    """Sweep the PPA-preference simplex, synthesize each corner, and return
    the Pareto frontier over (energy/op, area, period).

    ``backend="scalar"`` runs the reference per-point hierarchy (this module,
    host Python; ``device`` is not read);
    ``backend="batched"`` evaluates the whole design lattice in one fused pass
    on ``device`` and replays the hierarchy as masked selection (identical
    frontier, see :mod:`repro_torch.core.batched`).  ``device=None`` means the
    CUDA card and raises where there is none.
    """
    if backend == "batched":
        from .batched import mso_search_batched
        return mso_search_batched(spec, scl, tech, resolution, device=device)
    if backend != "scalar":
        raise ValueError(f"unknown mso_search backend: {backend!r}")
    explored: list[MacroPPA] = []
    seen: set[str] = set()
    for prefs in preference_grid(resolution):
        ppa = synthesize_one(spec, scl, tech, prefs)
        if ppa.design.name() not in seen:
            seen.add(ppa.design.name())
            explored.append(ppa)

    feasible = [p for p in explored if p.meets_timing]
    pool = feasible if feasible else explored

    def objectives(p: MacroPPA) -> tuple[float, float, float]:
        e_per_cycle = p.e_cycle_fj["int_lo"]
        return (e_per_cycle, p.area_um2, 1.0 / p.fmax_hz)

    frontier = pareto_front(pool, objectives)
    return SearchResult(spec=spec, frontier=tuple(frontier),
                        explored=tuple(explored), n_evaluated=len(explored))
