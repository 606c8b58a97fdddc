"""Spec-batched co-synthesis engine (multi-spec-oriented synthesis at scale).

The paper's pitch is *multi-spec-oriented* synthesis: one compiler run serves
many deployment scenarios (§I names vision, language, cloud and wearable
workloads with distinct PPA postures).  :mod:`repro_torch.core.batched`
evaluates the full design lattice for ONE spec; this module is the **"vmap"
strategy** over the shared execution engine (:mod:`repro_torch.core.engine`):
specs are grouped by lattice signature, each group's subcircuit tables are
stacked along a leading spec axis, and the same float64 roll-up kernel runs
once over the stack, so N macro specs are synthesized in one fused pass:

  ``evaluate_many``
      plan + execute through the engine with the "vmap" strategy.  The
      kernel and the numpy roll-up tail are the *same code* the single-spec
      engine runs, so per-spec results are bit-identical to
      :func:`repro_torch.core.batched.evaluate`.

  ``mso_search_many``
      Algorithm 1 replayed per spec against the fused evaluation — frontiers
      are bit-identical to looping ``mso_search(backend="batched")`` over the
      specs, at a fraction of the dispatch cost.

  ``design_space_sweep_many``
      exhaustive multi-spec sweeps with chunked Pareto extraction sized for
      the device's memory budget
      (:func:`repro_torch.core.pareto.pareto_chunk_size`).

  ``scenario_specs``
      the §I deployment scenarios as concrete :class:`MacroSpec` values — the
      default multi-spec synthesis set for serving-time macro selection.

Grouping, packing and the shared numpy tail live in the engine layer
(:func:`repro_torch.core.engine.pack_group` and friends); this module keeps
only the multi-spec entry points and the scenario/frontier-pooling helpers.
Every entry point that evaluates takes ``device=`` (``None``: the CUDA card).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..device import resolve_device
from . import batched as B
from . import engine as E
from . import subcircuits as sc
from .batched import BatchedPPA, BatchedSweep, DesignLattice, SpecTables
from .macro import MacroSpec
from .pareto import PARETO_EPS, nondominated_mask_auto
from .searcher import SearchResult
from .tech import TechModel

def scenario_specs() -> dict[str, MacroSpec]:
    """The paper's §I deployment scenarios as compiler inputs.

    One shared geometry (64x64, INT + FP4/FP8) with scenario-specific
    postures, so all four land in one vmap group:

      vision    edge camera pipelines — the Fig. 8 balanced spec.
      language  LLM decode — MCR=4 buys weight residency for big GEMMs.
      cloud     datacenter throughput — 1.1 GHz at nominal-high voltage.
      wearable  always-on low power — 250 MHz at 0.7 V.
    """
    return {
        "vision": MacroSpec(h=64, w=64, mcr=2, int_precisions=(4, 8),
                            fp_precisions=("FP4", "FP8"), f_mac_hz=800e6,
                            f_wupdate_hz=800e6, vdd=0.9),
        "language": MacroSpec(h=64, w=64, mcr=4, int_precisions=(4, 8),
                              fp_precisions=("FP4", "FP8"), f_mac_hz=800e6,
                              f_wupdate_hz=100e6, vdd=0.9),
        "cloud": MacroSpec(h=64, w=64, mcr=2, int_precisions=(4, 8),
                           fp_precisions=("FP4", "FP8"), f_mac_hz=1.1e9,
                           f_wupdate_hz=1.1e9, vdd=1.2),
        "wearable": MacroSpec(h=64, w=64, mcr=2, int_precisions=(2, 4),
                              fp_precisions=("FP4", "FP8"), f_mac_hz=250e6,
                              f_wupdate_hz=250e6, vdd=0.7),
    }


# ---------------------------------------------------------------------------
# Multi-spec evaluation + search + sweep entry points
# ---------------------------------------------------------------------------


def evaluate_many(specs: Sequence[MacroSpec], tech: TechModel,
                  memcells: tuple[sc.MemCellKind, ...] = B.MEMCELLS,
                  config: B.LatticeConfig | None = None, device=None
                  ) -> list[tuple[DesignLattice, SpecTables, BatchedPPA]]:
    """Evaluate every design point of every spec on ``device``, batching
    same-shape specs through one spec-stacked kernel launch.  Results are
    returned in input order and are bit-identical per spec to
    :func:`repro_torch.core.batched.evaluate`.  ``config`` selects the
    registered axis set (seed when None)."""
    return E.execute(E.plan(list(specs), tech, tuple(memcells), mode="vmap",
                            device=device, config=config))


def mso_search_many(specs: Sequence[MacroSpec], scl=None,
                    tech: TechModel = None, resolution: int = 4,
                    config: B.LatticeConfig | None = None, device=None
                    ) -> list[SearchResult]:
    """Synthesize N macro specs in one fused pass.

    Per-spec results (explored set, frontier, every PPA field) are
    bit-identical to looping ``mso_search(spec, backend="batched")`` — the
    spec-stacked kernel and shared roll-up tail compute the same float64
    arithmetic; only the dispatch is fused.  ``scl`` is accepted for
    signature parity with :func:`repro_torch.core.searcher.mso_search`."""
    if tech is None:
        raise ValueError("tech model required")
    evals = evaluate_many(specs, tech, memcells=(sc.MemCellKind.SRAM_6T,),
                          config=config, device=device)
    return [B._alg1_replay(lat, tab, T, resolution)
            for lat, tab, T in evals]


def design_space_sweep_many(specs: Sequence[MacroSpec], tech: TechModel,
                            memcells: tuple[sc.MemCellKind, ...] = B.MEMCELLS,
                            config: B.LatticeConfig | None = None,
                            device=None) -> list[BatchedSweep]:
    """Exhaustive sweeps for N specs in one fused pass on ``device`` (the
    multi-spec counterpart of
    :func:`repro_torch.core.batched.design_space_sweep`)."""
    dev = resolve_device(device)
    return [BatchedSweep(lattice=lat, tables=tab, ppa=T, device=dev)
            for lat, tab, T in evaluate_many(specs, tech, memcells,
                                             config=config, device=dev)]


def frontier_union(results: Iterable[SearchResult],
                   names: Sequence[str] | None = None,
                   extract: bool = False, eps: float = PARETO_EPS):
    """Union of per-spec frontiers, deduplicated by (spec, design name) — the
    serving-time candidate pool for cross-workload co-design.  Points from
    different specs always stay distinct (a design name does not encode its
    spec's geometry or constraints).

    With ``names`` (one label per result), returns ``(pool, labels)`` where
    each pool entry is labeled ``"<name>/<design name>"`` by the first result
    that contributed it; without, returns the pool alone.

    With ``extract=True`` the pooled points are additionally filtered to the
    *pooled* Pareto frontier under the shared ``eps`` band and the searcher's
    objective tuple (energy/cycle INT-lo, area, period) — a per-spec frontier
    point eps-dominated by another spec's point is dropped
    (:func:`repro_torch.core.pareto.nondominated_mask_auto`); pool order is
    preserved."""
    results = list(results)
    if names is not None and len(names) != len(results):
        raise ValueError("names must match results one-to-one")
    pool, labels, seen = [], [], set()
    for ri, res in enumerate(results):
        for p in res.frontier:
            key = (p.design.spec, p.design.name())
            if key not in seen:
                seen.add(key)
                pool.append(p)
                if names is not None:
                    labels.append(f"{names[ri]}/{p.design.name()}")
    if extract and pool:
        objs = np.asarray([(p.e_cycle_fj["int_lo"], p.area_um2,
                            1.0 / p.fmax_hz) for p in pool])
        mask = nondominated_mask_auto(objs, eps)
        pool = [p for p, keep in zip(pool, mask) if keep]
        labels = [lb for lb, keep in zip(labels, mask) if keep]
    return pool if names is None else (pool, labels)
