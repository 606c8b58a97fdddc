"""Serving-time DCIM macro selection over the multi-spec synthesized frontier.

The compiler side synthesizes N scenario specs in one fused pass
(:func:`repro_torch.core.multispec.mso_search_many`); the serving side must then
answer "which synthesized macro runs *this* deployed workload best?".  This
module is that bridge: it pools the per-spec Pareto frontiers, batch-maps
every deployed workload's GEMM inventory onto every candidate
(:func:`repro_torch.core.dse.cross_workload_codesign` — which applies the same
timing-clamp as the scalar reports), and assigns each workload a macro.

Selection is preference-aware: a ``preference`` weight vector over
(wallclock, energy, area) scalarizes the candidates *restricted to the
pooled per-workload Pareto frontier* (the shared
:data:`repro_torch.core.pareto.PARETO_EPS` dominance band — an eps-dominated
candidate is never selected).  Without a preference the legacy behaviour is
kept: lowest wallclock over all candidates.  Each workload's selected macro
PPA is then fed back into the serving roofline
(:func:`repro_torch.roofline.dcim.dcim_serving_bound`), so the selection reports
roofline-bounded tokens/s, not just macro wallclock.

    from repro_torch.configs import get_config
    from repro_torch.core.dse import gemm_inventory
    from repro_torch.serve.select import select_macros

    sel = select_macros({"qwen3-4b": gemm_inventory(get_config("qwen3-4b"))},
                        preference=(0.2, 0.6, 0.2))     # energy-leaning
    sel.assignment["qwen3-4b"]        # -> pool index of the chosen macro
    sel.serving["qwen3-4b"].tokens_per_s

Preference weights persist per deployment config as a small JSON artifact
(:class:`PreferenceProfile`, :func:`load_preference_profile` /
:func:`save_preference_profile`), wired into the serving launcher as
``repro.launch.serve --dcim-profile PATH`` — the read-then-update round trip
is one shared helper, :func:`apply_profile`, used by the CLI and service
paths alike.

Frontier synthesis is memoized through the online synthesis service
(:mod:`repro_torch.service`): ``select_macros`` routes the multi-spec pass through
a :class:`repro_torch.service.SynthesisService` (the process-wide default unless
one is passed), so a second selection against the same scenario set performs
zero engine executions and a ``--dcim-cache`` directory makes the second
*launch* warm too.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np

from ..core.axes import LatticeConfig
from ..core.dse import CodesignReport, GemmShape, cross_workload_codesign
from ..core.macro import MacroSpec, calibrated_tech_for_reference
from ..core.multispec import frontier_union, scenario_specs
from ..core.pareto import nondominated_mask_auto, scalarize
from ..core.tech import TechModel
from ..roofline.dcim import DcimServingEstimate, dcim_serving_bound

#: Objective order of a selection preference vector.
PREFERENCE_OBJECTIVES = ("wallclock", "energy", "area")

#: Schema tag of the persisted preference-profile artifact.
PROFILE_SCHEMA = "syndcim-preference-profile/v1"


def _check_weights(weights, where: str) -> tuple[float, float, float]:
    w = tuple(float(x) for x in weights)
    if len(w) != len(PREFERENCE_OBJECTIVES):
        raise ValueError(f"{where}: need {len(PREFERENCE_OBJECTIVES)} "
                         f"weights {PREFERENCE_OBJECTIVES}, got {len(w)}")
    if any(x < 0 or not np.isfinite(x) for x in w):
        raise ValueError(f"{where}: preference weights must be finite "
                         f"and >= 0, got {w}")
    return w


@dataclass(frozen=True)
class PreferenceProfile:
    """Persisted per-deployment-config preference weights.

    Maps workload names to (wallclock, energy, area) weight vectors — the
    artifact a deployment config carries so serving-time selection keeps
    applying the same PPA posture across restarts.  ``None`` weights mean
    the legacy pure-wallclock selection (explicitly recorded, so a profile
    distinguishes "never configured" from "configured as wallclock-only").
    ``default`` applies to workloads the profile does not name."""

    workloads: Mapping[str, tuple[float, float, float] | None] = field(
        default_factory=dict)
    default: tuple[float, float, float] | None = None

    def weights_for(self, workload: str
                    ) -> tuple[float, float, float] | None:
        if workload in self.workloads:
            return self.workloads[workload]
        return self.default

    def with_workload(self, workload: str,
                      weights: Sequence[float] | None) -> "PreferenceProfile":
        """A copy recording ``weights`` (or explicit wallclock-only ``None``)
        for ``workload`` — the write half of the round trip."""
        merged = dict(self.workloads)
        merged[workload] = (None if weights is None
                            else _check_weights(weights, workload))
        return PreferenceProfile(workloads=merged, default=self.default)


def load_preference_profile(path) -> PreferenceProfile:
    """Read a profile artifact; a missing file is an empty profile (so the
    first serve run of a fresh deployment config can seed it)."""
    p = Path(path)
    if not p.exists():
        return PreferenceProfile()
    data = json.loads(p.read_text())
    if data.get("schema") != PROFILE_SCHEMA:
        raise ValueError(f"{p}: not a preference profile "
                         f"(schema={data.get('schema')!r}, "
                         f"expected {PROFILE_SCHEMA!r})")
    workloads = {
        name: None if w is None else _check_weights(w, f"{p}:{name}")
        for name, w in (data.get("workloads") or {}).items()}
    default = data.get("default")
    if default is not None:
        default = _check_weights(default, f"{p}:default")
    return PreferenceProfile(workloads=workloads, default=default)


def save_preference_profile(path, profile: PreferenceProfile) -> None:
    """Write a profile artifact (deterministic layout: sorted workloads)."""
    payload = {
        "schema": PROFILE_SCHEMA,
        "default": (None if profile.default is None
                    else list(profile.default)),
        "workloads": {
            name: (None if w is None else list(w))
            for name, w in sorted(profile.workloads.items())},
    }
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")


def apply_profile(path, select: Callable[[PreferenceProfile | None],
                                         "MacroSelection"]
                  ) -> tuple["MacroSelection", PreferenceProfile | None]:
    """The one read-then-update implementation of the ``--dcim-profile``
    round trip, shared by the CLI launcher and the service path.

    ``select`` is called with the profile loaded from ``path`` (or ``None``
    when ``path`` is ``None`` — selection then runs unprofiled and nothing
    is written).  Afterwards the artifact is re-written with the weights
    each workload was *actually* selected under
    (``MacroSelection.preferences_applied``), so the persisted posture
    converges to what the deployment serves with.  Returns
    ``(selection, updated profile or None)``."""
    if path is None:
        return select(None), None
    profile = load_preference_profile(path)
    sel = select(profile)
    updated = profile
    for w, weights in sorted(sel.preferences_applied.items()):
        updated = updated.with_workload(w, weights)
    save_preference_profile(path, updated)
    return sel, updated


def preference_select(objs, weights) -> int:
    """Index of the preferred candidate in an (n, 3) objective matrix
    (minimization; columns ordered as :data:`PREFERENCE_OBJECTIVES`).

    Semantics, pinned by ``tests/test_preference_selection.py``:

      * candidates are first restricted to the pooled Pareto frontier under
        the shared :data:`repro_torch.core.pareto.PARETO_EPS` band — an
        eps-dominated candidate is never selected;
      * the survivors are scalarized with :func:`repro_torch.core.pareto.scalarize`
        against per-objective frontier minima, so weights are scale-free
        (rescaling all weights by c > 0 cannot change the winner);
      * a degenerate all-zero weight vector falls back to pure wallclock;
      * ties break deterministically on (score, objective tuple, index).
    """
    objs = np.asarray(objs, dtype=np.float64)
    if objs.ndim != 2 or objs.shape[0] == 0:
        raise ValueError("need a non-empty (n, k) objective matrix")
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (objs.shape[1],):
        raise ValueError(f"need {objs.shape[1]} preference weights "
                         f"{PREFERENCE_OBJECTIVES}, got {w.shape}")
    if (w < 0).any() or not np.isfinite(w).all():
        raise ValueError("preference weights must be finite and >= 0")
    if not (w > 0).any():
        w = np.zeros_like(w)
        w[0] = 1.0                       # degenerate -> wallclock
    # The pooled-frontier restriction; at lattice-scale pools the mask runs
    # device-sharded (same bits as the host pass, see pareto module docs).
    cand = np.flatnonzero(nondominated_mask_auto(objs))
    refs = [max(float(objs[cand, j].min()), 1e-30)
            for j in range(objs.shape[1])]
    scored = sorted((scalarize(w, objs[i], refs), tuple(objs[i]), int(i))
                    for i in cand)
    return scored[0][2]


def preferred_macro(report: CodesignReport, workload: str,
                    preference: Sequence[float]) -> int:
    """Preference-weighted pick for one workload over the co-design matrix:
    objectives are (wallclock on this workload, energy on this workload,
    macro-array area)."""
    wi = report.workloads.index(workload)
    objs = np.stack([report.wallclock_s[wi], report.energy_pj[wi],
                     report.area_mm2], axis=1)
    return preference_select(objs, preference)


@dataclass(frozen=True)
class MacroSelection:
    """Result of serving-time selection: one macro per deployed workload."""

    workloads: tuple[str, ...]
    scenarios: tuple[str, ...]           # synthesized spec names
    pool_labels: tuple[str, ...]         # "<scenario>/<design name>" per pool entry
    pool: tuple                          # candidate MacroPPAs (frontier union)
    assignment: dict                     # workload name -> pool index
    codesign: CodesignReport
    preference: tuple[float, ...] | None = None
    serving: dict = field(default_factory=dict)  # workload -> DcimServingEstimate
    #: The weights each workload was actually selected with (profile entry,
    #: profile default, or the global ``preference``; None = pure wallclock)
    #: — what `--dcim-profile` persists back.
    preferences_applied: dict = field(default_factory=dict)

    def label_for(self, workload: str) -> str:
        return self.pool_labels[self.assignment[workload]]

    def ppa_for(self, workload: str):
        return self.pool[self.assignment[workload]]

    def serving_for(self, workload: str) -> DcimServingEstimate:
        return self.serving[workload]

    def summary(self) -> dict:
        return {
            "scenarios": list(self.scenarios),
            "candidates": len(self.pool),
            "codesign_frontier": len(self.codesign.frontier),
            "assignment": {w: self.label_for(w) for w in self.workloads},
            "preference": (list(self.preference)
                           if self.preference is not None else None),
            "preferences_applied": {
                w: (list(p) if p is not None else None)
                for w, p in self.preferences_applied.items()},
            "serving_tokens_per_s": {
                w: round(self.serving[w].tokens_per_s, 1)
                for w in self.workloads if w in self.serving},
        }


def select_macros(workloads: Mapping[str, Sequence[GemmShape]],
                  specs: Mapping[str, MacroSpec] | None = None,
                  tech: TechModel | None = None, resolution: int = 4,
                  n_macros: int = 256, ib: int = 8, wb: int = 8,
                  preference: Sequence[float] | None = None,
                  profile: PreferenceProfile | None = None,
                  service=None,
                  config: LatticeConfig | None = None,
                  kernel_fraction: float = 1.0) -> MacroSelection:
    """Synthesize the multi-spec frontier and pick a macro per workload.

    ``workloads`` maps deployed-workload names to GEMM inventories (see
    :func:`repro_torch.core.dse.gemm_inventory` for the model zoo); ``specs``
    defaults to the §I scenario set.  Without ``preference``, selection is
    lowest total wallclock on the cross-workload co-design matrix (a
    timing-missing candidate is judged at its down-clocked reporting
    frequency exactly as the scalar accelerator reports would); with a
    ``preference`` (wallclock, energy, area) the pick is the scalarized best
    of the workload's pooled Pareto frontier (:func:`preference_select`).
    A ``profile`` (:class:`PreferenceProfile`, the persisted per-deployment
    artifact) overrides ``preference`` per workload it names — an explicit
    ``None`` entry keeps that workload on pure wallclock.  Either way, each
    workload's selected macro is fed through the serving roofline so the
    selection carries tokens/s bounds, not just wallclock.

    The multi-spec synthesis pass is served by ``service`` — a
    :class:`repro_torch.service.SynthesisService` (default: the process-wide
    instance) or a :class:`repro_torch.service.ServiceFrontend`; either way the
    scenario set goes in as typed INTERACTIVE
    :class:`~repro_torch.service.SynthesisRequest` objects (selection is the
    user-facing ``--dcim-select`` shape of traffic, served ahead of bulk
    sweeps), the frontier is synthesized once per process (or once per
    persistent cache directory) and every later selection is a cache hit
    with zero engine executions.

    ``config`` selects the lattice axis set candidates are drawn from
    (:class:`repro_torch.core.axes.LatticeConfig` — e.g. extra precision-headroom
    plans or approximate adder-tree cells); the seed axes when unset, so
    existing selections are untouched.

    ``kernel_fraction`` derates the serving roofline with a *measured*
    pipeline efficiency (see
    :func:`repro_torch.kernels.profile.fraction_from_profiles` and the
    ``--dcim-kernel-profile`` launcher flag); 1.0 keeps the analytic
    bound."""
    if not workloads:
        raise ValueError("need at least one deployed workload")
    if tech is None:
        tech = calibrated_tech_for_reference()
    if specs is None:
        specs = scenario_specs()
    names = tuple(specs)
    if service is None:
        from ..service import get_service
        service = get_service()
    from ..service import Priority, SynthesisRequest
    responses = service.serve(
        [SynthesisRequest(spec=specs[n], tech=tech, resolution=resolution,
                          config=config, priority=Priority.INTERACTIVE)
         for n in names])
    results = [r.result for r in responses]
    pool, labels = frontier_union(results, names)
    report = cross_workload_codesign(workloads, pool, n_macros=n_macros,
                                     ib=ib, wb=wb)
    if preference is not None:
        preference = _check_weights(preference, "preference")
    applied = {}
    for w in report.workloads:
        weights = preference
        if profile is not None and (w in profile.workloads
                                    or profile.default is not None):
            weights = profile.weights_for(w)
        applied[w] = weights
    assignment = {w: (report.best_for(w) if applied[w] is None
                      else preferred_macro(report, w, applied[w]))
                  for w in report.workloads}
    serving = {}
    for w in report.workloads:
        wi = report.workloads.index(w)
        di = assignment[w]
        serving[w] = dcim_serving_bound(
            workloads[w], float(report.wallclock_s[wi, di]), ib=ib, wb=wb,
            workload=w, macro=labels[di], kernel_fraction=kernel_fraction)
    return MacroSelection(workloads=report.workloads, scenarios=names,
                          pool_labels=tuple(labels), pool=tuple(pool),
                          assignment=assignment, codesign=report,
                          preference=preference, serving=serving,
                          preferences_applied=applied)
