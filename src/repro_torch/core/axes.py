"""Declarative axis registry for the discrete macro design lattice.

The design lattice used to hard-code its ten axes (memcell x multmux x CSA
rho/reorder/retimed/split x OFU pipe x retime/fusion flags) into
``DesignLattice.__init__/index_of/strides`` — adding an axis meant editing
every layer from the roll-up kernel to the cache keys.  This module makes the
axis set *data*: each axis is a descriptor with

  name          stable identifier (also the per-axis cache-signature label);
  values        the discrete domain, resolved per spec + lattice config;
  validity      an optional per-value feasibility mask (e.g. OAI22 mult/mux
                beyond MCR=2);
  payloads      per-VALUE canonical signature payloads — what
                :func:`repro.service.keys.axis_signatures` hashes, so a
                single-value recalibration invalidates exactly that value's
                sublattice slice;
  tech_fields   per-value tech-model field names the value's PPA tables read
                (scoped fields are excluded from the global tech signature,
                which is what makes e.g. an ``a_sram12t`` recalibration
                invalidate only the 12T slice).

``DesignLattice`` (:mod:`repro_torch.core.batched`) composes the registered axes:
dims, strides and the mixed-radix flat-index round-trip are all derived from
the resolved axis tuple.  The seed axis set is re-expressed here as registry
entries and stays bit-identical under the differential oracle harness; the
two scale-up axes (multi-precision provisioning per SEGA-DCIM, approximate
adder-tree cells per OpenACM) are plain additional registry entries gated
behind :class:`LatticeConfig`.

Adding an axis is one ``register_axis`` call: provide a builder returning a
:class:`ResolvedAxis` (or None when the config disables it), teach
``SpecTables`` its table contribution, and the lattice enumeration, flat
indexing, per-axis cache signatures and sublattice slicing all follow.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

from . import subcircuits as sc
from .csa import valid_splits
from .macro import MacroSpec
from .searcher import RHO_STEPS

#: Seed OFU pipeline depths (tt5 repeats); kept here so the axis registry is
#: the one owner of the discrete axis constants.
PIPE_STEPS: tuple[int, ...] = (0, 1, 2, 3)

_BOOL_VALUES: tuple[bool, bool] = (False, True)


# ---------------------------------------------------------------------------
# Per-axis tech-field attribution (scoped cache invalidation)
# ---------------------------------------------------------------------------

#: Tech fields read only by one memcell variant's PPA model — changing one
#: recalibrates exactly that value's sublattice slice.
MEMCELL_TECH_FIELDS: dict[sc.MemCellKind, tuple[str, ...]] = {
    sc.MemCellKind.SRAM_6T: ("a_sram6t", "e_sram_read_bit"),
    sc.MemCellKind.DLATCH_8T: ("a_sram8t", "e_sram_read_bit"),
    sc.MemCellKind.OAI_12T: ("a_sram12t", "e_sram_read_bit"),
}

#: Tech fields read only by one mult/mux variant's PPA model.
MULTMUX_TECH_FIELDS: dict[sc.MultMuxKind, tuple[str, ...]] = {
    sc.MultMuxKind.PASS_1T: ("d_mult_pass1t", "e_mult_pass1t",
                             "a_mult_pass1t", "a_mult_nor"),
    sc.MultMuxKind.OAI22_FUSED: ("d_mult_oai22", "e_mult_oai22",
                                 "a_mult_oai22"),
    sc.MultMuxKind.TG_NOR: ("d_mux2", "e_mux2", "d_mult_nor", "e_mult_nor",
                            "a_tg2t", "a_mult_nor"),
}

#: Tech fields whose effect is scoped to single axis values (the union of the
#: per-value maps above, minus fields shared with spec-constant blocks).
#: :func:`repro.service.keys.axis_signatures` excludes these from the global
#: tech digest — everything else lands in the global component, so a change
#: there invalidates the full lattice (correct: those fields feed every
#: point through the CSA/OFU/driver models).
SCOPED_TECH_FIELDS: frozenset[str] = frozenset(
    f for fields in MEMCELL_TECH_FIELDS.values() for f in fields
) | frozenset(
    f for fields in MULTMUX_TECH_FIELDS.values() for f in fields
    # d_mux2/e_mux2 also feed the OFU and alignment models (every point):
    if f not in ("d_mux2", "e_mux2")
)


# ---------------------------------------------------------------------------
# Lattice configuration + precision plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecisionPlan:
    """One precision-provisioning mode: the weight-precision set the OFU
    fusion chain is built for and the FP format set the alignment unit is
    built for.  Plan 0 always equals the spec's own precision lists (the
    seed behavior); later plans provision headroom — octaves above the
    spec's max INT precision and the remaining FP formats — so one macro
    can serve future higher-precision workloads (SEGA-DCIM's
    multi-precision pitch)."""

    ints: tuple[int, ...]
    fps: tuple[str, ...]

    def label(self) -> str:
        return f"int{max(self.ints)}fp{len(self.fps)}"


def precision_plans(spec: MacroSpec, n_modes: int) -> tuple[PrecisionPlan, ...]:
    """The first ``n_modes`` provisioning plans derived from
    ``spec.int_precisions`` / ``spec.fp_precisions`` (deterministic order;
    plan 0 is the spec itself)."""
    ints = tuple(spec.int_precisions)
    fps = tuple(spec.fp_precisions)
    pmax = max(ints)
    all_fps = fps + tuple(f for f in sc.FP_FORMATS if f not in fps)
    plans = [
        PrecisionPlan(ints, fps),                          # exact provisioning
        PrecisionPlan(ints + (2 * pmax,), fps),            # +1 INT octave
        PrecisionPlan(ints + (2 * pmax,), all_fps),        # + all FP formats
        PrecisionPlan(ints + (2 * pmax, 4 * pmax), all_fps),
    ]
    if not 1 <= n_modes <= len(plans):
        raise ValueError(f"precision_modes must be in 1..{len(plans)}, "
                         f"got {n_modes}")
    return tuple(plans[:n_modes])


@dataclass(frozen=True)
class LatticeConfig:
    """Which axes the lattice enumerates, and their discrete domains.

    The default value reproduces the seed lattice exactly.  ``precision_modes
    = 0`` / ``approx_cells = ()`` mean the axis is absent (not size-1): the
    seed lattice shape, strides and flat indices are unchanged."""

    memcells: tuple[sc.MemCellKind, ...] = tuple(sc.MemCellKind)
    multmuxes: tuple[sc.MultMuxKind, ...] = tuple(sc.MultMuxKind)
    rho_steps: tuple[float, ...] = RHO_STEPS
    pipe_steps: tuple[int, ...] = PIPE_STEPS
    #: 0 disables the precision axis; n >= 1 enumerates the first n
    #: :func:`precision_plans` (plan 0 == the spec's own precisions).
    precision_modes: int = 0
    #: () disables the approximate-cell axis; otherwise the adder-tree cell
    #: variants to enumerate (include :data:`repro_torch.core.subcircuits.
    #: EXACT_CELL` first to keep the exact tree in the space).
    approx_cells: tuple[sc.ApproxCellSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "memcells", tuple(self.memcells))
        object.__setattr__(self, "multmuxes", tuple(self.multmuxes))
        object.__setattr__(self, "rho_steps", tuple(self.rho_steps))
        object.__setattr__(self, "pipe_steps", tuple(self.pipe_steps))
        object.__setattr__(self, "approx_cells", tuple(self.approx_cells))
        if not self.memcells or not self.multmuxes:
            raise ValueError("memcells and multmuxes must be non-empty")
        if not self.rho_steps or not self.pipe_steps:
            raise ValueError("rho_steps and pipe_steps must be non-empty")
        if self.precision_modes < 0:
            raise ValueError("precision_modes must be >= 0")

    def with_memcells(self, memcells) -> "LatticeConfig":
        return replace(self, memcells=tuple(memcells))


#: The seed configuration (module-level singleton so identical configs share
#: one object in lru_cache keys).
SEED_CONFIG = LatticeConfig()


def seed_config(memcells=None) -> LatticeConfig:
    """The seed axis set, optionally restricted to a memcell subset (the
    historical ``memcells=`` argument of the batched entry points)."""
    if memcells is None:
        return SEED_CONFIG
    memcells = tuple(memcells)
    if memcells == SEED_CONFIG.memcells:
        return SEED_CONFIG
    return LatticeConfig(memcells=memcells)


# ---------------------------------------------------------------------------
# Resolved axes + the registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResolvedAxis:
    """One lattice axis resolved against a (spec, config) pair."""

    name: str
    values: tuple
    #: Per-value canonical signature payloads (JSON-able); hashed by
    #: :func:`repro.service.keys.axis_signatures`.
    payloads: tuple
    #: Per-value tech field names this axis's tables read (resolved to the
    #: tech model's current values at signature time).
    tech_fields: tuple[tuple[str, ...], ...] = ()
    #: Per-value validity for this spec (None = all valid).
    validity: Optional[tuple[bool, ...]] = None
    #: Coordinates stored as bool arrays (the seed flag axes).
    bool_coords: bool = False

    @property
    def size(self) -> int:
        return len(self.values)

    def __post_init__(self):
        if len(self.payloads) != len(self.values):
            raise ValueError(f"axis {self.name}: one payload per value")
        if self.tech_fields and len(self.tech_fields) != len(self.values):
            raise ValueError(f"axis {self.name}: one tech-field tuple "
                             "per value")
        if self.validity is not None and len(self.validity) != len(self.values):
            raise ValueError(f"axis {self.name}: one validity bit per value")


def value_label(axis: ResolvedAxis, i: int) -> str:
    """Stable per-value label used by the per-axis cache signatures."""
    v = axis.values[i]
    if isinstance(v, (sc.MemCellKind, sc.MultMuxKind)):
        return v.value
    if isinstance(v, sc.ApproxCellSpec):
        return v.name
    if isinstance(v, PrecisionPlan):
        return v.label()
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(v)


AxisBuilder = Callable[[MacroSpec, LatticeConfig], Optional[ResolvedAxis]]

#: name -> builder, in composition (stride) order.  The first entry is the
#: outermost (largest-stride) axis — the seed ordering is preserved so seed
#: flat indices are unchanged; new axes append after the seed ten.
AXIS_REGISTRY: dict[str, AxisBuilder] = {}


def register_axis(name: str, builder: AxisBuilder) -> AxisBuilder:
    """Add one axis to the lattice.  Everything else — enumeration, strides,
    flat-index round-trip, per-axis cache signatures, sublattice slicing —
    derives from the ResolvedAxis the builder returns."""
    if name in AXIS_REGISTRY:
        raise ValueError(f"axis {name!r} already registered")
    AXIS_REGISTRY[name] = builder
    return builder


def _bool_axis(name: str) -> ResolvedAxis:
    return ResolvedAxis(name=name, values=_BOOL_VALUES,
                        payloads=(0, 1), bool_coords=True)


def _memcell_axis(spec, cfg):
    return ResolvedAxis(
        name="memcell", values=cfg.memcells,
        payloads=tuple(k.value for k in cfg.memcells),
        tech_fields=tuple(MEMCELL_TECH_FIELDS[k] for k in cfg.memcells))


def _multmux_axis(spec, cfg):
    return ResolvedAxis(
        name="multmux", values=cfg.multmuxes,
        payloads=tuple(k.value for k in cfg.multmuxes),
        tech_fields=tuple(MULTMUX_TECH_FIELDS[k] for k in cfg.multmuxes),
        validity=tuple(sc.multmux_valid(k, spec.mcr) for k in cfg.multmuxes))


def _rho_axis(spec, cfg):
    return ResolvedAxis(name="rho", values=cfg.rho_steps,
                        payloads=tuple(float(r) for r in cfg.rho_steps))


def _split_axis(spec, cfg):
    splits = valid_splits(spec.h)
    # The split domain is spec-derived (h); the payload records the derivation
    # rule, not the values — the spec half of the cache address owns h.
    return ResolvedAxis(name="split", values=splits,
                        payloads=tuple(int(s) for s in splits))


def _pipe_axis(spec, cfg):
    return ResolvedAxis(name="pipe", values=cfg.pipe_steps,
                        payloads=tuple(int(p) for p in cfg.pipe_steps))


def _precision_axis(spec, cfg):
    if cfg.precision_modes == 0:
        return None
    plans = precision_plans(spec, cfg.precision_modes)
    return ResolvedAxis(
        name="precision", values=plans,
        # Plan values are spec-derived; the payload pins the derivation mode
        # index (the spec half of the address owns the precision lists).
        payloads=tuple({"mode": i, "ints": list(p.ints), "fps": list(p.fps)}
                       for i, p in enumerate(plans)))


def _approx_axis(spec, cfg):
    if not cfg.approx_cells:
        return None
    return ResolvedAxis(
        name="approx_cell", values=cfg.approx_cells,
        payloads=tuple({"name": c.name, "k_delay": c.k_delay,
                        "k_energy": c.k_energy, "k_area": c.k_area}
                       for c in cfg.approx_cells))


# Seed axes, in the seed stride order (outermost first) — re-registered here
# exactly as the hard-coded lattice enumerated them, so flat indices are
# bit-identical.  New axes append after the seed ten: when disabled the seed
# shape is untouched, when enabled they take the innermost strides.
register_axis("memcell", _memcell_axis)
register_axis("multmux", _multmux_axis)
register_axis("rho", _rho_axis)
register_axis("reorder", lambda spec, cfg: _bool_axis("reorder"))
register_axis("retimed", lambda spec, cfg: _bool_axis("retimed"))
register_axis("split", _split_axis)
register_axis("pipe", _pipe_axis)
register_axis("ofu_retime", lambda spec, cfg: _bool_axis("ofu_retime"))
register_axis("fuse_tree_sa", lambda spec, cfg: _bool_axis("fuse_tree_sa"))
register_axis("fuse_sa_ofu", lambda spec, cfg: _bool_axis("fuse_sa_ofu"))
register_axis("precision", _precision_axis)
register_axis("approx_cell", _approx_axis)

#: Axes the incremental sweep path caches per-value slice frontiers for —
#: the axes whose values can gain members or be recalibrated independently.
#: Flag axes and the spec-derived split axis are excluded (their per-value
#: payloads never change independently of the spec).
SLICEABLE_AXES: tuple[str, ...] = ("memcell", "multmux", "rho", "pipe",
                                   "precision", "approx_cell")


def resolve_axes(spec: MacroSpec,
                 config: LatticeConfig | None = None
                 ) -> tuple[ResolvedAxis, ...]:
    """Resolve every registered axis for one (spec, config) pair, in
    composition order; disabled axes drop out."""
    cfg = config if config is not None else SEED_CONFIG
    out = []
    for name, builder in AXIS_REGISTRY.items():
        ax = builder(spec, cfg)
        if ax is not None:
            out.append(ax)
    return tuple(out)


def dims_of(axes: tuple[ResolvedAxis, ...]) -> tuple[int, ...]:
    return tuple(a.size for a in axes)


def strides_of(dims: tuple[int, ...]) -> tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(dims):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))
