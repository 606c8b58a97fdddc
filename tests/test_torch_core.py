"""The torch port's compiler core (``repro_torch.core``) against the JAX
package's jax-free reference layer, in process, on the CPU.

* the port's batched search vs the reference's scalar Algorithm 1 oracle
  (``repro.core.mso_search(backend="scalar")``): explored names,
  ``n_evaluated``, frontier order and every PPA float **exact**;
* the port's lattice roll-up vs ``repro.core.macro.rollup`` at sampled
  points with the optional ``precision`` and ``approx_cell`` axes on,
  **exact**;
* the port's device Pareto mask vs ``repro.core.pareto.nondominated_mask``
  on 10k seeded points with ties inside +-PARETO_EPS: **the same mask**;
* ``mso_search_many`` vs per-spec searches, the engine's strategies and
  hooks, the device contract, and import hygiene.

Inputs come from numpy seeds; the two packages get the same values through
``repro_torch.convert``.
"""

import ast
import dataclasses
import enum
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import csa as R_csa
from repro.core import macro as R_macro
from repro.core import pareto as R_pareto
from repro.core import subcircuits as R_sc
from repro.core import tech as R_tech

import repro_torch.core as C
from repro_torch.convert import (mac_operands_from_numpy, spec_from_fields,
                                 tech_from_fields)
from repro_torch.core import batched as B
from repro_torch.core import engine as E
from repro_torch.core import pareto as P
from repro_torch.core import subcircuits as sc

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
FULL = C.LatticeConfig(precision_modes=3, approx_cells=sc.APPROX_CELLS)


@pytest.fixture(scope="module")
def ref_tech():
    return R.calibrated_tech_for_reference()


@pytest.fixture(scope="module")
def ref_scl(ref_tech):
    return R.SubcircuitLibrary(ref_tech).build()


@pytest.fixture(scope="module")
def tech(ref_tech):
    return tech_from_fields(dataclasses.asdict(ref_tech))


def ref_spec(spec):
    """The reference MacroSpec with the port spec's field values."""
    return R.MacroSpec(**dataclasses.asdict(spec))


def ppa_key(p) -> str:
    """Every scalar PPA field of a MacroPPA as text (``repr`` of a float
    round-trips, so equal text is equal bits) — the field set of the
    reference harness's ``assert_ppa_equal``."""
    return repr((p.design.name(), dataclasses.asdict(p.paths), p.fmax_hz,
                 p.area_um2, p.area_breakdown, p.e_cycle_fj,
                 p.latency_cycles, p.tops_1b, p.tops_per_w_1b,
                 p.tops_per_mm2_1b, p.meets_timing))


def _left_to_right_sum(values, start=0):
    acc = start
    for v in values:
        acc = acc + v
    return acc


@pytest.fixture
def left_to_right_sum(monkeypatch):
    """Run the reference scalar roll-up with ``sum`` adding left to right.

    ``macro.rollup`` sums the area breakdown with the builtin ``sum()``,
    which is compensated (Neumaier) from Python 3.12 on; the batched
    roll-up of both packages adds left to right, so at some points the
    scalar area (and the leakage and TOPS/mm2 derived from it) sits an ulp
    or two away.  This is a reference-side fault (ROADMAP.md "Reference
    state"); with the name ``sum`` bound in the reference module to the
    left-to-right sum, the scalar oracle is held exactly."""
    monkeypatch.setattr(R_macro, "sum", _left_to_right_sum, raising=False)


_REF_CLASSES = {c.__name__: c for c in (
    R_macro.MacroDesign, R_macro.MacroSpec, R_csa.CSADesign,
    R_sc.ApproxCellSpec, R_sc.MemCellKind, R_sc.MultMuxKind,
    R_tech.TechModel)}


def to_ref(obj):
    """A port value rebuilt as the reference package's value."""
    if isinstance(obj, enum.Enum):
        return _REF_CLASSES[type(obj).__name__][obj.name]
    if dataclasses.is_dataclass(obj):
        cls = _REF_CLASSES[type(obj).__name__]
        return cls(**{f.name: to_ref(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_ref(x) for x in obj)
    return obj


def random_specs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ints = tuple(sorted(rng.choice([1, 2, 4, 8], size=2, replace=False)
                            .tolist()))
        out.append(C.MacroSpec(
            h=int(rng.choice([16, 32, 64, 128])),
            w=int(rng.choice([16, 32, 64])),
            mcr=int(rng.choice([1, 2, 4])), int_precisions=ints,
            fp_precisions=("FP4", "FP8"),
            f_mac_hz=float(rng.uniform(250e6, 1.1e9)),
            f_wupdate_hz=float(rng.uniform(100e6, 800e6)),
            vdd=float(rng.choice([0.7, 0.9, 1.1, 1.2]))))
    return out


SPECS = {**C.scenario_specs(),
         "pareto": C.pareto_experiment_spec(),
         **{f"random{i}": s for i, s in enumerate(random_specs(3, seed=11))}}


# ---------------------------------------------------------------------------
# Copies of the jax-free modules
# ---------------------------------------------------------------------------


class TestCopies:
    def test_calibrated_tech_matches_reference(self, ref_tech, tech):
        assert tech == C.calibrated_tech_for_reference()
        assert dataclasses.asdict(tech) == dataclasses.asdict(ref_tech)

    def test_reference_chip_ppa_matches(self):
        assert ppa_key(C.reference_chip_ppa()) == \
            ppa_key(R.reference_chip_ppa())

    @pytest.mark.parametrize("name", list(SPECS))
    def test_scalar_oracle_copy_matches(self, name, ref_tech, ref_scl,
                                        tech):
        """The port's own scalar oracle is the reference's, audit and all."""
        spec = SPECS[name]
        a = R.mso_search(ref_spec(spec), ref_scl, ref_tech)
        b = C.mso_search(spec, C.SubcircuitLibrary(tech).build(), tech)
        assert repr([dataclasses.asdict(p) for p in a.explored]) == \
            repr([dataclasses.asdict(p) for p in b.explored])


# ---------------------------------------------------------------------------
# Batched search vs the reference scalar oracle
# ---------------------------------------------------------------------------


class TestSearchVsScalarOracle:
    @pytest.mark.parametrize("name", list(SPECS))
    def test_batched_equals_reference_scalar(self, name, ref_tech, ref_scl,
                                             tech, left_to_right_sum):
        spec = SPECS[name]
        a = R.mso_search(ref_spec(spec), ref_scl, ref_tech, backend="scalar")
        b = C.mso_search(spec, None, tech, backend="batched", device=CPU)
        assert a.n_evaluated == b.n_evaluated
        assert [p.design.name() for p in a.explored] == \
            [p.design.name() for p in b.explored]
        assert [ppa_key(p) for p in a.frontier] == \
            [ppa_key(p) for p in b.frontier]

    @pytest.mark.parametrize("name", ["vision", "language", "pareto"])
    def test_full_lattice_replay_equals_reference_scalar(
            self, name, ref_tech, ref_scl, tech, left_to_right_sum):
        """Optional axes enabled: the replay pins them at their defaults,
        so the frontier stays the scalar one."""
        spec = SPECS[name]
        a = R.mso_search(ref_spec(spec), ref_scl, ref_tech)
        b = C.mso_search_batched(spec, None, tech, config=FULL, device=CPU)
        assert [ppa_key(p) for p in a.frontier] == \
            [ppa_key(p) for p in b.frontier]

    def test_reference_scalar_area_is_compensated(self, ref_tech, ref_scl,
                                                  tech):
        """Pins the reference-side fault :func:`left_to_right_sum` works
        around: with the builtin ``sum``, the scalar oracle's vision
        frontier areas differ from the batched ones, by a few ulps."""
        a = R.mso_search(ref_spec(SPECS["vision"]), ref_scl, ref_tech)
        b = C.mso_search(SPECS["vision"], None, tech, backend="batched",
                         device=CPU)
        gaps = [abs(x.area_um2 - y.area_um2) / np.spacing(x.area_um2)
                for x, y in zip(a.frontier, b.frontier)]
        assert 0 < max(gaps) <= 7


# ---------------------------------------------------------------------------
# Lattice roll-up vs macro.rollup
# ---------------------------------------------------------------------------


class TestRollupVsReference:
    @pytest.mark.parametrize("name,seed", [("pareto", 0), ("language", 1),
                                           ("wearable", 2), ("random0", 3)])
    def test_sampled_points_equal_reference_rollup(self, name, seed,
                                                   ref_tech, tech,
                                                   left_to_right_sum):
        sweep = C.design_space_sweep(SPECS[name], tech, config=FULL,
                                     device=CPU)
        assert sweep.lattice.axis("precision") is not None
        assert sweep.lattice.axis("approx_cell") is not None
        valid = np.flatnonzero(sweep.lattice.valid)
        rng = np.random.default_rng(seed)
        for i in rng.choice(valid, 24, replace=False):
            got = sweep.ppa.materialize(int(i))
            want = R.rollup(to_ref(got.design), ref_tech)
            assert ppa_key(got) == ppa_key(want)

    def test_reference_chip_point_on_lattice(self, tech, left_to_right_sum):
        design = C.reference_chip_design()
        sweep = C.design_space_sweep(design.spec, tech, device=CPU)
        i = sweep.lattice.index_of_design(design)
        assert ppa_key(sweep.ppa.materialize(i)) == \
            ppa_key(R.reference_chip_ppa())


# ---------------------------------------------------------------------------
# Pareto mask
# ---------------------------------------------------------------------------


def tie_points(n: int, seed: int) -> np.ndarray:
    """Objectives on a coarse grid (many exact ties) jittered inside the
    +-PARETO_EPS band (near-ties the eps band must treat as ties)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 24, (n, 3)).astype(np.float64) * 1e-3
    jitter = rng.uniform(-0.5, 0.5, (n, 3)) * P.PARETO_EPS
    jitter[rng.random((n, 3)) < 0.5] = 0.0
    return base + jitter


class TestParetoMask:
    @pytest.mark.parametrize("chunk", [512, 4096])
    def test_device_mask_equals_reference_on_10k_ties(self, chunk):
        objs = tie_points(10_000, seed=5)
        want = R_pareto.nondominated_mask(objs)
        assert 0 < want.sum() < len(objs)
        got = B.pareto_mask(objs, chunk=chunk, device=CPU)
        np.testing.assert_array_equal(got, want)

    def test_host_mask_equals_reference(self):
        objs = tie_points(10_000, seed=6)
        np.testing.assert_array_equal(P.nondominated_mask(objs),
                                      R_pareto.nondominated_mask(objs))

    def test_chunk_dominated_torch_equals_numpy(self):
        objs = tie_points(2_000, seed=7)
        blk = objs[100:400]
        want = R_pareto.chunk_dominated(objs, blk, P.PARETO_EPS)
        got = P.chunk_dominated(torch.as_tensor(objs), torch.as_tensor(blk),
                                P.PARETO_EPS)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)

    def test_pareto_indices_equal_reference(self):
        objs = [tuple(o) for o in tie_points(3_000, seed=8)]
        assert P.pareto_indices(objs) == R_pareto.pareto_indices(objs)
        assert P.pareto_indices(
            objs, mask_fn=lambda o: B.pareto_mask(o, device=CPU)) == \
            R_pareto.pareto_indices(objs)

    def test_empty(self):
        assert B.pareto_mask(np.zeros((0, 3)), device=CPU).shape == (0,)


# ---------------------------------------------------------------------------
# mso_search_many and the engine
# ---------------------------------------------------------------------------


def result_text(res) -> str:
    return repr((res.n_evaluated,
                 [dataclasses.asdict(p) for p in res.explored],
                 [dataclasses.asdict(p) for p in res.frontier]))


class TestMultiSpec:
    @pytest.mark.parametrize("config", [None, FULL], ids=["seed", "full"])
    def test_many_equals_per_spec_searches(self, tech, config):
        specs = list(C.scenario_specs().values())
        many = C.mso_search_many(specs, tech=tech, config=config, device=CPU)
        for spec, res in zip(specs, many):
            one = C.mso_search_batched(spec, None, tech, config=config,
                                       device=CPU)
            assert result_text(res) == result_text(one)

    def test_jit_and_vmap_strategies_agree(self, tech):
        specs = list(C.scenario_specs().values())[:2]
        group = E.execute(E.plan(specs, tech, mode="vmap", device=CPU))
        for spec, (_, _, ppa) in zip(specs, group):
            lat = C.DesignLattice.enumerate(spec)
            one = C.evaluate(lat, C.SpecTables(spec, tech), device=CPU)
            for k in ("mac", "sa", "ofu", "crit", "fmax", "area", "latency"):
                np.testing.assert_array_equal(getattr(one, k),
                                              getattr(ppa, k))
            for k, v in one.e_cycle.items():
                np.testing.assert_array_equal(v, ppa.e_cycle[k])

    def test_frontier_union_dedups_by_spec_and_name(self, tech):
        specs = list(C.scenario_specs().values())
        res = C.mso_search_many(specs, tech=tech, device=CPU)
        pool, labels = C.frontier_union(res, names=list(C.scenario_specs()))
        assert len(pool) == sum(len(r.frontier) for r in res)
        assert len(labels) == len(pool)
        extracted = C.frontier_union(res, extract=True)
        assert 0 < len(extracted) <= len(pool)


class TestEngine:
    @pytest.mark.parametrize("mode", list(E.SHARDED_MODES))
    def test_sharded_modes_are_queued(self, mode):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            E.place(mode, device=CPU)

    def test_sharded_flag_is_queued(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            E.place(device=CPU, sharded=True)

    def test_unknown_mode(self):
        with pytest.raises(ValueError):
            E.place("quantum", device=CPU)

    def test_placement_carries_device(self):
        p = E.place(device=CPU)
        assert p.mode == "vmap" and p.device == torch.device("cpu")

    def test_hook_removing_itself_does_not_skip_peers(self, tech):
        fired = []

        def first(plan):
            fired.append("first")
            E.remove_execute_hook(first)

        def second(plan):
            fired.append("second")

        def latency(plan, elapsed):
            fired.append("latency")
            E.remove_latency_hook(latency)

        E.add_execute_hook(first)
        E.add_execute_hook(second)
        E.add_latency_hook(latency)
        try:
            spec = C.pareto_experiment_spec()
            E.execute(E.plan([spec], tech, device=CPU))
            E.execute(E.plan([spec], tech, device=CPU))
        finally:
            E.remove_execute_hook(second)
        assert fired == ["first", "second", "latency", "second"]

    def test_pad_lanes(self):
        a = np.arange(6.0).reshape(2, 3)
        out = E.pad_lanes(a, 2)
        assert out.shape == (4, 3)
        np.testing.assert_array_equal(out[2:], np.repeat(a[:1], 2, axis=0))

    def test_evaluated_cache_keys_on_device(self, tech):
        spec = C.pareto_experiment_spec()
        config = B.seed_config()
        a = B._evaluated(spec, tech, config, "cpu")
        assert B._evaluated(spec, tech, config, "cpu") is a
        b = B._evaluated(spec, tech, config, str(torch.device("cpu", 0)))
        assert b is not a
        np.testing.assert_array_equal(a[2].area, b[2].area)


# ---------------------------------------------------------------------------
# Device contract and import hygiene
# ---------------------------------------------------------------------------


def _entry_points(tech):
    spec = C.pareto_experiment_spec()
    return {
        "mso_search_batched": lambda: C.mso_search_batched(spec, None, tech),
        "mso_search(batched)": lambda: C.mso_search(spec, None, tech,
                                                    backend="batched"),
        "design_space_sweep": lambda: C.design_space_sweep(spec, tech),
        "evaluate_many": lambda: C.evaluate_many([spec], tech),
        "mso_search_many": lambda: C.mso_search_many([spec], tech=tech),
        "design_space_sweep_many": lambda: C.design_space_sweep_many(
            [spec], tech),
        "engine.place": lambda: E.place(),
        "pareto_mask": lambda: B.pareto_mask(np.ones((4, 3))),
        "mac_operands_from_numpy": lambda: mac_operands_from_numpy(
            np.zeros((2, 2), np.int8), np.zeros((2, 2), np.int8),
            np.ones(2, np.float32), np.ones(2, np.float32)),
    }


ENTRY_POINTS = list(_entry_points(None))


class TestDeviceContract:
    @pytest.mark.parametrize("entry", ENTRY_POINTS)
    def test_default_device_needs_cuda(self, entry, tech):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible: device=None is valid here")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _entry_points(tech)[entry]()

    def test_convert_round_trip(self, tech):
        for name, spec in SPECS.items():
            assert spec_from_fields(dataclasses.asdict(ref_spec(spec))) == \
                spec


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "src" / "repro_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


class TestImportHygiene:
    def test_port_files_found(self):
        assert len(PORT_FILES) > 20

    @pytest.mark.parametrize("rel", PORT_FILES)
    def test_no_jax_or_reference_imports(self, rel):
        roots = _imported_roots(REPO / rel)
        assert not roots & {"jax", "jaxlib", "repro"}, roots
