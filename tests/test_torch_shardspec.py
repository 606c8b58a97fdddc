"""The port's sharded compiler engine (``repro_torch.core.shardspec``,
``core.multihost``, the sharded modes of ``core.engine`` and
``service``, ``parallel.sharding``) and A3, the sharded frontier mask
(``core.pareto.nondominated_mask_sharded``), on the CPU.

torch has one CPU device, so the JAX package's "8 fake host devices" are a
mesh of ``["cpu"] * 8`` here: eight shards run one after another.  Every
comparison is bit for bit and in order (no tolerance): explored and
frontier order, every PPA float, ``area_breakdown`` order, frontier
indices and mask bits.

* **Against the JAX sharded engine**, run once in a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and the
  ``enable_x64`` shim (never in this process): ``spec_variants`` of 13 and
  130 specs, ``mso_search_many_sharded`` in jit, pmap and multihost, the
  sharded sweeps' frontier indices, and ``nondominated_mask_sharded`` on
  seeded random objectives.
* **The reference's sharded tests restated** on CPU meshes of 1, 3 and 8
  entries: ``TestShardedMechanics``, ``TestShardedParetoExtraction`` and
  the sharded cases of ``TestRegistryLatticeEquivalence``
  (``tests/test_oracle_equivalence.py``), ``TestMultiHostStrategy``
  (``tests/test_service.py``), ``TestAsyncEightDevices``
  (``tests/test_frontend.py``) and the multihost span census
  (``tests/test_obs.py``).
* **The multi-process branch**: 2- and 3-process gloo groups
  (``torch.multiprocessing`` in a subprocess, ``file://`` init), each
  rank on its lane slice, equal to the single-process pass; a host count
  that disagrees with the world size raises.
"""

import dataclasses
import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.core as C
from repro_torch.core import engine as E
from repro_torch.core import pareto as P
from repro_torch.core import shardspec as S
from repro_torch.core import subcircuits as sc
from repro_torch.core.axes import LatticeConfig
from repro_torch.core.batched import design_space_sweep
from repro_torch.core.macro import MacroSpec
from repro_torch.core.multispec import design_space_sweep_many, mso_search_many
from repro_torch.core.shardspec import (design_space_sweep_many_sharded,
                                        mso_search_many_sharded, spec_variants)
from repro_torch.obs import configure, tracer
from repro_torch.parallel import Mesh, host_spec_mesh, spec_sweep_mesh
from repro_torch.service import (FrontierCache, ServiceFrontend,
                                 SynthesisRequest, SynthesisService)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
RES = 3
TECH = C.calibrated_tech_for_reference()
MODES = ("jit", "pmap", "multihost")


def four_cards(monkeypatch):
    """Four visible CUDA cards, as far as device lookups can tell (nothing
    runs on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def mesh_for(mode: str, entries: int, n_hosts: int | None = None) -> Mesh:
    """A CPU mesh of ``entries`` shards in the layout ``mode`` needs."""
    devices = [CPU] * entries
    if mode == "multihost":
        return host_spec_mesh(devices, n_hosts=n_hosts)
    return spec_sweep_mesh(devices)


def result_text(r) -> str:
    """A SearchResult as text, the same in both processes: ``repr`` of a
    float round-trips, so equal text is equal bits, and every dict keeps
    its order (``area_breakdown`` included)."""
    return repr((r.n_evaluated, [dataclasses.asdict(p) for p in r.explored],
                 [dataclasses.asdict(p) for p in r.frontier]))


def texts(results) -> list[str]:
    return [result_text(r) for r in results]


def spec_text(s) -> str:
    return repr(dataclasses.asdict(s))


def extraction_points(seed: int, n: int, k: int = 3) -> np.ndarray:
    """Random objectives salted with exact duplicates, eps-near ties and a
    strictly dominated row (the reference's ``_extraction_points``)."""
    rng = np.random.default_rng(seed)
    objs = rng.uniform(0.1, 10.0, size=(n, k))
    if n >= 8:
        objs[n // 2] = objs[0]                      # exact duplicate
        objs[n // 3] = objs[1] + P.PARETO_EPS / 4   # inside the tie band
        objs[n // 4] = objs[2] + 1.0                # strictly dominated
    return objs


#: (seed, n, k) of the random objective sets both packages mask.
MASK_CASES = ((7, 3000, 3), (8, 257, 2), (9, 20_000, 3), (10, 2048, 4))


# ---------------------------------------------------------------------------
# Against the JAX package's sharded engine (one subprocess)
# ---------------------------------------------------------------------------


REFERENCE_SCRIPT = r"""
import dataclasses, json, pathlib, sys
import numpy as np
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from repro.core import calibrated_tech_for_reference
from repro.core.pareto import PARETO_EPS, nondominated_mask_sharded
from repro.core.shardspec import (design_space_sweep_many_sharded,
                                  mso_search_many_sharded, spec_variants)

tech = calibrated_tech_for_reference()
""" + "\n".join(inspect.getsource(f) for f in (
    result_text, texts, spec_text, extraction_points)).replace(
    "P.PARETO_EPS", "PARETO_EPS") + r"""
cases = json.loads(sys.argv[2])
out = {"devices": len(jax.devices())}
for n, seed in ((13, 5), (130, 0)):
    specs = spec_variants(n, seed=seed)
    out[f"specs{n}"] = [spec_text(s) for s in specs]
    for mode in ("jit", "pmap", "multihost"):
        out[f"search{n}/{mode}"] = texts(mso_search_many_sharded(
            specs, None, tech, resolution=3, mode=mode))
for mode in ("jit", "pmap"):
    out[f"sweep/{mode}"] = [
        s.frontier_indices() for s in design_space_sweep_many_sharded(
            spec_variants(3, seed=9), tech, mode=mode)]
    for seed, n, k in cases:
        mask = nondominated_mask_sharded(extraction_points(seed, n, k),
                                         mode=mode)
        out[f"mask/{seed}/{mode}"] = np.flatnonzero(mask).tolist()
pathlib.Path(sys.argv[1]).write_text(json.dumps(out))
"""


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(
                    [str(REPO / "src")]
                    + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX sharded engine on 8 fake host devices, once."""
    out = tmp_path_factory.mktemp("jax_sharded") / "reference.json"
    env = dict(_env(),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(out),
         json.dumps(MASK_CASES)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(out.read_text())
    assert ref["devices"] == 8
    return ref


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded pass (``mso_search_many``, device="cpu") of
    the 13- and 130-spec requests."""
    return {n: texts(mso_search_many(spec_variants(n, seed=seed), None,
                                     TECH, resolution=RES, device=CPU))
            for n, seed in ((13, 5), (130, 0))}


class TestAgainstJaxShardedEngine:
    @pytest.mark.parametrize("n,seed", [(13, 5), (130, 0)])
    def test_spec_variants_equal_reference(self, reference, n, seed):
        assert [spec_text(s) for s in spec_variants(n, seed=seed)] == \
            reference[f"specs{n}"]

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("n,seed", [(13, 5), (130, 0)])
    def test_search_on_eight_entries_equals_reference(self, reference,
                                                      unsharded, mode, n,
                                                      seed):
        got = texts(mso_search_many_sharded(
            spec_variants(n, seed=seed), None, TECH, resolution=RES,
            mesh=mesh_for(mode, 8), mode=mode))
        assert got == reference[f"search{n}/{mode}"]
        assert got == unsharded[n]

    @pytest.mark.parametrize("mode", ["jit", "pmap"])
    def test_sweep_frontiers_equal_reference(self, reference, mode):
        sweeps = design_space_sweep_many_sharded(
            spec_variants(3, seed=9), TECH, mesh=mesh_for(mode, 8),
            mode=mode)
        assert [s.frontier_indices() for s in sweeps] == \
            reference[f"sweep/{mode}"]

    @pytest.mark.parametrize("entries", [1, 8])
    @pytest.mark.parametrize("mode", ["jit", "pmap"])
    @pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: f"{c[1]}x{c[2]}")
    def test_mask_equals_reference(self, reference, case, mode, entries):
        seed, n, k = case
        mask = P.nondominated_mask_sharded(extraction_points(seed, n, k),
                                           mode=mode,
                                           mesh=mesh_for(mode, entries))
        assert np.flatnonzero(mask).tolist() == \
            reference[f"mask/{seed}/{mode}"]


# ---------------------------------------------------------------------------
# Meshes (parallel/sharding.py)
# ---------------------------------------------------------------------------


class TestMeshes:
    def test_entries_may_repeat_a_device(self):
        mesh = spec_sweep_mesh([CPU] * 8)
        assert mesh.axis_names == ("spec",)
        assert mesh.devices.shape == (8,) and mesh.devices.size == 8
        assert set(mesh.devices.flat) == {torch.device("cpu")}

    def test_spec_sweep_mesh_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
            spec_sweep_mesh()
        with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
            host_spec_mesh()
        with pytest.raises(RuntimeError, match=r'devices=\["cpu"\]'):
            P.nondominated_mask_sharded(np.ones((4, 3)))

    def test_host_spec_mesh_rows(self):
        assert host_spec_mesh([CPU] * 8).devices.shape == (1, 8)
        assert host_spec_mesh([CPU] * 8, n_hosts=2).devices.shape == (2, 4)
        # ragged host split: one host row
        assert host_spec_mesh([CPU] * 8, n_hosts=3).devices.shape == (1, 8)

    def test_mesh_shape_checked(self):
        with pytest.raises(ValueError):
            Mesh(np.empty(0, dtype=object), ("spec",))
        with pytest.raises(ValueError):
            Mesh(np.array([torch.device(CPU)], dtype=object),
                 ("host", "spec"))

    @pytest.mark.parametrize("device,want", [
        (None, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
        ("cuda", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
        ("cuda:1", ["cuda:1"]),
        ("cpu", ["cpu"]),
    ])
    def test_device_mesh_of_bare_and_named_devices(self, monkeypatch,
                                                   device, want):
        """The bare card spreads over every visible card (4 here); a named
        device is the mesh's one entry."""
        four_cards(monkeypatch)
        mesh = E.device_mesh(device)
        assert [str(d) for d in mesh.devices.flat] == want
        for mode in ("sharded-jit", "pmap"):
            p = E.place(mode, device=device)
            assert p.mesh.devices.size == len(want)
            assert str(p.device) == want[0]

    @pytest.mark.parametrize("mode", ["sharded", "jit", "pmap",
                                      "multihost"])
    def test_service_on_a_named_card_stays_there(self, monkeypatch, mode):
        """A service built on "cuda:1" places every sharded pass on that
        card alone (and "auto" stays on vmap there); one built on the bare
        card spreads over all four."""
        four_cards(monkeypatch)
        one = SynthesisService(device="cuda:1", mode=mode)
        p = one._place(mode, 8)
        assert [str(d) for d in p.mesh.devices.flat] == ["cuda:1"]
        assert str(p.device) == "cuda:1"
        assert one._place("auto", 8).mode == "vmap"
        every = SynthesisService(mode=mode)
        p = every._place(mode, 8)
        assert p.mesh.devices.size == 4 and str(p.device) == "cuda:0"
        assert every._place("auto", 8).mode == "sharded-jit"


# ---------------------------------------------------------------------------
# Sharded mechanics (tests/test_oracle_equivalence.py:175-255)
# ---------------------------------------------------------------------------


class TestShardedMechanics:
    def test_mode_resolution(self):
        assert S.resolve_mode("auto") == "jit"
        assert S.resolve_mode("jit") == "jit"
        assert S.resolve_mode("pmap") == "pmap"
        assert S.resolve_mode("multihost") == "multihost"
        with pytest.raises(ValueError):
            S.resolve_mode("tpu-pod")

    def test_multihost_falls_back_without_distributed(self, monkeypatch):
        monkeypatch.setitem(E.STRATEGIES, "multihost", dataclasses.replace(
            E.STRATEGIES["multihost"], available=lambda: False))
        assert S.resolve_mode("multihost") == S.resolve_mode("auto")

    def test_spec_variants_deterministic_and_grouped(self):
        a = spec_variants(12, seed=3)
        assert a == spec_variants(12, seed=3)
        assert len({(s.h, s.w, s.int_precisions, s.fp_precisions)
                    for s in a}) == 1      # one geometry -> one group
        assert len(set(a)) == len(a)       # duplicate-free request

    def test_spec_variants_repeat_past_the_reachable_postures(self):
        n = S._N_REACHABLE + 5
        specs = spec_variants(n, seed=1)
        assert len(specs) == n
        assert len(set(specs)) == S._N_REACHABLE

    @pytest.mark.parametrize("entries", [1, 3, 8])
    def test_ragged_counts_match_unsharded(self, entries):
        """Spec counts that do not divide the entry count still return
        bit-identical per-spec results (padding computed and dropped)."""
        for n in (1, 3, 5):
            specs = spec_variants(n, seed=n)
            ref = texts(mso_search_many(specs, None, TECH, resolution=RES,
                                        device=CPU))
            for mode in MODES:
                got = mso_search_many_sharded(specs, None, TECH,
                                              resolution=RES,
                                              mesh=mesh_for(mode, entries),
                                              mode=mode)
                assert texts(got) == ref, (mode, n)

    @pytest.mark.parametrize("strategy", ["sharded-jit", "pmap"])
    def test_padding_sliced_before_unpack(self, strategy):
        plan = E.plan(spec_variants(5, seed=4), TECH, mode="vmap",
                      device=CPU)
        (members,) = plan.groups
        packed = E.pack_group([plan.lattices[i] for i in members],
                              [plan.tables[i] for i in members])
        placement = E.place(strategy, spec_sweep_mesh([CPU] * 3))
        out = E.STRATEGIES[strategy].run(packed, placement)
        ref = E._run_vmap(packed, E.place("vmap", device=CPU))
        for k in ("mac_base", "ofu_base", "area", "e_cycle"):
            assert out[k].shape[0] == 5
            assert np.array_equal(out[k], ref[k])

    def test_default_mesh_of_the_device(self):
        (res,) = mso_search_many_sharded(spec_variants(1, seed=2), None,
                                         TECH, resolution=RES, device=CPU)
        (ref,) = mso_search_many(spec_variants(1, seed=2), None, TECH,
                                 resolution=RES, device=CPU)
        assert result_text(res) == result_text(ref)


class TestEngineRouting:
    def test_strategies_registered_and_probed(self):
        assert {"jit", "vmap", "sharded-jit", "pmap",
                "multihost"} <= set(E.STRATEGIES)
        for s in E.STRATEGIES.values():
            assert callable(s.available) and callable(s.run)
            assert s.sharded == (s.default_mesh is not None)
        assert E.resolve_sharded_mode("auto") == "jit"
        # "pmap" is the JAX package's mode name for the same lane split
        assert E.STRATEGIES["pmap"].run is E.STRATEGIES["sharded-jit"].run
        with pytest.raises(ValueError):
            E.place("warp-drive")

    def test_path_modules_are_thin_strategies(self):
        assert S.resolve_mode is E.resolve_sharded_mode
        for stale in ("_pad_lanes", "_evaluate_group_sharded",
                      "_eval_kernel_pmap", "_run_sharded_jit"):
            assert not hasattr(S, stale), f"copy left: {stale}"
        assert not hasattr(E, "_run_pmap")

    def test_plan_groups_and_execute_orders(self):
        specs = spec_variants(3, seed=2)
        mixed = [specs[0],
                 MacroSpec(h=32, w=32, mcr=2, int_precisions=(4, 8),
                           fp_precisions=("FP8",), f_mac_hz=500e6,
                           f_wupdate_hz=500e6, vdd=0.9),
                 specs[1]]
        p = E.plan(mixed, TECH, (sc.MemCellKind.SRAM_6T,),
                   mode="sharded-jit", mesh=spec_sweep_mesh([CPU] * 8))
        assert sorted(len(g) for g in p.groups) == [1, 2]
        assert p.placement.n_dev == 8
        out = E.execute(p)
        assert [lat.spec for lat, _, _ in out] == mixed


# ---------------------------------------------------------------------------
# A3: sharded Pareto extraction (tests/test_oracle_equivalence.py:319-437)
# ---------------------------------------------------------------------------


class TestShardedParetoExtraction:
    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=10**6),
           n=st.sampled_from([1, 7, 64, 257, 2048]),
           k=st.sampled_from([1, 2, 3, 4]),
           mode=st.sampled_from(["jit", "pmap"]),
           entries=st.sampled_from([1, 3, 8]))
    def test_mask_bit_identical(self, seed, n, k, mode, entries):
        objs = extraction_points(seed, n, k)
        shard = P.nondominated_mask_sharded(objs, mode=mode,
                                            mesh=mesh_for(mode, entries))
        assert np.array_equal(P.nondominated_mask(objs), shard)

    @settings(max_examples=4, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=10**6),
           chunk=st.sampled_from([64, 100, 1024]))
    def test_mask_chunk_invariant(self, seed, chunk):
        """Block boundaries must not move the verdicts."""
        objs = extraction_points(seed, 1500, 3)
        host = P.nondominated_mask(objs)
        for mode in ("jit", "pmap"):
            for entries in (1, 8):
                got = P.nondominated_mask_sharded(
                    objs, chunk=chunk, mode=mode,
                    mesh=mesh_for(mode, entries))
                assert np.array_equal(host, got)

    @pytest.mark.parametrize("mode", ["jit", "pmap"])
    def test_refinement_sees_rows_phase_one_dropped(self, mode):
        """Eps-band dominance is not transitive: ``a`` dominates ``b``,
        ``b`` dominates ``c``, ``a`` does not dominate ``c``.  With ``a`` and
        ``b`` in one shard (two entries, blocks of two rows), phase 1 drops
        ``b``; ``c`` (the other shard) survives it and only a refinement
        against every row, ``b`` included, drops it."""
        e = P.PARETO_EPS
        objs = np.array([[0.0, 1.0 + 0.9 * e], [1.0, 1.0],
                         [2.0, 1.0 - 0.9 * e], [5.0, 5.0]])
        assert P.dominates(objs[0], objs[1])
        assert P.dominates(objs[1], objs[2])
        assert not P.dominates(objs[0], objs[2])
        host = P.nondominated_mask(objs)
        assert host.tolist() == [True, False, False, False]
        got = P.nondominated_mask_sharded(objs, chunk=2, mode=mode,
                                          mesh=mesh_for(mode, 2))
        assert np.array_equal(got, host)

    def test_frontier_order_identical_through_shared_tail(self):
        objs = extraction_points(11, 4096, 3)
        mesh = spec_sweep_mesh([CPU] * 8)
        assert E.extract_frontier(objs, P.nondominated_mask) == \
            E.extract_frontier(objs, lambda o: P.nondominated_mask_sharded(
                o, mesh=mesh))

    def test_lattice_scale_100k_bit_identical(self):
        """>= 100k random points, host against sharded on 8 entries:
        identical membership and order."""
        objs = extraction_points(0, 100_000, 3)
        host = P.nondominated_mask(objs)
        for mode in ("jit", "pmap"):
            shard = P.nondominated_mask_sharded(objs, mode=mode,
                                                mesh=mesh_for(mode, 8))
            assert np.array_equal(host, shard), f"mask diverged in {mode}"
            assert np.array_equal(np.flatnonzero(host),
                                  np.flatnonzero(shard))

    @pytest.mark.parametrize("entries", [1, 3, 8])
    def test_sharded_sweep_frontier_matches_unsharded(self, entries):
        """The sharded sweeps extract through the sharded mask (17,280
        points each, past SHARDED_EXTRACT_MIN_POINTS) and equal the
        unsharded sweeps' frontier indices."""
        specs = spec_variants(3, seed=9)
        ref = [s.frontier_indices() for s in
               design_space_sweep_many(specs, TECH, device=CPU)]
        for mode in MODES:
            got = design_space_sweep_many_sharded(
                specs, TECH, mesh=mesh_for(mode, entries), mode=mode)
            for g in got:
                assert g.extract_mask is not None
                assert len(g.objectives()) >= P.SHARDED_EXTRACT_MIN_POINTS
            assert [g.frontier_indices() for g in got] == ref, mode

    def test_small_sweeps_extract_on_the_host(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("sharded mask below the payoff point")
        monkeypatch.setattr(S, "nondominated_mask_sharded", boom)
        objs = extraction_points(3, P.SHARDED_EXTRACT_MIN_POINTS - 1)
        assert np.array_equal(S._sharded_extract(objs, "jit", None),
                              P.nondominated_mask(objs))

    def test_auto_switches_on_card_count(self, monkeypatch):
        """``nondominated_mask_auto`` takes the sharded mask at the payoff
        point when torch sees more than one card, the host mask below it
        or on one card."""
        calls = []

        def sharded(objs, eps=P.PARETO_EPS):
            calls.append(len(objs))
            return P.nondominated_mask(objs, eps)

        monkeypatch.setattr(P, "nondominated_mask_sharded", sharded)
        big = extraction_points(5, P.SHARDED_EXTRACT_MIN_POINTS)
        small = big[:-1]
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        P.nondominated_mask_auto(big)
        assert calls == []
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        P.nondominated_mask_auto(small)
        assert calls == []
        assert np.array_equal(P.nondominated_mask_auto(big),
                              P.nondominated_mask(big))
        assert calls == [len(big)]

    def test_auto_surfaces_a_failure_inside_the_sharded_pass(self,
                                                             monkeypatch):
        def oom(objs, eps=P.PARETO_EPS):
            raise RuntimeError("device out of memory")

        monkeypatch.setattr(P, "nondominated_mask_sharded", oom)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(RuntimeError, match="out of memory"):
            P.nondominated_mask_auto(
                extraction_points(5, P.SHARDED_EXTRACT_MIN_POINTS))

    def test_auto_probe_failure_is_the_host_mask(self, monkeypatch):
        def broken():
            raise RuntimeError("the CUDA probe failed")

        monkeypatch.setattr(torch.cuda, "device_count", broken)
        big = extraction_points(5, P.SHARDED_EXTRACT_MIN_POINTS)
        assert np.array_equal(P.nondominated_mask_auto(big),
                              P.nondominated_mask(big))


# ---------------------------------------------------------------------------
# Registry-backed lattices through the sharded paths
# (tests/test_oracle_equivalence.py:469, :507)
# ---------------------------------------------------------------------------


def _axis_configs():
    one = (sc.MemCellKind.SRAM_6T,)
    return {
        "seed": LatticeConfig(memcells=one),
        "precision": LatticeConfig(memcells=one, precision_modes=3),
        "approx_cell": LatticeConfig(memcells=one,
                                     approx_cells=sc.APPROX_CELLS),
        "precision+approx": LatticeConfig(memcells=one, precision_modes=2,
                                          approx_cells=sc.APPROX_CELLS[:3]),
    }


class TestRegistryLatticeEquivalence:
    @pytest.mark.parametrize("name", sorted(_axis_configs()))
    def test_multispec_and_sharded_match_batched(self, name):
        """Objectives and frontier membership identical across the
        single-spec sweep, the spec-stacked pass and the sharded
        placements (one spec on a ragged 3-entry mesh)."""
        spec = MacroSpec()
        cfg = _axis_configs()[name]
        ref = design_space_sweep(spec, TECH, config=cfg, device=CPU)
        runs = {"multispec": design_space_sweep_many(
            [spec], TECH, memcells=cfg.memcells, config=cfg, device=CPU)[0]}
        for mode in MODES:
            runs[f"sharded-{mode}"] = design_space_sweep_many_sharded(
                [spec], TECH, memcells=cfg.memcells,
                mesh=mesh_for(mode, 3), mode=mode, config=cfg)[0]
        ref_obj = ref.objectives()
        for path, sweep in runs.items():
            assert sweep.lattice.dims == ref.lattice.dims, path
            assert np.array_equal(ref_obj, sweep.objectives()), path
            assert sweep.frontier_indices() == ref.frontier_indices(), path

    def test_registry_lattice_eight_entries(self):
        """The extended (precision + approx-cell) lattice on 8 entries:
        both single-host placements bit-identical to the spec-stacked
        pass."""
        cfg = _axis_configs()["precision+approx"]
        specs = [MacroSpec()] + spec_variants(2, seed=11)
        ref = design_space_sweep_many(specs, TECH, memcells=cfg.memcells,
                                      config=cfg, device=CPU)
        for mode in ("jit", "pmap"):
            got = design_space_sweep_many_sharded(
                specs, TECH, memcells=cfg.memcells, mesh=mesh_for(mode, 8),
                mode=mode, config=cfg)
            for r, g in zip(ref, got):
                assert np.array_equal(r.objectives(), g.objectives())
                assert r.frontier_indices() == g.frontier_indices()


# ---------------------------------------------------------------------------
# The multihost strategy and the sharded service (tests/test_service.py:
# 331-430, tests/test_frontend.py:499, tests/test_obs.py:740-790)
# ---------------------------------------------------------------------------


def service(**kw) -> SynthesisService:
    kw.setdefault("tech", TECH)
    kw.setdefault("resolution", RES)
    return SynthesisService(device=CPU, **kw)


class TestMultiHostStrategy:
    def test_registered_with_fallback_semantics(self):
        s = E.STRATEGIES["multihost"]
        assert s.sharded and callable(s.default_mesh)
        assert "multihost" in E.SHARDED_MODES
        resolved = E.resolve_sharded_mode("multihost")
        assert resolved == ("multihost" if s.available() else "jit")

    def test_host_spec_mesh_shape(self):
        mesh = E.place("multihost", device=CPU).mesh
        assert tuple(mesh.axis_names) == ("host", "spec")
        assert mesh.devices.shape == (1, 1)   # one process, one CPU entry

    def test_multihost_needs_a_host_spec_mesh(self):
        with pytest.raises(ValueError, match="'host', 'spec'"):
            mso_search_many_sharded(spec_variants(2, seed=1), None, TECH,
                                    mesh=spec_sweep_mesh([CPU] * 2),
                                    mode="multihost")

    def test_multihost_matches_unsharded(self):
        for n in (1, 3, 5):
            specs = spec_variants(n, seed=n + 50)
            ref = mso_search_many(specs, None, TECH, resolution=RES,
                                  device=CPU)
            got = mso_search_many_sharded(specs, None, TECH, resolution=RES,
                                          mode="multihost", device=CPU)
            assert texts(got) == texts(ref)

    def test_service_through_multihost_identical(self):
        specs = spec_variants(4, seed=59)
        ref = mso_search_many(specs, None, TECH, resolution=RES, device=CPU)
        svc = service(mode="multihost")
        assert texts(svc.synthesize_many(specs)) == texts(ref)

    def test_eight_entries_bit_identical(self):
        """The multihost strategy on 8 entries (2 host rows of 4), ragged
        13-spec request, bit-identical to the unsharded pass — and the
        service's fused pass through it serves the same bits."""
        specs = spec_variants(13, seed=5)
        ref = texts(mso_search_many(specs, None, TECH, resolution=RES,
                                    device=CPU))
        mesh = host_spec_mesh([CPU] * 8, n_hosts=2)
        got = mso_search_many_sharded(specs, None, TECH, resolution=RES,
                                      mesh=mesh, mode="multihost")
        assert texts(got) == ref
        svc = service(mode="multihost", mesh=mesh)
        assert texts(svc.synthesize_many(specs)) == ref
        assert svc.stats.fused_passes == 1

    @pytest.mark.parametrize("mode", ["sharded", "jit", "pmap"])
    def test_service_modes_on_eight_entries(self, mode):
        specs = spec_variants(13, seed=5)
        ref = texts(mso_search_many(specs, None, TECH, resolution=RES,
                                    device=CPU))
        passes = []
        hook = lambda plan: passes.append(plan.placement)
        E.add_execute_hook(hook)
        try:
            svc = service(mode=mode, mesh=spec_sweep_mesh([CPU] * 8))
            got = svc.synthesize_many(specs)
        finally:
            E.remove_execute_hook(hook)
        assert texts(got) == ref
        assert [p.n_dev for p in passes] == [8]
        assert svc.stats.fused_passes == 1

    def test_auto_shards_a_big_batch_on_the_mesh(self):
        """"auto" shards once a batch stacks 2 specs per mesh entry."""
        passes = []
        hook = lambda plan: passes.append(plan.placement.mode)
        E.add_execute_hook(hook)
        try:
            svc = service(mesh=spec_sweep_mesh([CPU] * 4))
            svc.synthesize_many(spec_variants(7, seed=61))
            svc.synthesize_many(spec_variants(8, seed=62))
        finally:
            E.remove_execute_hook(hook)
        assert passes == ["vmap", "sharded-jit"]


class TestAsyncEightDevices:
    def test_eight_entries_bit_identical(self):
        """A 13-spec ragged request stream through the async frontend over
        a multihost-mode service on 8 entries: every response
        bit-identical to the unsharded blocking pass, nothing shedded."""
        specs = spec_variants(13, seed=5)
        ref = texts(mso_search_many(specs, None, TECH, resolution=RES,
                                    device=CPU))
        svc = service(mode="multihost",
                      mesh=host_spec_mesh([CPU] * 8, n_hosts=2))
        with ServiceFrontend(svc, window=0.05, max_batch=16) as front:
            tickets = [front.submit(SynthesisRequest(spec=s)) for s in specs]
            responses = [t.result(timeout=600) for t in tickets]
        assert texts(r.result for r in responses) == ref
        assert front.stats.served == 13 and front.stats.shedded == 0
        assert svc.stats.fused_passes >= 1


@pytest.fixture
def traced():
    configure(enabled=True, sample=1.0)
    tracer.clear()
    yield tracer
    tracer.configure(enabled=False)
    tracer.clear()


class TestObsEightDevices:
    def test_eight_entries_span_alignment(self, traced):
        """Tracing on, a 6-spec stream through the async frontend over a
        multihost-mode service on 8 entries: every request's span
        boundaries equal its response stamps, every request cross-links
        an engine pass, and the execute span counts the mesh's entries."""
        specs = spec_variants(6, seed=9)
        svc = service(mode="multihost",
                      mesh=host_spec_mesh([CPU] * 8, n_hosts=2))
        with ServiceFrontend(svc, window=0.05, max_batch=8) as front:
            tickets = [front.submit(SynthesisRequest(spec=s)) for s in specs]
            responses = [t.result(timeout=600) for t in tickets]
        spans = tracer.drain()
        roots = [s for s in spans if s.name == "request"]
        assert len(roots) == 6 and front.stats.served == 6
        assert front.stats.shedded == 0
        assert all(any(s.start_s == r.queued_at and s.end_s == r.served_at
                       for s in roots) for r in responses)
        passes = [s for s in spans if s.name == "engine.pass"]
        links = [s for s in spans if s.name == "request.engine"]
        assert len(passes) >= 1 and len(links) == 6
        pass_ids = {s.span_id for s in passes}
        assert all(link.tags["engine_pass"] in pass_ids for link in links)
        executes = [s for s in spans if s.name == "engine.execute"]
        assert executes and all(s.tags["n_dev"] == 8
                                and s.tags["mode"] == "multihost"
                                for s in executes)
        places = [s for s in spans if s.name == "engine.place"]
        assert places and all(s.tags["n_dev"] == 8 for s in places)


# ---------------------------------------------------------------------------
# The multi-process branch: gloo groups of 2 and 3 ranks
# ---------------------------------------------------------------------------


DRILL_SCRIPT = r'''
import dataclasses, json, pathlib, sys

import torch.distributed as dist
import torch.multiprocessing as mp

''' + inspect.getsource(result_text) + r'''

def worker(rank, world, work):
    dist.init_process_group("gloo", init_method=f"file://{work}/init",
                            rank=rank, world_size=world)
    try:
        import repro_torch.core as C
        from repro_torch.core.shardspec import (mso_search_many_sharded,
                                                spec_variants)
        from repro_torch.parallel import host_spec_mesh
        tech = C.calibrated_tech_for_reference()
        specs = spec_variants(13, seed=5)
        mesh = host_spec_mesh(["cpu"] * 2)       # this rank's 2 entries
        got = mso_search_many_sharded(specs, None, tech, resolution=3,
                                      mesh=mesh, mode="multihost")
        try:
            mso_search_many_sharded(specs[:2], None, tech, resolution=3,
                                    mesh=host_spec_mesh(["cpu"],
                                                        n_hosts=world + 1),
                                    mode="multihost")
            mismatch = "no error"
        except ValueError as e:
            mismatch = str(e)
        (pathlib.Path(work) / f"rank{rank}.json").write_text(json.dumps({
            "mesh": list(mesh.devices.shape),
            "results": [result_text(r) for r in got],
            "mismatch": mismatch}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, work = int(sys.argv[1]), sys.argv[2]
    mp.spawn(worker, args=(world, work), nprocs=world, join=True)
'''


class TestMultiProcess:
    @pytest.mark.parametrize("world", [2, 3])
    def test_gloo_drill_equals_single_process(self, world, tmp_path,
                                              unsharded):
        """Each rank runs its lane slice of the 13-spec request (ragged on
        2 and 3 ranks, 2 entries each) and all-gathers the outputs: every
        rank's result equals the single-process pass, and a mesh whose
        host count disagrees with the world size raises on every rank."""
        script = tmp_path / "drill.py"
        script.write_text(DRILL_SCRIPT)
        proc = subprocess.run(
            [sys.executable, str(script), str(world), str(tmp_path)],
            env=_env(), capture_output=True, text=True, timeout=300,
            cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-4000:]
        for rank in range(world):
            out = json.loads((tmp_path / f"rank{rank}.json").read_text())
            assert out["mesh"] == [world, 2]
            assert out["results"] == unsharded[13], rank
            assert "host rows" in out["mismatch"], out["mismatch"]

    def test_world_of_one_is_the_single_controller(self, monkeypatch):
        """Without a process group the strategy never touches
        ``torch.distributed``'s collectives."""
        monkeypatch.setattr(torch.distributed, "all_gather",
                            lambda *a, **k: pytest.fail("all_gather"))
        got = mso_search_many_sharded(spec_variants(3, seed=5), None, TECH,
                                      resolution=RES, mode="multihost",
                                      mesh=host_spec_mesh([CPU] * 4,
                                                          n_hosts=2))
        ref = mso_search_many(spec_variants(3, seed=5), None, TECH,
                              resolution=RES, device=CPU)
        assert texts(got) == texts(ref)


# ---------------------------------------------------------------------------
# scripts/torch_warm_cache.py passes a sharded mode through
# ---------------------------------------------------------------------------


class TestWarmCacheScript:
    @pytest.mark.parametrize("mode", ["sharded", "multihost"])
    def test_sharded_mode_warms_the_store(self, mode, tmp_path):
        store = tmp_path / "store"
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "torch_warm_cache.py"),
             "--device", CPU, "--mode", mode, "--store", str(store),
             "--resolutions", "3", "--scenarios", "vision,cloud"],
            env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
            text=True, timeout=300, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "2 synthesized, 0 already warm" in proc.stdout
        svc = service(cache=FrontierCache(store_dir=store))
        specs = [C.scenario_specs()[n] for n in ("vision", "cloud")]
        got = svc.synthesize_many(specs)
        assert svc.stats.fused_passes == 0
        assert texts(got) == texts(mso_search_many(
            specs, None, TECH, resolution=RES, device=CPU))
