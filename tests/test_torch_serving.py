"""The port's serving roofline (``repro_torch.roofline``) and the rest of
its ``core.dse`` (macro-array mapping and cross-workload co-design) against
the JAX package's, in process, on the CPU.

* ``map_gemm``, ``batched_workload_matrix``, ``cross_workload_codesign``
  and ``accelerator_report`` against ``repro.core.dse`` on a pool from the
  port's ``frontier_union`` (the four scenario specs' scalar searches),
  over the ``gemm_inventory`` of qwen3-4b and zamba2-1.2b: **bit for bit**
  (both packages get the same design points);
* ``dcim_serving_bound`` and ``inventory_bytes`` against
  ``repro.roofline.dcim`` with ``repro.roofline.hw.HBM_BW`` set to the
  port's H100 figure: **every field equal**;
* the H100 figures of ``repro_torch.roofline.hw``.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.dse as R
import repro.roofline.dcim as R_dcim
import repro.roofline.hw as R_hw
from repro.configs import get_config as jax_get_config

import repro_torch.core as C
from repro_torch.configs import get_config
from repro_torch.core import dse
from repro_torch.roofline import dcim, hw

ARCHS = ("qwen3-4b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def pool():
    """The serving-time candidate pool: the union of the four scenario
    specs' search frontiers."""
    tech = C.calibrated_tech_for_reference()
    scl = C.SubcircuitLibrary(tech).build()
    results = [C.mso_search(s, scl, tech) for s in C.scenario_specs().values()]
    out = C.frontier_union(results)
    assert len(out) > 4
    return out


def inventory(arch, seq=256):
    return C.gemm_inventory(get_config(arch), seq=seq)


def jax_gemms(gemms):
    return [R.GemmShape(**dataclasses.asdict(g)) for g in gemms]


def same(a, b) -> bool:
    """Equal shape and bits (float64 compared as bit patterns)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.uint64),
                                                 b.view(np.uint64))


@pytest.mark.parametrize("arch", ARCHS)
def test_inventory_equals_jax(arch):
    assert [dataclasses.asdict(g) for g in inventory(arch)] == [
        dataclasses.asdict(g) for g in R.gemm_inventory(jax_get_config(arch))]


def _mapping_fields(r):
    return (dataclasses.asdict(r.gemm), r.tiles, r.passes, r.cycles,
            r.weight_reloads, repr(r.energy_pj), repr(r.util))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_macros,ib,wb", [(256, 8, 8), (16, 4, 4),
                                            (1, 8, 2)])
def test_map_gemm_equals_jax(pool, arch, n_macros, ib, wb):
    for g in inventory(arch):
        for ppa in pool:
            got = dse.map_gemm(g, ppa, n_macros, ib, wb)
            want = R.map_gemm(R.GemmShape(**dataclasses.asdict(g)), ppa,
                              n_macros, ib, wb)
            assert _mapping_fields(got) == _mapping_fields(want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_macros,ib,wb", [(256, 8, 8), (16, 4, 4)])
def test_accelerator_report_equals_jax(pool, arch, n_macros, ib, wb):
    gemms = inventory(arch)
    for ppa in pool:
        got = dse.accelerator_report(gemms, ppa, n_macros, ib, wb)
        want = R.accelerator_report(jax_gemms(gemms), ppa, n_macros, ib, wb)
        assert got.summary() == want.summary()
        assert [_mapping_fields(r) for r in got.reports] == \
            [_mapping_fields(r) for r in want.reports]
        for f in ("total_cycles", "total_energy_pj", "wallclock_s",
                  "effective_tops", "avg_util", "area_mm2"):
            assert repr(getattr(got, f)) == repr(getattr(want, f)), f


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_workload_matrix_equals_jax(pool, arch):
    gemms = inventory(arch)
    got = dse.batched_workload_matrix(gemms, pool, 256)
    want = R.batched_workload_matrix(jax_gemms(gemms), pool, 256)
    assert got.designs == want.designs
    for f in dataclasses.fields(want):
        if isinstance(getattr(want, f.name), np.ndarray):
            assert same(getattr(got, f.name), getattr(want, f.name)), f.name
    # and each design's totals equal its scalar report's
    for d, ppa in enumerate(pool):
        rep = dse.accelerator_report(gemms, ppa, 256)
        assert got.total_cycles[d] == rep.total_cycles
        assert got.wallclock_s[d] == rep.wallclock_s


def _codesign(module, pool, gemms_of):
    return module.cross_workload_codesign(
        {arch: gemms_of(inventory(arch)) for arch in ARCHS}, pool)


def test_cross_workload_codesign_equals_jax(pool):
    got = _codesign(dse, pool, list)
    want = _codesign(R, pool, jax_gemms)
    assert got.workloads == want.workloads and got.designs == want.designs
    for f in ("wallclock_s", "energy_pj", "effective_tops", "avg_util",
              "area_mm2", "total_wallclock_s", "total_energy_pj"):
        assert same(getattr(got, f), getattr(want, f)), f
    assert got.frontier == want.frontier and len(got.frontier) > 0
    assert [got.best_for(a) for a in ARCHS] == [want.best_for(a)
                                                for a in ARCHS]
    assert got.summary() == want.summary()


def test_codesign_frontier_ignores_workload_order(pool):
    fwd = dse.cross_workload_codesign(
        {arch: inventory(arch) for arch in ARCHS}, pool)
    rev = dse.cross_workload_codesign(
        {arch: inventory(arch) for arch in reversed(ARCHS)}, pool)
    assert fwd.frontier == rev.frontier
    assert same(fwd.total_wallclock_s, rev.total_wallclock_s)


@pytest.mark.parametrize("workloads,ppas", [({}, None), ({"x": []}, [])])
def test_codesign_needs_workloads_and_designs(workloads, ppas):
    for module in (dse, R):
        with pytest.raises(ValueError, match="need at least one"):
            module.cross_workload_codesign(workloads, ppas or [])


# -- the serving roofline ------------------------------------------------------


@pytest.fixture
def jax_hbm_at_the_ports(monkeypatch):
    monkeypatch.setattr(R_hw, "HBM_BW", hw.HBM_BW)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ib,wb", [(8, 8), (4, 8), (8, 2)])
def test_inventory_bytes_equals_jax(arch, ib, wb):
    gemms = inventory(arch)
    assert dcim.inventory_bytes(gemms, ib, wb) == \
        R_dcim.inventory_bytes(jax_gemms(gemms), ib, wb)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fraction", [1.0, 0.731, 1e-6])
def test_dcim_serving_bound_equals_jax(pool, jax_hbm_at_the_ports, arch,
                                       fraction):
    rep = dse.cross_workload_codesign(
        {a: inventory(a) for a in ARCHS}, pool)
    best = rep.best_for(arch)
    wall = float(rep.wallclock_s[rep.workloads.index(arch), best])
    gemms = inventory(arch)
    got = dcim.dcim_serving_bound(gemms, wall, workload=arch,
                                  macro=rep.designs[best],
                                  kernel_fraction=fraction)
    want = R_dcim.dcim_serving_bound(jax_gemms(gemms), wall, workload=arch,
                                     macro=rep.designs[best],
                                     kernel_fraction=fraction)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()
    assert ("kernel_fraction" in got.summary()) == (fraction != 1.0)
    assert got.t_macro_s == wall / fraction
    assert got.bound_s == max(got.t_macro_s, got.t_hbm_s)


@pytest.mark.parametrize("fraction", [0.0, -0.5, 1.0000001, 2.0])
def test_fraction_outside_zero_one_raises(fraction):
    gemms = inventory("qwen3-4b")
    for module in (dcim, R_dcim):
        with pytest.raises(ValueError, match=r"\(0, 1\]"):
            module.dcim_serving_bound(gemms, 1e-3, kernel_fraction=fraction)


def test_empty_inventory_raises():
    for module in (dcim, R_dcim):
        with pytest.raises(ValueError, match="non-empty"):
            module.dcim_serving_bound([], 1e-3)


def test_h100_figures():
    """NVIDIA's H100 SXM data sheet at 700 W, none of the TPU's."""
    assert (hw.HBM_BW, hw.PEAK_BF16_FLOPS, hw.HBM_PER_CHIP, hw.NVLINK_BW) \
        == (3.35e12, 989e12, 80e9, 900e9)
    assert hw.HBM_BW != R_hw.HBM_BW and hw.PEAK_BF16_FLOPS != \
        R_hw.PEAK_BF16_FLOPS
    assert hw.compute_time_s(989e12, 1) == 1.0
    assert hw.memory_time_s(2 * 3.35e12, 2) == 1.0
    assert hw.collective_time_s(450e9) == 1.0
