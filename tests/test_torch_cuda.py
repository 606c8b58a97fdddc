"""The port on the CUDA card: the hand-written ``dcim_mac``, ``csa_tree``
and ``ssm_scan`` kernels and their profiling skeletons against their plain
torch versions, the MoE slot assignment (``moe_dispatch``) against its
plain loop on the CPU and in a granite decode step, the tile autotuner's winners, the kernel profiler, the
compiler's device path against the CPU and its two kernels
(``lattice_rollup``, ``pareto_dominated``) against their plain versions,
with their launch counts, and the model zoo's smoke configs and serving
launcher on the card.

Every test here needs a card, carries the ``cuda`` marker and skips with a
reason where none is visible (the kernel has no CPU mode).  The module
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none for ``dcim_mac``, ``csa_tree`` and ``moe_dispatch``
(int32, float32, bfloat16 and bool outputs must equal the plain version's
bits), for every skeleton's data token, and for the compiler (its arrays
and verdicts must equal the CPU's and the plain versions' bits).
``ssm_scan`` is a float scan: it must equal its chunked plain version bit
for bit at every tile and depth, and stay within the JAX package's
rtol/atol of 2e-5 (3e-5 on ragged shapes) of the sequential plain
version.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as C
from repro_torch.convert import mac_operands_from_numpy
from repro_torch.core import subcircuits as sc
from repro_torch.convert import (csa_operands_from_numpy,
                                 ssm_operands_from_numpy)
from repro_torch.kernels import TileConfig, autotune
from repro_torch.kernels.build import (SKELETONS, library_path,
                                      ptxas_report, wgmma_serialized)
from repro_torch.kernels.csa_tree import (CSA_MAX_ROWS, CSA_REG_ROWS,
                                          csa_tree_ref, csa_tree_rows_cuda,
                                          csa_tree_sum, csa_tree_tiled_cuda)
from repro_torch.kernels.csa_tree import kernel as csa_kernel
from repro_torch.kernels.csa_tree.kernel import register_library
from repro_torch.kernels.csa_tree.ref import csa_tree_copy_ref
from repro_torch.kernels.dcim_mac import (dcim_matmul, dcim_matmul_int,
                                          mac_plan, mac_route, ref)
from repro_torch.kernels.dcim_mac import kernel as mac_kernel
from repro_torch.kernels.tiles import MAC_DEPTHS, smem_bytes
from repro_torch.kernels.profile import profile_kernel
from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,
                                          ssm_scan_chunked_ref, ssm_scan_ref)
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_compute_ref,
                                              ssm_scan_copy_ref)
from repro_torch.obs.metrics import get_registry
from repro_torch.core import batched as B
from repro_torch.core import engine as E
from repro_torch.core import pareto as P
from repro_torch.core.pareto import dominated_ref
from repro_torch.parallel import spec_sweep_mesh
from repro_torch.kernels.lattice_rollup import kernel as rollup_kernel
from repro_torch.kernels.pareto_dominated import kernel as dom_kernel
from torch_dominance_cases import dominance_cases

pytestmark = pytest.mark.cuda

FULL_LATTICE = C.LatticeConfig(precision_modes=3,
                               approx_cells=sc.APPROX_CELLS)

# padded, one block, multi-block, ragged, a single row, and the qwen3-4b
# wk GEMM at seq 256; then TMA-route shapes at a small K with each split
# count the plan picks for the qwen3-4b GEMMs (1, 2, 4, 8), ragged M and N
# strips, M > 256, and aligned squares (M == N: a row scale read as a
# column scale would show)
MAC_SHAPES = [(8, 16, 8), (128, 128, 128), (128, 256, 384), (130, 96, 200),
              (1, 512, 64), (256, 2560, 1024),
              (256, 256, 512), (256, 1024, 4096), (256, 768, 512),
              (256, 1024, 256), (130, 96, 208), (600, 640, 384),
              (256, 256, 256), (512, 384, 512)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def operands(m, k, n, seed, device):
    rng = np.random.default_rng(seed)
    return mac_operands_from_numpy(
        rng.integers(-128, 128, (m, k), dtype=np.int8),
        rng.integers(-128, 128, (k, n), dtype=np.int8),
        rng.uniform(0.01, 2.0, m).astype(np.float32),
        rng.uniform(0.01, 2.0, n).astype(np.float32), device=device)


@pytest.mark.parametrize("m,k,n", MAC_SHAPES)
def test_int_kernel_equals_plain_version(cuda_device, m, k, n):
    a, w, _, _ = operands(m, k, n, seed=m + k, device=cuda_device)
    route = mac_route(m, k, n, a.data_ptr(), w.data_ptr())
    before = dict(dcim_matmul_int.launches)
    got = dcim_matmul_int(a, w)
    assert dcim_matmul_int.launches == {**before, route: before[route] + 1}
    assert torch.equal(got, ref.dcim_matmul_int_ref(a, w))


def test_mac_shapes_cover_both_routes_and_every_split(cuda_device):
    routes = {mac_route(m, k, n) for m, k, n in MAC_SHAPES}
    assert routes == {"pipelined", "grid"}
    splits = {mac_plan(m, k, n).splits for m, k, n in MAC_SHAPES
              if mac_route(m, k, n) == "pipelined"}
    assert splits == {1, 2, 4, 8}


@pytest.mark.parametrize("depth", MAC_DEPTHS)
@pytest.mark.parametrize("m,k,n", [(256, 1024, 256), (300, 640, 384)])
def test_every_ring_depth_equals_plain_version(cuda_device, depth, m, k, n):
    a, w, asc, wsc = operands(m, k, n, seed=depth, device=cuda_device)
    tc = TileConfig(depth=depth)
    assert torch.equal(dcim_matmul_int(a, w, tile_config=tc),
                       ref.dcim_matmul_int_ref(a, w))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(dcim_matmul(a, w, asc, wsc, out_dtype=dt,
                                       tile_config=tc),
                           ref.dcim_matmul_ref(a, w, asc, wsc, out_dtype=dt))


def test_square_tma_scales_are_per_row_and_per_column(cuda_device):
    """M == N on the TMA route with distinct row and column scales."""
    m = n = 256
    a, w, _, _ = operands(m, 512, n, seed=11, device=cuda_device)
    asc = torch.linspace(0.5, 2.0, m, device=cuda_device)
    wsc = torch.linspace(3.0, 0.25, n, device=cuda_device)
    assert mac_route(m, 512, n, a.data_ptr(), w.data_ptr()) == "pipelined"
    got = dcim_matmul(a, w, asc, wsc)
    assert torch.equal(got, ref.dcim_matmul_ref(a, w, asc, wsc))
    assert not torch.equal(got, ref.dcim_matmul_ref(a, w, wsc, asc))


def test_dcim_mac_kernels_do_not_spill(cuda_device):
    """No dcim_mac kernel spills, ptxas keeps every TMA kernel's wgmma
    pipeline, and the TMA kernels have the 168 registers a thread their
    setmaxnreg budget assumes; the tile space's shared memory is the
    kernel's own count."""
    mac_kernel._lib()
    log = library_path("dcim_mac").with_suffix(".log").read_text()
    report = ptxas_report(log)
    assert len(report) == 3 * (1 + len(MAC_DEPTHS))
    for fn, usage in report.items():
        assert usage["spill_stores"] == usage["spill_loads"] == 0, fn
        if "tma" in fn:
            assert usage["registers"] == 168, fn
    assert wgmma_serialized(log) == set()
    for d in MAC_DEPTHS:
        assert mac_kernel.tma_smem_bytes(d) == smem_bytes(
            "dcim_mac", TileConfig(bm=256, bn=128, bk=128, depth=d))


@pytest.mark.parametrize("m,k,n", MAC_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_dequant_kernel_equals_plain_version(cuda_device, m, k, n,
                                             out_dtype):
    a, w, asc, wsc = operands(m, k, n, seed=m + n, device=cuda_device)
    got = dcim_matmul(a, w, asc, wsc, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, ref.dcim_matmul_ref(a, w, asc, wsc,
                                                out_dtype=out_dtype))


def test_kernel_equals_bitserial_reference(cuda_device):
    a, w, _, _ = operands(64, 96, 72, seed=1, device=cuda_device)
    assert torch.equal(dcim_matmul_int(a, w),
                       ref.dcim_matmul_bitserial_ref(a, w, 8, 8))


def test_misaligned_operands_take_the_byte_path(cuda_device):
    """A view that starts one byte into its storage cannot use 16-byte
    loads; the kernel must still be exact."""
    a, w, _, _ = operands(33, 64, 48, seed=2, device=cuda_device)
    a_off = torch.empty(a.numel() + 1, dtype=torch.int8,
                        device=cuda_device)[1:].view(a.shape)
    a_off.copy_(a)
    assert torch.equal(dcim_matmul_int(a_off, w),
                       ref.dcim_matmul_int_ref(a, w))


def test_misaligned_tma_shape_takes_the_grid_route(cuda_device):
    """A shape the TMA route takes, with an A one byte into its storage:
    the grid kernel runs it, exactly."""
    a, w, asc, wsc = operands(256, 512, 256, seed=3, device=cuda_device)
    a_off = torch.empty(a.numel() + 1, dtype=torch.int8,
                        device=cuda_device)[1:].view(a.shape)
    a_off.copy_(a)
    before = dict(dcim_matmul.launches)
    got = dcim_matmul(a_off, w, asc, wsc)
    assert dcim_matmul.launches == {**before, "grid": before["grid"] + 1}
    assert torch.equal(got, ref.dcim_matmul_ref(a, w, asc, wsc))


def test_compiler_device_path_equals_cpu(cuda_device):
    """The lattice roll-up and the frontier on the card, bit for bit
    against the CPU (one spec, the full registered lattice)."""
    tech = C.calibrated_tech_for_reference()
    spec = C.scenario_specs()["language"]
    config = C.LatticeConfig(precision_modes=3,
                             approx_cells=sc.APPROX_CELLS)
    gpu = C.design_space_sweep(spec, tech, config=config, device=cuda_device)
    cpu = C.design_space_sweep(spec, tech, config=config, device="cpu")
    for k in ("mac", "crit", "fmax", "area", "tops_mm2"):
        np.testing.assert_array_equal(
            getattr(gpu.ppa, k).view(np.uint64),
            getattr(cpu.ppa, k).view(np.uint64))
    for m, v in cpu.ppa.e_cycle.items():
        np.testing.assert_array_equal(gpu.ppa.e_cycle[m].view(np.uint64),
                                      v.view(np.uint64))
    assert gpu.frontier_indices() == cpu.frontier_indices()


@pytest.mark.parametrize("mode", ["jit", "pmap", "multihost"])
def test_sharded_engine_on_the_card_equals_cpu(cuda_device, mode):
    """The sharded engine over four entries of the card (a ragged 5-spec
    request) and its sweep's frontier through A3, bit for bit against the
    unsharded CPU pass."""
    from repro_torch.core.shardspec import (design_space_sweep_many_sharded,
                                            mso_search_many_sharded,
                                            spec_variants)
    from repro_torch.parallel import host_spec_mesh, spec_sweep_mesh
    tech = C.calibrated_tech_for_reference()
    entries = [f"cuda:{cuda_device.index or 0}"] * 4
    mesh = (host_spec_mesh(entries) if mode == "multihost"
            else spec_sweep_mesh(entries))
    specs = spec_variants(5, seed=3)
    got = mso_search_many_sharded(specs, None, tech, mesh=mesh, mode=mode)
    ref = C.mso_search_many(specs, None, tech, device="cpu")
    assert [repr(r) for r in got] == [repr(r) for r in ref]
    (sweep,) = design_space_sweep_many_sharded(specs[:1], tech, mesh=mesh,
                                               mode=mode)
    (cpu,) = C.design_space_sweep_many(specs[:1], tech, device="cpu")
    assert sweep.frontier_indices() == cpu.frontier_indices()


# -- the compiler's device kernels (A1, A2, A3) -------------------------------

DOMINANCE_CASES = dominance_cases(P.PARETO_EPS, seed=0)


@pytest.mark.parametrize("case", DOMINANCE_CASES,
                         ids=[c.name for c in DOMINANCE_CASES])
def test_dominance_kernel_equals_plain_version(cuda_device, case):
    """The eps-band dominance kernel against its plain version on the card
    and on the CPU, bit for bit: one binding call, and the passes
    ``passes`` names for it (the split pass where a test is longer than the
    screen's rows)."""
    eps = P.PARETO_EPS
    rows = torch.as_tensor(case.rows, device=cuda_device)
    cands = torch.as_tensor(case.cands, device=cuda_device)
    before = dict(dom_kernel.LAUNCHES)
    passes_before = dict(dom_kernel.PASS_LAUNCHES)
    got = P.dominated(rows, cands, eps, seg=case.seg)
    torch.cuda.synchronize()
    mode = "seg" if case.seg else "all"
    assert dom_kernel.LAUNCHES == {**before, mode: before[mode] + 1}
    ran = dom_kernel.passes(len(case.rows), len(case.cands), case.seg,
                            case.rows.shape[1])
    assert dom_kernel.PASS_LAUNCHES == {
        k: v + (k in ran) for k, v in passes_before.items()}
    assert got.device == cands.device and got.dtype == torch.bool
    assert torch.equal(got, dominated_ref(rows, cands, eps, case.seg))
    assert torch.equal(got.cpu(), dominated_ref(rows.cpu(), cands.cpu(), eps,
                                                case.seg))


def test_dominance_split_pass_takes_the_screens_survivors(cuda_device):
    """The survivor count the screen pass leaves: every candidate of an
    anti-chain (nothing dominates anything), a few of the lone-front set
    (the one point that dominates all sits on a row the screen does not
    sample), and none where no split pass runs."""
    eps = P.PARETO_EPS
    by_name = {c.name: c for c in DOMINANCE_CASES}
    for name, check in (("antichain_10k", lambda s, c: s == c),
                        ("plane_5k", lambda s, c: s == c),
                        ("lone_front", lambda s, c: 1 <= s < c),
                        ("seg_1024_budget", lambda s, c: s == 0)):
        case = by_name[name]
        rows = torch.as_tensor(case.rows, device=cuda_device)
        cands = torch.as_tensor(case.cands, device=cuda_device)
        stats = {}
        got = dom_kernel.pareto_dominated_cuda(rows, cands, eps, case.seg,
                                               stats=stats)
        survivors = int(stats["survivors"].item())
        assert check(survivors, len(case.cands)), (name, survivors)
        assert torch.equal(got, dominated_ref(rows, cands, eps, case.seg))


@pytest.mark.parametrize("k", [0, 9, 12, 64, 80])
@pytest.mark.parametrize("seg", [0, 100, 1100])
def test_dominance_wide_route_equals_plain_version(cuda_device, k, seg):
    """More objectives than the screen takes, and none, go to the wide
    kernels: the wide screen, and the wide split where a test is longer
    than the screen's rows (never at k = 0), each counted under its pass,
    with the plain version's verdicts (every one False at k = 0).  80
    objectives are past the staging limit (rows and bounds read in
    place)."""
    rng = np.random.default_rng(k)
    objs = np.floor(rng.random((1500, k)) * 3) * 1e-3
    rows = torch.as_tensor(objs, device=cuda_device)
    before = dict(dom_kernel.PASS_LAUNCHES)
    got = P.dominated(rows, rows, P.PARETO_EPS, seg=seg)
    torch.cuda.synchronize()
    ran = dom_kernel.passes(1500, 1500, seg, k)
    assert ran == (("wide_screen",) if k == 0 else
                   ("wide_screen", "wide_split") if seg in (0, 1100) else
                   ("wide_screen",))
    assert dom_kernel.PASS_LAUNCHES == {
        name: v + (name in ran) for name, v in before.items()}
    want = dominated_ref(rows, rows, P.PARETO_EPS, seg)
    assert torch.equal(got, want)
    if k == 0:
        assert not got.any()
    elif k <= 12:
        assert got.any() and not got.all()


def test_dominance_wide_route_fills_stats(cuda_device):
    """The wide passes fill ``stats`` as the narrow ones do: the survivors
    the wide screen left to the wide split (at least the 800 simplex points
    of ``simplex_k80`` that nothing dominates, fewer than all 2,400; every
    candidate of ``boundary_witnesses_k80`` whose witness is not a sampled
    row, some but not all; none at k = 0, where no split runs) and three
    CUDA events around the passes."""
    eps = P.PARETO_EPS
    by_name = {c.name: c for c in DOMINANCE_CASES}
    for name, check in (("simplex_k80", lambda s, c: 800 <= s < c),
                        ("boundary_witnesses_k80", lambda s, c: 0 < s < c),
                        ("k0", lambda s, c: s == 0)):
        case = by_name[name]
        rows = torch.as_tensor(case.rows, device=cuda_device)
        cands = torch.as_tensor(case.cands, device=cuda_device)
        stats = {}
        got = dom_kernel.pareto_dominated_cuda(rows, cands, eps, case.seg,
                                               stats=stats)
        torch.cuda.synchronize()
        survivors = int(stats["survivors"].item())
        assert check(survivors, len(case.cands)), (name, survivors)
        e = stats["events"]
        assert len(e) == 3 and all(
            a.elapsed_time(b) >= 0 for a, b in zip(e, e[1:]))
        assert torch.equal(got, dominated_ref(rows, cands, eps, case.seg))


def _rollup_operands(specs, device):
    tech = C.calibrated_tech_for_reference()
    plan = E.plan(specs, tech, config=FULL_LATTICE, device="cpu")
    out = []
    for group in plan.groups:
        packed = E.pack_group([plan.lattices[i] for i in group],
                              [plan.tables[i] for i in group])
        tabs, consts, e_ofu, e_align = packed.operands

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        idx = tuple(torch.as_tensor(a, device=device).to(torch.int64)
                    for a in packed.idx)
        out.append((idx, tuple(f64(t) for t in tabs), f64(consts),
                    f64(e_ofu), f64(e_align)))
    return out


def _ppa_fields(ppa) -> dict:
    """A BatchedPPA's float64 arrays as their bit patterns."""
    out = {k: getattr(ppa, k) for k in ("mac", "crit", "fmax", "area")}
    out.update({f"e_cycle.{m}": v for m, v in ppa.e_cycle.items()})
    out.update({f"breakdown.{k}": v for k, v in ppa.breakdown.items()})
    return {k: np.ascontiguousarray(v).view(np.uint64)
            for k, v in out.items()}


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


@pytest.mark.parametrize("which", ["scenarios", "spec_variants"])
def test_rollup_kernel_equals_plain_version(cuda_device, which):
    """The lattice roll-up kernel against its plain version on the card,
    every output bit for bit, one launch per spec group: the four scenario
    specs at the full registered lattice, and a ragged ``spec_variants``
    request."""
    from repro_torch.core.shardspec import spec_variants
    specs = (list(C.scenario_specs().values()) if which == "scenarios"
             else spec_variants(7, seed=2))
    groups = _rollup_operands(specs, cuda_device)
    before = rollup_kernel.LAUNCHES["rollup"]
    for operands in groups:
        got = B.eval_lattice(*operands)
        want = B._eval_kernel(*operands)
        assert list(got) == list(want)
        assert list(got["breakdown"]) == list(want["breakdown"])
        for k in ("mac_base", "ofu_base", "area", "e_cycle"):
            assert _same_bits(got[k], want[k]), k
        for k, v in want["breakdown"].items():
            assert _same_bits(got["breakdown"][k].contiguous(),
                              v.contiguous()), k
    assert rollup_kernel.LAUNCHES["rollup"] == before + len(groups)


def test_compiler_kernels_launch_once_per_group_and_frontier(cuda_device):
    """design_space_sweep_many of the four scenario specs launches the
    roll-up once (one group) and each frontier's mask once, and equals the
    CPU bit for bit."""
    tech = C.calibrated_tech_for_reference()
    specs = list(C.scenario_specs().values())
    r0, d0 = rollup_kernel.LAUNCHES["rollup"], dict(dom_kernel.LAUNCHES)
    p0 = dict(dom_kernel.PASS_LAUNCHES)
    sweeps = C.design_space_sweep_many(specs, tech, config=FULL_LATTICE,
                                       device=cuda_device)
    fronts = [s.frontier_indices() for s in sweeps]
    assert rollup_kernel.LAUNCHES["rollup"] == r0 + 1
    assert dom_kernel.LAUNCHES == {"all": d0["all"] + 4, "seg": d0["seg"]}
    # two kernels per frontier: the screen, then the split
    assert dom_kernel.PASS_LAUNCHES == {**p0, "screen": p0["screen"] + 4,
                                        "split": p0["split"] + 4}
    cpu = C.design_space_sweep_many(specs, tech, config=FULL_LATTICE,
                                    device="cpu")
    for got, want, front in zip(sweeps, cpu, fronts):
        for k, v in _ppa_fields(want.ppa).items():
            np.testing.assert_array_equal(_ppa_fields(got.ppa)[k], v)
        want.extract_mask = P.nondominated_mask    # the host mask: quicker
        assert front == want.frontier_indices()


def test_sharded_mask_kernel_two_launches_per_entry(cuda_device):
    """A3 on four entries of the card: one phase-1 and one phase-2 call
    per entry, the host mask's bits.  Phase 1's blocks of 1,024 rows are
    decided by the screen pass alone; phase 2 (every row) adds the split
    pass."""
    rng = np.random.default_rng(11)
    objs = rng.random((20_000, 3))
    mesh = spec_sweep_mesh([f"cuda:{cuda_device.index or 0}"] * 4)
    before = dict(dom_kernel.LAUNCHES)
    passes_before = dict(dom_kernel.PASS_LAUNCHES)
    got = P.nondominated_mask_sharded(objs, mesh=mesh)
    assert dom_kernel.LAUNCHES == {"all": before["all"] + 4,
                                   "seg": before["seg"] + 4}
    assert dom_kernel.PASS_LAUNCHES == {
        **passes_before, "screen": passes_before["screen"] + 8,
        "split": passes_before["split"] + 4}
    np.testing.assert_array_equal(got, P.nondominated_mask(objs))


# csa_tree: one row, ragged columns, the macro's 64 rows, past a 128-row
# tile (the tall register kernel), the whole-rows limit, and past it
CSA_SHAPES = [(1, 5), (2, 33), (7, 100), (64, 1000), (130, 257),
              (CSA_MAX_ROWS, 64), (600, 300)]


def csa_stack(h, n, seed, extremes=False):
    rng = np.random.default_rng(seed)
    if extremes:
        x = rng.choice(np.array([-2 ** 31, 2 ** 31 - 1, -1, 0, 1], np.int32),
                       (h, n))
    else:
        x = rng.integers(-2 ** 16, 2 ** 16, (h, n), dtype=np.int32)
    return csa_operands_from_numpy(x, device="cuda")


@pytest.mark.parametrize("h,n", CSA_SHAPES)
@pytest.mark.parametrize("use_compressors", [True, False])
@pytest.mark.parametrize("extremes", [False, True])
def test_csa_tree_kernel_equals_plain_version(cuda_device, h, n,
                                              use_compressors, extremes):
    x = csa_stack(h, n, seed=h * 7 + n, extremes=extremes)
    key = ("tiled" if h > CSA_MAX_ROWS
           else "rows" if h <= CSA_REG_ROWS else "rows_tall")
    before = dict(csa_tree_sum.launches)
    got = csa_tree_sum(x, use_compressors=use_compressors)
    assert csa_tree_sum.launches[key] == before[key] + 1
    assert torch.equal(got, csa_tree_ref(x))


@pytest.mark.parametrize("tc", [TileConfig(bh=32, bn=32),
                                TileConfig(bh=128, bn=64),
                                TileConfig(bh=128, bn=256),
                                TileConfig(bh=7, bn=96)])
def test_csa_tree_tiled_kernel_equals_plain_version(cuda_device, tc):
    for h, n in CSA_SHAPES:
        x = csa_stack(h, n, seed=h + n, extremes=True)
        before = csa_tree_sum.launches["tiled"]
        assert torch.equal(csa_tree_sum(x, tile_config=tc), csa_tree_ref(x))
        assert csa_tree_sum.launches["tiled"] == before + 1


@pytest.mark.parametrize("h", [1, 2, 3, 64, 77, 128])
@pytest.mark.parametrize("use_compressors", [True, False])
def test_csa_tree_register_kernel_equals_plain_version(cuda_device, h,
                                                       use_compressors):
    """The generated h-row register kernel (the rows route)."""
    for n, extremes in ((1000, False), (999, True)):
        x = csa_stack(h, n, seed=h + n, extremes=extremes)
        before = dict(csa_tree_sum.launches)
        got = csa_tree_sum(x, use_compressors=use_compressors)
        assert csa_tree_sum.launches == {**before,
                                         "rows": before["rows"] + 1}
        assert torch.equal(got, csa_tree_ref(x))


@pytest.mark.parametrize("bh", [32, 64, 77, 128])
@pytest.mark.parametrize("use_compressors", [True, False])
def test_csa_tree_tiled_ragged_last_tile(cuda_device, bh, use_compressors):
    """Full tiles and a ragged last one (rows past H read 0), and a stack
    shorter than one tile."""
    for h in (3 * bh + 5, bh - 1 or 1):
        x = csa_stack(h, 515, seed=bh + h, extremes=True)
        got = csa_tree_tiled_cuda(x, use_compressors=use_compressors, bh=bh)
        assert torch.equal(got, csa_tree_ref(x))


@pytest.mark.parametrize("h", [129, 256, 300, CSA_MAX_ROWS])
@pytest.mark.parametrize("use_compressors", [True, False])
def test_csa_tree_tall_register_kernel(cuda_device, h, use_compressors):
    """The generated h-row register kernel on whole stacks taller than a
    tile (the rows route's ``rows_tall`` launches)."""
    for n, extremes in ((1000, True), (65_536 + 5, False)):
        x = csa_stack(h, n, seed=h + n, extremes=extremes)
        before = dict(csa_tree_sum.launches)
        got = csa_tree_sum(x, use_compressors=use_compressors)
        assert csa_tree_sum.launches == {
            **before, "rows_tall": before["rows_tall"] + 1}
        assert torch.equal(got, csa_tree_ref(x))


@pytest.mark.parametrize("h,route,key", [(64, "rows", "rows"),
                                          (300, "rows", "rows_tall"),
                                          (300, "tiled", "tiled")])
def test_csa_tree_launch_functions_count_their_kernel(cuda_device, h, route,
                                                      key):
    """The kernel entry points count where they launch, under the key of
    the kernel that ran."""
    x = csa_stack(h, 257, seed=h, extremes=True)
    fn = csa_tree_rows_cuda if route == "rows" else csa_tree_tiled_cuda
    before = dict(csa_tree_sum.launches)
    got = fn(x)
    assert csa_tree_sum.launches == {**before, key: before[key] + 1}
    assert torch.equal(got, csa_tree_ref(x))


@pytest.mark.parametrize("rows", [CSA_REG_ROWS, 129, 256, 300, CSA_MAX_ROWS])
@pytest.mark.parametrize("use_compressors", [True, False])
def test_csa_tree_register_kernel_does_not_spill(cuda_device, rows,
                                                 use_compressors):
    lib = register_library(rows, use_compressors)
    report = ptxas_report(lib.with_suffix(".log").read_text())
    assert report
    for usage in report.values():
        assert usage["spill_stores"] == usage["spill_loads"] == 0
        assert usage["registers"] <= 255


def test_csa_tree_whole_rows_guard(cuda_device):
    x = csa_stack(CSA_MAX_ROWS + 1, 8, seed=1)
    with pytest.raises(ValueError, match="csa_tree_tiled_cuda"):
        csa_tree_rows_cuda(x)


# ssm_scan: the JAX package's kernel-test shapes, a ragged one, and the
# tuned shape classes
SSM_SHAPES = [(16, 8), (128, 128), (130, 64), (257, 130), (512, 256),
              (1, 32), (1000, 300), (1024, 256)]


def ssm_inputs(t, d, seed, lo=0.7):
    rng = np.random.default_rng(seed)
    return ssm_operands_from_numpy(
        rng.uniform(lo, 1.0, (t, d)), rng.normal(size=(t, d)),
        rng.normal(size=(d,)), device="cuda")


@pytest.mark.parametrize("t,d", SSM_SHAPES)
def test_ssm_scan_depths_equal_and_close_to_plain(cuda_device, t, d):
    a, b, h0 = ssm_inputs(t, d, seed=t + d)
    want_s, want_f = ssm_scan_ref(a, b, h0)
    tol = 2e-5 if t % 32 == 0 and d % 32 == 0 else 3e-5
    outs = {}
    for depth in (1, 2, 3, 4):
        route = "pipelined" if depth >= 2 else "grid"
        before = dict(ssm_scan.launches)
        outs[depth] = ssm_scan(a, b, h0, tile_config=TileConfig(
            bt=32, bd=128, depth=depth))
        # the summary launch of a chunked call, then the states launch
        kernels = 2 if ssm_chunks(t, d)[0] > 1 else 1
        assert ssm_scan.launches == {**before, route: before[route] + kernels}
        s, f = outs[depth]
        torch.testing.assert_close(s, want_s, rtol=tol, atol=tol)
        torch.testing.assert_close(f, want_f, rtol=tol, atol=tol)
        assert torch.equal(f, s[-1])
    for depth in (2, 3, 4):
        assert torch.equal(outs[depth][0], outs[1][0])
        assert torch.equal(outs[depth][1], outs[1][1])


@pytest.mark.parametrize("tc", [TileConfig(bt=1, bd=32, depth=1),
                                TileConfig(bt=64, bd=64, depth=4),
                                TileConfig(bt=256, bd=32, depth=2),
                                TileConfig(bt=100, bd=96, depth=3)])
def test_ssm_scan_tiles_equal(cuda_device, tc):
    a, b, h0 = ssm_inputs(257, 130, seed=3, lo=0.0)
    base = ssm_scan(a, b, h0, tile_config=TileConfig(bt=32, bd=128,
                                                     depth=1))
    got = ssm_scan(a, b, h0, tile_config=tc)
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


@pytest.mark.parametrize("t,d", SSM_SHAPES + [(4096, 256)])
def test_ssm_scan_equals_chunked_plain_version(cuda_device, t, d):
    """Every depth computes the chunked plain version's bits, with the
    chunks ``ssm_chunks`` fixes from the shape."""
    a, b, h0 = ssm_inputs(t, d, seed=t * 3 + d)
    want_s, want_f = ssm_scan_chunked_ref(a, b, h0, ssm_chunks(t, d)[0])
    for depth in (1, 2, 3, 4):
        s, f = ssm_scan(a, b, h0, tile_config=TileConfig(bt=32, bd=128,
                                                         depth=depth))
        assert torch.equal(s, want_s) and torch.equal(f, want_f)


@pytest.mark.parametrize("kernel,shape", [("dcim_mac", (128, 512, 512)),
                                          ("ssm_scan", (1024, 256)),
                                          ("csa_tree", (256, 512))])
def test_autotune_on_the_card_and_auto_dispatch(cuda_device, kernel, shape):
    autotune.clear_memo()
    try:
        res = autotune.autotune(kernel, shape, iters=2)
        (won,) = [c for c in res.candidates if c.config == res.winner]
        assert won.ok and won.max_err <= autotune._MAX_ERR[kernel]
        assert all(res.candidates[i].ok for i in res.frontier)
        counter = get_registry().counter(f"kernel/{kernel}/tile_source/memo")
        before = counter.value
        if kernel == "dcim_mac":
            a, w, _, _ = operands(*shape, seed=0, device=cuda_device)
            dcim_matmul_int(a, w, tile_config="auto")
        elif kernel == "ssm_scan":
            ssm_scan(*ssm_inputs(*shape, seed=0), tile_config="auto")
        else:
            csa_tree_sum(csa_stack(*shape, seed=0), tile_config="auto")
        assert counter.value == before + 1
    finally:
        autotune.clear_memo()


# -- profiling skeletons -----------------------------------------------------

def test_skeleton_libraries_build_clean(cuda_device):
    """The skeleton libraries build from the same sources; no kernel
    spills, ptxas keeps the compute skeleton's wgmma pipeline (no C7520),
    and it has the 168 registers its setmaxnreg budget assumes (checked
    before any skeleton launches: a wrong count could hang it)."""
    mac_kernel._skeleton_lib()
    log = library_path("dcim_mac", SKELETONS).with_suffix(".log").read_text()
    report = ptxas_report(log)
    modes = {fn: mac_kernel.tma_kernel_mode(fn) for fn in report}
    # copy and compute at every ring depth, for each output kind (int32,
    # float32, bfloat16)
    assert sorted(modes.values()) == sorted(["copy", "compute"]
                                            * len(MAC_DEPTHS) * 3)
    assert wgmma_serialized(log) == set()
    for fn, usage in report.items():
        assert usage["spill_stores"] == usage["spill_loads"] == 0, fn
        if modes[fn] == "compute":
            assert usage["registers"] == 168, fn
    ssm_kernel._skeleton_lib()
    log = library_path("ssm_scan", SKELETONS).with_suffix(".log").read_text()
    assert len(ptxas_report(log)) == 2 * 2 * 4


# the qwen3-4b wk and mlp_down GEMMs (K split 8 and 4), a ragged M below
# one wgmma tile, a ragged M and N over a K whose last stage is partial,
# one token, and M past one strip
SKELETON_MAC_SHAPES = [(256, 2560, 1024), (256, 9728, 2560), (32, 128, 128),
                       (130, 2000, 208), (1, 512, 64), (600, 640, 384)]


@pytest.mark.parametrize("mode", ["copy", "compute"])
@pytest.mark.parametrize("m,k,n", SKELETON_MAC_SHAPES)
@pytest.mark.parametrize("depth", MAC_DEPTHS)
def test_dcim_mac_skeleton_equals_plain_version(cuda_device, mode, m, k, n,
                                                depth):
    a, w, _, _ = operands(m, k, n, seed=m + k, device=cuda_device)
    plain = {"copy": ref.dcim_mac_copy_ref,
             "compute": ref.dcim_mac_compute_ref}[mode]
    before = {md: dict(c) for md, c in mac_kernel.SKELETON_LAUNCHES.items()}
    got = mac_kernel.dcim_mac_int_cuda(a, w, depth=depth, _mode=mode)
    before[mode]["int32"] += 1
    assert mac_kernel.SKELETON_LAUNCHES == before
    assert torch.equal(got, plain(a, w))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["copy", "compute"])
@pytest.mark.parametrize("m,k,n", SKELETON_MAC_SHAPES)
@pytest.mark.parametrize("depth", MAC_DEPTHS)
def test_dcim_mac_scaled_skeleton_equals_plain_version(cuda_device, mode, m,
                                                       k, n, depth,
                                                       out_dtype):
    a, w, a_s, w_s = operands(m, k, n, seed=m + k, device=cuda_device)
    plain = {"copy": ref.dcim_mac_copy_scaled_ref,
             "compute": ref.dcim_mac_compute_scaled_ref}[mode]
    before = {md: dict(c) for md, c in mac_kernel.SKELETON_LAUNCHES.items()}
    got = mac_kernel.dcim_mac_cuda(a, w, a_s, w_s, out_dtype, depth=depth,
                                   _mode=mode)
    before[mode][str(out_dtype).removeprefix("torch.")] += 1
    assert mac_kernel.SKELETON_LAUNCHES == before
    assert got.dtype == out_dtype
    assert torch.equal(got, plain(a, w, a_s, w_s, out_dtype))


def test_dcim_mac_skeleton_needs_the_tma_kernel(cuda_device):
    a, w, _, _ = operands(8, 100, 64, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        mac_kernel.dcim_mac_int_cuda(a, w, _mode="copy")


@pytest.mark.parametrize("h,n,bh", [(2560, 4096, 128), (600, 300, 128),
                                    (513, 1000, 64), (300, 41, 32),
                                    (1, 5, 128), (77, 999, 77)])
def test_csa_tree_copy_skeleton_equals_plain_version(cuda_device, h, n, bh):
    x = csa_stack(h, n, seed=h + n)
    before = dict(csa_kernel.SKELETON_LAUNCHES)
    got = csa_tree_tiled_cuda(x, bh=bh, _mode="copy")
    assert csa_kernel.SKELETON_LAUNCHES == {"copy": before["copy"] + 1}
    assert torch.equal(got, csa_tree_copy_ref(x, bh))


def test_csa_tree_has_no_compute_skeleton(cuda_device):
    with pytest.raises(ValueError, match="no compute skeleton"):
        csa_tree_tiled_cuda(csa_stack(8, 8, seed=0), _mode="compute")


# chunked (T a multiple of bt, and not), one pass (S = 1, both), and the
# tuned shape class
SKELETON_SSM_SHAPES = [(1024, 256), (1000, 300), (4096, 256), (100, 16384),
                       (128, 16384)]


@pytest.mark.parametrize("mode", ["copy", "compute"])
@pytest.mark.parametrize("t,d", SKELETON_SSM_SHAPES)
@pytest.mark.parametrize("tc", [TileConfig(bt=32, bd=128, depth=d)
                                for d in (1, 2, 3, 4)]
                         + [TileConfig(bt=64, bd=64, depth=2)])
def test_ssm_scan_skeleton_equals_plain_version(cuda_device, mode, t, d, tc):
    a, b, h0 = ssm_inputs(t, d, seed=t + d)
    chunks = ssm_chunks(t, d)[0]
    before = dict(ssm_kernel.SKELETON_LAUNCHES)
    s, f = ssm_kernel.ssm_scan_cuda(a, b, h0, bt=tc.bt, bd=tc.bd,
                                    depth=tc.depth, _mode=mode)
    kernels = 2 if chunks > 1 else 1
    assert ssm_kernel.SKELETON_LAUNCHES == {**before,
                                            mode: before[mode] + kernels}
    if mode == "copy":
        want_s, want_f = ssm_scan_copy_ref(a, b, h0, tc.bt)
        assert torch.equal(s, want_s)
    else:
        want_s, want_f = ssm_scan_compute_ref(a, b, h0, chunks, tc.bt)
        assert s is None and want_s is None
    assert torch.equal(f, want_f)


@pytest.mark.parametrize("kernel,shape", [("dcim_mac", (256, 2560, 1024)),
                                          ("ssm_scan", (1024, 256)),
                                          ("csa_tree", (600, 256))])
def test_profile_kernel_on_the_card(cuda_device, kernel, shape):
    """On the card the profiler times the CUDA skeletons; only csa_tree's
    compute time is derived."""
    p = profile_kernel(kernel, shape, iters=2)
    assert p.backend == "cuda"
    assert p.compute_measured == (kernel != "csa_tree")
    assert p.t_copy_us > 0 and p.t_fused_us > 0
    assert p.t_compute_us > 0 or kernel == "csa_tree"
    assert 0 < p.roofline_fraction <= 1


# -- the synthesis service and the layout tail on the card -------------------

def test_get_service_builds_on_the_card(cuda_device):
    """The process-wide service resolves the card once, and its fused pass
    equals the same pass on the CPU bit for bit."""
    from repro_torch.core.macro import MacroSpec
    from repro_torch.service import (SynthesisRequest, SynthesisService,
                                     get_service, reset_service)
    from repro_torch.service.artifacts import result_to_payload

    reset_service()
    try:
        svc = get_service()
        assert svc is get_service()
        assert svc.device.type == "cuda" and svc.device.index is not None
        reqs = [SynthesisRequest(spec=s, resolution=3)
                for s in list(C.scenario_specs().values())
                + [MacroSpec(h=32, w=32, mcr=2)]]
        got = svc.serve(reqs)
        assert svc.stats.fused_passes == 1
        want = SynthesisService(device="cpu").serve(reqs)
        assert [result_to_payload(r.result) for r in got] == \
            [result_to_payload(r.result) for r in want]
    finally:
        reset_service()


@pytest.mark.parametrize("kernel,shape", [("dcim_mac", (128, 512, 512)),
                                          ("ssm_scan", (1024, 256)),
                                          ("csa_tree", (256, 512))])
def test_tile_config_auto_resolves_from_the_registry(cuda_device, tmp_path,
                                                     kernel, shape):
    """A tuning published to an ``ArtifactRegistry`` is what a cold
    process's ``tile_config="auto"`` launches with."""
    from repro_torch.service import ArtifactRegistry

    registry = ArtifactRegistry(tmp_path)
    autotune.clear_memo()
    try:
        res = autotune.autotune(kernel, shape, iters=2, registry=registry,
                                memoize=False)
        autotune.set_registry(ArtifactRegistry(tmp_path))
        counter = get_registry().counter(
            f"kernel/{kernel}/tile_source/registry")
        before = counter.value
        if kernel == "dcim_mac":
            a, w, s_a, s_w = operands(*shape, seed=0, device=cuda_device)
            got = dcim_matmul(a, w, s_a, s_w, tile_config="auto")
            want = ref.dcim_matmul_ref(a, w, s_a, s_w)
        elif kernel == "ssm_scan":
            a, b, h0 = ssm_inputs(*shape, seed=0)
            got = ssm_scan(a, b, h0, tile_config="auto")[0]
            want = ssm_scan_chunked_ref(a, b, h0, ssm_chunks(*shape)[0])[0]
        else:
            x = csa_stack(*shape, seed=0)
            got = csa_tree_sum(x, tile_config="auto")
            want = csa_tree_ref(x)
        assert counter.value == before + 1
        assert autotune.lookup(kernel, shape) == res.winner
        assert torch.equal(got.cpu(), want.cpu())
    finally:
        autotune.set_registry(None)
        autotune.clear_memo()


@pytest.mark.parametrize("h", [1, 7, 32, 64, 129, 256])
@pytest.mark.parametrize("fam_i", [0, 12, 19])
def test_csa_tree_equals_gate_level_simulation(cuda_device, h, fam_i):
    """The adder-tree kernel against a second oracle: the gate-level
    simulation of the netlist its Fig. 4 schedule mirrors, on operands
    bounded so that no int32 sum wraps."""
    from repro_torch.core import build_netlist, gatesim
    from repro_torch.core.csa import FAMILY

    rng = np.random.default_rng(h * 31 + fam_i)
    ops = rng.integers(-(2 ** 31) // 512, 2 ** 31 // 512, size=(h, 1000))
    want = gatesim.simulate(build_netlist(FAMILY[fam_i], h), ops)
    got = csa_tree_sum(torch.as_tensor(ops, dtype=torch.int32,
                                       device=cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), want)


# -- the model zoo on the card -------------------------------------------------
MODEL_ARCHS = ["qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b",
               "mistral-large-123b", "internvl2-1b", "whisper-tiny",
               "granite-moe-1b-a400m", "granite-moe-3b-a800m", "rwkv6-7b",
               "zamba2-1.2b"]


def _smoke_models(arch, device):
    """The smoke config's model drawn on the CPU (seed 0) and copied to the
    card."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model, model_class

    cfg = smoke_config(arch)
    api = get_model(cfg)
    cpu = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    card = model_class(cfg)(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)))
    frontend = None
    if cfg.frontend is not None:
        frontend = torch.as_tensor(rng.normal(size=(
            2, cfg.frontend.n_tokens, cfg.frontend.d_frontend)),
            dtype=torch.float32)
    return cfg, api, cpu, card, tokens, frontend


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_smoke_model_on_the_card_equals_the_cpu(cuda_device, arch):
    """float32, TF32 off: prefill logits within 2% of their largest
    magnitude (a float32 ulp may flip one fake-quant rounding, one int8
    step: 0.8% of a row's range) and the greedy tokens equal."""
    from repro_torch.serve import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, api, cpu, card, tokens, frontend = _smoke_models(arch, cuda_device)
    dev = None if frontend is None else frontend.to(cuda_device)
    got, state = api.prefill(card, tokens.to(cuda_device), 20, frontend=dev)
    want, _ = api.prefill(cpu, tokens, 20, frontend=frontend)
    assert all(x.device.type == "cuda" for x in state.values())
    assert state["pos"].item() == 12
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=0.02 * want.abs().max().item())
    gen = greedy_generate(api, card, tokens.to(cuda_device), 6, frontend=dev)
    assert torch.equal(gen.cpu(),
                       greedy_generate(api, cpu, tokens, 6, frontend=frontend))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_two_full_width_layers_on_the_card_equal_the_cpu(cuda_device, arch,
                                                         monkeypatch):
    """The full config cut to 2 layers, float32 without fake-quant, TF32
    off, drawn on the card (seed 0) and copied to the CPU: the prefill's
    last logits within 1e-4 of their largest magnitude (float32 sums in
    another order), the same argmax wherever a row's top two differ by
    more than twice the largest difference, and 8 greedy tokens equal.
    For MoE the expert choices must agree too (a near-tie flip would
    move whole expert outputs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, model_class
    from repro_torch.serve import greedy_generate
    from torch_expert_choices import expert_flip, record_expert_choices

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).replace(n_layers=2, param_dtype="float32",
                                   compute_dtype="float32",
                                   dcim_enabled=False)
    api = get_model(cfg)
    card = api.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                           device=cuda_device)
    cpu = model_class(cfg)(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    choices = record_expert_choices(monkeypatch)
    got, _ = api.prefill(card, tokens.to(cuda_device), 40)
    want, _ = api.prefill(cpu, tokens, 40)
    got, want = got[:, -1, :cfg.vocab].cpu(), want[:, -1, :cfg.vocab]
    d = (got - want).abs().max().item()
    assert d <= 1e-4 * want.abs().max().item(), d
    top = want.topk(2, -1).values
    decisive = (top[:, 0] - top[:, 1]) > 2 * d
    assert torch.all((got.argmax(-1) == want.argmax(-1)) | ~decisive)
    assert expert_flip(choices["cuda"], choices["cpu"], 0.0) is None
    gen = greedy_generate(api, card, tokens.to(cuda_device), 8)
    assert torch.equal(gen.cpu(), greedy_generate(api, cpu, tokens, 8))


def test_decode_writes_the_card_cache_in_place(cuda_device):
    cfg, api, _, card, tokens, _ = _smoke_models("qwen3-4b", cuda_device)
    _, state = api.prefill(card, tokens.to(cuda_device), 16)
    k = state["k"]
    _, state = api.decode_step(card, state, tokens[:, :1].to(cuda_device))
    assert state["k"] is k and state["pos"].item() == 13
    assert torch.count_nonzero(k[:, :, 12]) > 0
    assert torch.count_nonzero(k[:, :, 13:]) == 0


def test_launcher_serves_on_the_card(cuda_device, capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--arch", "qwen3-4b", "--smoke", "--batch", "2",
                 "--prompt-len", "8", "--decode-steps", "4"])
    out = capsys.readouterr().out
    assert f"on {torch.cuda.get_device_name(0)}" in out
    assert "device=cuda:0" in out


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_smoke_train_step_on_the_card_equals_the_cpu(cuda_device, arch,
                                                     monkeypatch):
    """One ``make_train_step`` step of 8 x 16 tokens, float32, TF32 off,
    from the same parameters on the card and on the CPU, under the
    tolerances of ``tests/test_torch_train.py``: loss, ce, aux and grad
    norm within 1e-5 relative, ``m`` / ``v`` within 1e-4 of each leaf's
    largest magnitude and parameters within that plus 0.1 x the learning
    rate (2 x where the CPU's clipped gradient is below 1e-3 of its leaf's
    largest: AdamW's first step may turn its sign); where a fake-quant code or an expert choice of the forward passes
    flipped (one code step, a near-tie within 1e-6), within 1e-3 relative,
    5% for the moments, and for the parameters 1% plus 0.1 x the learning
    rate (2 x where the gradient is below 5% of its leaf's largest)."""
    import repro_torch.quant.quantizers as TQ
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.kernels.fake_quant import fake_quant_cuda
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.train import make_train_step
    from torch_expert_choices import expert_flip, record_expert_choices

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, api, cpu, card, _, _ = _smoke_models(arch, cuda_device)
    fr = cfg.frontend
    batch = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=8,
        frontend_tokens=fr.n_tokens if fr else 0,
        frontend_dim=fr.d_frontend if fr else 0)).batch(0)
    codes = {"cuda": [], "cpu": []}
    quantize = TQ.quantize_int

    def recording(*a, **k):
        q, s = quantize(*a, **k)
        if torch._C._current_graph_task_id() == -1:     # not a recompute
            codes[q.device.type].append(q.cpu())
        return q, s

    def recording_kernel(x, bits, axis):
        # the card's fake-quant is the kernel: its codes, in call order
        out, q = fake_quant_cuda(x, bits, axis, codes=True)
        if torch._C._current_graph_task_id() == -1:
            codes["cuda"].append(q.cpu())
        return out

    monkeypatch.setattr(TQ, "quantize_int", recording)
    monkeypatch.setattr(TQ, "_fake_quant_kernel", recording_kernel)
    choices = record_expert_choices(monkeypatch)
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        opt = adamw_init(dict(model.named_parameters()))
        _, opt, m = make_train_step(api, constant_lr(1e-3))(model, opt, batch)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {n: p.detach().cpu() for n, p in model.named_parameters()},
                    {k: {n: t.cpu() for n, t in opt[k].items()}
                     for k in ("m", "v")})
    assert len(codes["cuda"]) == len(codes["cpu"])
    # the first quantizer call that differs must differ by one code step
    steps = [(a.int() - b.int()).abs().max().item()
             for a, b in zip(codes["cuda"], codes["cpu"])]
    first = next((d for d in steps if d), 0)
    assert first <= 1
    # the dispatches come in the same order on both devices (each repeated
    # by remat's recomputation alike)
    flip = (first > 0
            or expert_flip(choices["cuda"], choices["cpu"], 1e-6) is not None)
    (gm, gp, gs), (wm, wp, ws) = out["cuda"], out["cpu"]
    tol = 1e-3 if flip else 1e-5
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert abs(gm[key] - wm[key]) <= tol * abs(wm[key]), (key, gm, wm)
    for name, w in wp.items():
        # a gradient below 1e-3 of its leaf's largest (5% with a flip) may
        # turn its step's sign: up to twice the learning rate there
        g = (ws["v"][name] / (1 - 0.95)).sqrt()
        leaf, small = (0.01, 0.05) if flip else (1e-4, 1e-3)
        lr_frac = torch.where(g < small * g.max(), 2.0, 0.1)
        bound = leaf * w.abs().max().item() + 1e-3 * lr_frac
        assert bool(((gp[name] - w).abs() <= bound).all()), name
    for k in ("m", "v"):
        for name, w in ws[k].items():
            frac = 0.05 if flip else 1e-4
            assert (gs[k][name] - w).abs().max().item() <= frac * w.abs(
                ).max().item(), (k, name)


# -- the MoE slot assignment ---------------------------------------------------
# (G, S, E, k, C): granite-3b's decode (4 groups of 256) and prefill (256
# groups), an overflow that drops, one slot an expert, S not a multiple of
# 32, C not a multiple of 4 (scalar stores), one token
MOE_DISPATCH_SHAPES = [(4, 256, 40, 8, 64), (256, 256, 40, 8, 64),
                       (1, 48, 4, 2, 8), (3, 4, 40, 8, 1),
                       (2, 77, 40, 8, 20), (2, 37, 6, 3, 5), (1, 1, 8, 2, 1)]


def _moe_gates(g, s, e, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.softmax(2.0 * torch.randn((g, s, e), generator=gen,
                                           device=device), dim=-1)


def _f32_bits(x):
    return x.detach().cpu().numpy().view(np.int32)


@pytest.mark.parametrize("g,s,e,k,cap", MOE_DISPATCH_SHAPES)
def test_moe_dispatch_kernel_equals_the_loop(cuda_device, g, s, e, k, cap):
    """One launch; dispatch, combine's bits, held and the kept count equal
    the plain loop's on the CPU."""
    from repro_torch.kernels.moe_dispatch import LAUNCHES, moe_dispatch_cuda
    from repro_torch.models import moe

    topv, topi = moe._top_k(_moe_gates(g, s, e, cuda_device, g + s), k)
    n0 = LAUNCHES["dispatch"]
    d, c, held = moe_dispatch_cuda(topv, topi, e, cap)
    torch.cuda.synchronize()
    assert LAUNCHES["dispatch"] == n0 + 1
    want_d, want_c = moe._slots_ref(topv.cpu(), topi.cpu(), e, cap)
    assert d.dtype == torch.bool and c.dtype == torch.float32
    assert torch.equal(d.cpu(), want_d)
    np.testing.assert_array_equal(_f32_bits(c), _f32_bits(want_c))
    assert torch.equal(held.cpu(), want_d.any(-1).to(torch.float32))
    assert int(d.sum()) == int(want_d.sum())


def test_moe_dispatch_kernel_on_exact_ties(cuda_device):
    from repro_torch.models import moe

    gates = torch.tensor([[[0.1, 0.3, 0.3, 0.2, 0.3, 0.3]]],
                         device=cuda_device)
    d, c, _ = moe._top_k_dispatch(gates, 3, 1)
    want_d, want_c, _ = moe._top_k_dispatch(gates.cpu(), 3, 1)
    assert torch.equal(d.cpu(), want_d)
    np.testing.assert_array_equal(_f32_bits(c), _f32_bits(want_c))


@pytest.mark.parametrize("g,s,e,k,cap", MOE_DISPATCH_SHAPES[:4])
def test_moe_dispatch_seam_kernel_equals_loop_on_the_card(cuda_device, g, s,
                                                          e, k, cap,
                                                          monkeypatch):
    """``_top_k_dispatch`` on the card: the kernel's route against the
    loop's, every output (the load-balance loss too) bit for bit; gates
    that take a gradient take the kernel too."""
    from repro_torch.kernels.moe_dispatch import LAUNCHES
    from repro_torch.models import moe

    gates = _moe_gates(g, s, e, cuda_device, 11)
    n0 = LAUNCHES["dispatch"]
    got = moe._top_k_dispatch(gates, k, cap)
    assert LAUNCHES["dispatch"] == n0 + 1
    moe._top_k_dispatch(gates.clone().requires_grad_(), k, cap)
    assert LAUNCHES["dispatch"] == n0 + 2
    monkeypatch.setattr(moe, "_takes_kernel", lambda gates: False)
    want = moe._top_k_dispatch(gates, k, cap)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_f32_bits(a), _f32_bits(b))


@pytest.mark.parametrize("g,s,e,k,cap", MOE_DISPATCH_SHAPES[:4])
def test_moe_dispatch_gradient_equals_the_loop(cuda_device, g, s, e, k, cap,
                                              monkeypatch):
    """The gates' gradient through the kernel (``_CardSlots``) under a
    loss that weighs every element of combine and the load-balance loss:
    the loop's on the card bit for bit, and the CPU loop's within 1e-5
    (the loss's means reduce on another device there)."""
    from repro_torch.kernels.moe_dispatch import LAUNCHES
    from repro_torch.models import moe

    gates = _moe_gates(g, s, e, cuda_device, 13)
    w = torch.randn((g, s, e, cap), device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(
                        14))

    def grad(x):
        x = x.clone().requires_grad_()
        _, combine, aux = moe._top_k_dispatch(x, k, cap)
        ((combine * w.to(x.device)).sum() + aux).backward()
        return x.grad

    n0 = LAUNCHES["dispatch"]
    got = grad(gates)
    assert LAUNCHES["dispatch"] == n0 + 1
    cpu = grad(gates.cpu())
    monkeypatch.setattr(moe, "_takes_kernel", lambda gates: False)
    want = grad(gates)
    np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-6)


def test_granite_decode_step_kernel_equals_loop(cuda_device, monkeypatch):
    """granite-moe-3b-a800m's full config cut to 2 layers, as served
    (bf16, fake-quant on), at the decode cell's batch of 1,024: a prefill
    of 4 tokens (16 groups) and one decode step (4 groups) give the same
    logits bits with the kernel as with the loop, and launch the kernel
    once per MoE layer and call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import LAUNCHES
    from repro_torch.models import get_model, moe

    cfg = get_config("granite-moe-3b-a800m").replace(n_layers=2)
    api = get_model(cfg)
    model = api.init_params(torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1024, 5)), device=cuda_device)

    def serve():
        logits, state = api.prefill(model, tokens[:, :4], 8)
        step, _ = api.decode_step(model, state, tokens[:, 4:])
        return logits, step

    n0 = LAUNCHES["dispatch"]
    got = serve()
    torch.cuda.synchronize()
    assert LAUNCHES["dispatch"] == n0 + 2 * cfg.n_layers
    monkeypatch.setattr(moe, "_takes_kernel", lambda gates: False)
    want = serve()
    for a, b in zip(got, want):
        assert torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
