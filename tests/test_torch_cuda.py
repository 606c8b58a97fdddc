"""The port on the CUDA card: the hand-written ``dcim_mac``, ``csa_tree``
and ``ssm_scan`` kernels against their plain torch versions, the tile
autotuner's winners, and the compiler's device path against the CPU.

Every test here needs a card, carries the ``cuda`` marker and skips with a
reason where none is visible (the kernel has no CPU mode).  The module
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none for ``dcim_mac`` and ``csa_tree`` (int32, float32 and
bfloat16 outputs must equal the plain version's bits) and for the
compiler (its arrays must equal the CPU's bits).  ``ssm_scan`` is a float
scan: it must equal its chunked plain version bit for bit at every tile and
depth, and stay within the JAX package's rtol/atol of 2e-5 (3e-5 on ragged
shapes) of the sequential plain version.
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
from repro_torch.kernels.build import (library_path, ptxas_report,
                                      wgmma_serialized)
from repro_torch.kernels.csa_tree import (CSA_MAX_ROWS, CSA_REG_ROWS,
                                          csa_tree_ref, csa_tree_rows_cuda,
                                          csa_tree_sum, csa_tree_tiled_cuda)
from repro_torch.kernels.csa_tree.kernel import register_library
from repro_torch.kernels.dcim_mac import (dcim_matmul, dcim_matmul_int,
                                          mac_plan, mac_route, ref)
from repro_torch.kernels.dcim_mac import kernel as mac_kernel
from repro_torch.kernels.tiles import MAC_DEPTHS, smem_bytes
from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,
                                          ssm_scan_chunked_ref, ssm_scan_ref)
from repro_torch.obs.metrics import get_registry

pytestmark = pytest.mark.cuda

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
