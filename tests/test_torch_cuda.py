"""The port on the CUDA card: the hand-written ``dcim_mac`` kernel against
its plain torch version, and the compiler's device path against the CPU.

Every test here needs a card, carries the ``cuda`` marker and skips with a
reason where none is visible (the kernel has no CPU mode).  The module
imports neither jax nor the JAX package, so it runs on a machine that has
only torch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: none.  Kernel outputs (int32, float32 and bfloat16) must equal
the plain version's bits; the compiler's arrays must equal the CPU's bits.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as C
from repro_torch.convert import mac_operands_from_numpy
from repro_torch.core import subcircuits as sc
from repro_torch.kernels.dcim_mac import dcim_matmul, dcim_matmul_int, ref

pytestmark = pytest.mark.cuda

# padded, one block, multi-block, ragged, a single row, and the qwen3-4b
# wk GEMM at seq 256
MAC_SHAPES = [(8, 16, 8), (128, 128, 128), (128, 256, 384), (130, 96, 200),
              (1, 512, 64), (256, 2560, 1024)]


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
    before = dcim_matmul_int.launches
    got = dcim_matmul_int(a, w)
    assert dcim_matmul_int.launches == before + 1
    assert torch.equal(got, ref.dcim_matmul_int_ref(a, w))


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
