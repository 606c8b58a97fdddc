"""Hand-written Hopper kernels of the port, each beside its plain torch
version.

  dcim_mac  the macro's int8 MAC array (paper Fig. 1): int8 x int8 ->
            int32, optionally with the fused per-row x per-column dequant
            epilogue.  CUDA C++ in ``csrc/dcim_mac.cu``.
  csa_tree  the Fig. 4 carry-save adder tree, executing the synthesized
            reduction schedule: straight-line register kernels generated
            per row count from ``csrc/csa_tree_reg.cu.in`` (whole rows up
            to 512, and tiled H).
  ssm_scan  the chunked diagonal linear recurrence (SSM decode primitive),
            a chunk-parallel scan with a plain-load and a ``cp.async``-ring
            variant.  CUDA C++ in ``csrc/ssm_scan.cu``.

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; it never falls back from one to the other.  ``tile_config``
(None, a :class:`TileConfig`, or ``"auto"``) picks the launch posture from
the Hopper tile space; :mod:`repro_torch.kernels.autotune` tunes it, and
every dispatch is counted and traced (:mod:`repro_torch.kernels.
instrument`).
"""

from .csa_tree import (CSA_MAX_ROWS, csa_tree_ref, csa_tree_rows_cuda,
                       csa_tree_sum, csa_tree_tiled_cuda)
from .dcim_mac import (dcim_mac_cuda, dcim_mac_int_cuda, dcim_matmul,
                       dcim_matmul_int)
from .instrument import dispatch_span
from .ssm_scan import ssm_scan, ssm_scan_assoc_ref, ssm_scan_cuda, ssm_scan_ref
from .tiles import (DEFAULT_TILES, TileConfig, resolve_tile, shape_class,
                    tile_space)

__all__ = [
    "CSA_MAX_ROWS", "csa_tree_ref", "csa_tree_rows_cuda", "csa_tree_sum",
    "csa_tree_tiled_cuda",
    "dcim_mac_cuda", "dcim_mac_int_cuda", "dcim_matmul", "dcim_matmul_int",
    "ssm_scan", "ssm_scan_assoc_ref", "ssm_scan_cuda", "ssm_scan_ref",
    "DEFAULT_TILES", "TileConfig", "resolve_tile", "shape_class",
    "tile_space", "dispatch_span",
]
