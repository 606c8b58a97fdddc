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
  fake_quant  the DCIM layers' symmetric per-slice fake-quant in one
            launch (rows or column slices, clusters over long columns);
            its route is ``quant.quantizers.fake_quant``.  CUDA C++ in
            ``csrc/fake_quant.cu``.
  moe_dispatch  the MoE layers' Switch/GShard slot assignment in one
            launch (dispatch, combine and the any-slot flags, written
            densely); its route is ``models.moe._top_k_dispatch``.  CUDA
            C++ in ``csrc/moe_dispatch.cu``.

The compiler's two device kernels are bindings only; their dispatchers live
beside their plain versions in :mod:`repro_torch.core`:

  lattice_rollup    the float64 PPA roll-up of a design lattice for a
                    stack of specs (``core.batched.eval_lattice``).  CUDA
                    C++ in ``csrc/lattice_rollup.cu``, built with
                    ``-fmad=false``.
  pareto_dominated  eps-band Pareto dominance verdicts, against every row
                    or block-local (``core.pareto.dominated``: the frontier
                    masks).  CUDA C++ in ``csrc/pareto_dominated.cu``.

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
from .fake_quant import fake_quant_cuda
from .instrument import dispatch_span
from .lattice_rollup import lattice_rollup_cuda
from .pareto_dominated import pareto_dominated_cuda
from .ssm_scan import ssm_scan, ssm_scan_assoc_ref, ssm_scan_cuda, ssm_scan_ref
from .tiles import (DEFAULT_TILES, TileConfig, resolve_tile, shape_class,
                    tile_space)

__all__ = [
    "CSA_MAX_ROWS", "csa_tree_ref", "csa_tree_rows_cuda", "csa_tree_sum",
    "csa_tree_tiled_cuda",
    "dcim_mac_cuda", "dcim_mac_int_cuda", "dcim_matmul", "dcim_matmul_int",
    "fake_quant_cuda",
    "ssm_scan", "ssm_scan_assoc_ref", "ssm_scan_cuda", "ssm_scan_ref",
    "DEFAULT_TILES", "TileConfig", "resolve_tile", "shape_class",
    "tile_space", "dispatch_span", "lattice_rollup_cuda",
    "pareto_dominated_cuda",
]
