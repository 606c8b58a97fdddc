"""Hand-written Hopper kernels of the port, each beside its plain torch
version.

  dcim_mac   the macro's int8 MAC array (paper Fig. 1): int8 x int8 ->
             int32, optionally with the fused per-row x per-column dequant
             epilogue.  CUDA C++ in ``csrc/dcim_mac.cu``.

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors; it never falls back from one to the other.
"""

from .dcim_mac import dcim_matmul, dcim_matmul_int
from .tiles import DEFAULT_TILES, TileConfig, resolve_tile

__all__ = ["dcim_matmul", "dcim_matmul_int", "DEFAULT_TILES", "TileConfig",
           "resolve_tile"]
