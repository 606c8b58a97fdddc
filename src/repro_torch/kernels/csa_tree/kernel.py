"""ctypes binding of the CUDA ``csa_tree`` kernels.

One kernel executes the adder-tree schedule on the card: the register
kernel, generated per row count R <= ``CSA_MAX_ROWS`` from
``build_schedule(R, use_compressors)`` (:mod:`.codegen`, template
``csrc/csa_tree_reg.cu.in``).  The rows route runs it with R = H on a whole
stack of at most ``CSA_MAX_ROWS`` rows, the tiled route with R = bh over H
tiles.

Each source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  Each launch function checks
its operands, allocates the output with ``torch.empty`` on the operands'
device, launches on torch's current stream without synchronising, and
raises if the build or the launch failed.  Where it launches a kernel it
adds one to :data:`LAUNCHES` under that launch's key (``rows``,
``rows_tall`` or ``tiled``); ``csa_tree_sum.launches`` is that dict.
They take CUDA tensors only: the wrapper in :mod:`repro_torch.kernels.
csa_tree.ops` routes CPU tensors to the plain versions.

``csa_tree_tiled_cuda``'s ``_mode="copy"`` (the JAX function's profiling
argument, :mod:`repro_torch.kernels.profile`) runs the copy skeleton that
every generated library also holds: the same tiles and loads, only row 0
of each tile added (``ref.csa_tree_copy_ref``); it is counted in
:data:`SKELETON_LAUNCHES`.  As in the JAX package there is no ``compute``
skeleton.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_source
from ..tiles import CSA_MAX_ROWS, CSA_REG_ROWS, TileConfig, feasible
from . import codegen

#: Kernel launches, by launch: ``rows`` the register kernel on a whole
#: stack of at most ``CSA_REG_ROWS`` rows, ``rows_tall`` on a whole stack
#: of ``CSA_REG_ROWS`` + 1 .. ``CSA_MAX_ROWS`` rows, ``tiled`` over H
#: tiles.  Added to where each kernel is launched.
LAUNCHES = {"rows": 0, "tiled": 0, "rows_tall": 0}

#: Launches of the tiled kernel's copy skeleton.
SKELETON_LAUNCHES = {"copy": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def register_library(rows: int, use_compressors: bool) -> Path:
    """Build (at first use) the register kernel for ``rows`` rows and
    return its library's path."""
    return build_source(codegen.library_name(rows, use_compressors),
                        codegen.source(rows, use_compressors))


@functools.cache
def _reg_lib(rows: int, use_compressors: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(register_library(rows, use_compressors)))
    for fn in (lib.csa_tree_reg, lib.csa_tree_reg_copy):
        fn.argtypes = [_P, _P, _I, _I, _I, _P]
        fn.restype = _I
    lib.csa_tree_reg_error_string.argtypes = [_I]
    lib.csa_tree_reg_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, name: str, error_string) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _check_operands(x: torch.Tensor) -> tuple[int, int]:
    if not x.is_cuda:
        raise ValueError(f"operands must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"operands must be int32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"operands must be 2-D (H, N), got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("operands must be contiguous (row-major)")
    h, n = x.shape
    if h < 1:
        raise ValueError("the adder tree needs at least one row")
    if max(h, n) >= 2 ** 31:
        raise ValueError("dimensions must fit in a 32-bit int")
    return h, n


def _check_block(bh: int, bn: int) -> None:
    if not feasible("csa_tree", TileConfig(bh=bh, bn=bn)):
        raise ValueError(f"csa_tree cannot launch blocks of {bh} rows x {bn} "
                         f"columns (see repro_torch.kernels.tiles)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rows_kernel(h: int) -> str:
    """The launch key of the rows route on an ``h``-row stack: ``rows`` up
    to ``CSA_REG_ROWS`` rows, ``rows_tall`` above (the same generated
    kernel, R = h)."""
    return "rows" if h <= CSA_REG_ROWS else "rows_tall"


def _launch_reg(operands: torch.Tensor, rows: int, use_compressors: bool,
                bn: int, key: str, copy: bool = False) -> torch.Tensor:
    h, n = operands.shape
    out = torch.empty((n,), dtype=torch.int32, device=operands.device)
    if n:
        lib = _reg_lib(rows, use_compressors)
        fn = lib.csa_tree_reg_copy if copy else lib.csa_tree_reg
        with torch.cuda.device(operands.device):
            _check(fn(operands.data_ptr(), out.data_ptr(), h, n, bn,
                      _stream(operands)),
                   f"csa_tree_reg{'_copy' if copy else ''} (R={rows})",
                   lib.csa_tree_reg_error_string)
        if copy:
            SKELETON_LAUNCHES["copy"] += 1
        else:
            LAUNCHES[key] += 1
    return out


def csa_tree_rows_cuda(operands: torch.Tensor, *, use_compressors: bool = True,
                       bn: int = 256) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card by the H-row
    schedule: the generated H-row register kernel in blocks of ``bn``
    columns, for H <= ``CSA_MAX_ROWS``.  Taller stacks go through
    :func:`csa_tree_tiled_cuda` (``csa_tree_sum`` routes there)."""
    if operands.shape[0] > CSA_MAX_ROWS:
        raise ValueError(
            f"csa_tree_rows_cuda runs the whole H-row schedule at once; "
            f"H={operands.shape[0]} exceeds the H<={CSA_MAX_ROWS} limit — "
            f"use csa_tree_tiled_cuda (csa_tree_sum routes automatically)")
    h, _ = _check_operands(operands)
    _check_block(min(h, CSA_REG_ROWS), bn)
    return _launch_reg(operands, h, use_compressors, bn, rows_kernel(h))


def csa_tree_tiled_cuda(operands: torch.Tensor, *,
                        use_compressors: bool = True, bh: int = 128,
                        bn: int = 256, _mode: str = "fused") -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card for any H: the
    generated bh-row register kernel over H tiles in sequence, the tile
    sums accumulated in 32 bits (rows past H read as 0).  ``_mode="copy"``
    runs the copy skeleton instead and returns its token, the sum of row 0
    of each tile (see the module doc)."""
    if _mode not in ("fused", "copy"):
        raise ValueError(f"csa_tree_tiled_cuda has the modes 'fused' and "
                         f"'copy' (no compute skeleton), got {_mode!r}")
    _check_operands(operands)
    _check_block(bh, bn)
    return _launch_reg(operands, bh, use_compressors, bn, "tiled",
                       copy=_mode == "copy")
