"""ctypes binding of the CUDA ``csa_tree`` kernels.

Two kernels execute the adder-tree schedule on the card:

- the register kernel, generated per row count R <= ``CSA_REG_ROWS`` from
  ``build_schedule(R, use_compressors)`` (:mod:`.codegen`, template
  ``csrc/csa_tree_reg.cu.in``): the rows route for H <= ``CSA_REG_ROWS``
  (R = H) and the tiled route (R = bh, H in tiles);
- the shared-memory interpreter of ``csrc/csa_tree.cu``: the rows route for
  ``CSA_REG_ROWS`` < H <= ``CSA_MAX_ROWS``, whose lanes do not fit in
  registers.

Each source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  Each launch function checks
its operands, allocates the output with ``torch.empty`` on the operands'
device, launches on torch's current stream without synchronising, and
raises if the build or the launch failed.  Where it launches a kernel it
adds one to :data:`LAUNCHES` under that kernel's key (``rows``,
``rows_interp`` or ``tiled``); ``csa_tree_sum.launches`` is that dict.
They take CUDA tensors only: the wrapper in :mod:`repro_torch.kernels.
csa_tree.ops` routes CPU tensors to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_library, build_source
from ..tiles import CSA_REG_ROWS, TileConfig, feasible
from . import codegen
from .ref import build_schedule

#: Row budget of the whole-rows route, the JAX package's bound.  Above
#: ``CSA_REG_ROWS`` rows the interpreter stages all H rows of its block's
#: columns in shared memory: 512 rows x ``INTERP_THREADS`` columns x 4 B =
#: 128 KiB of the 227 KB a block may use.
CSA_MAX_ROWS = 512

#: Columns (threads) of an interpreter block, whatever ``bn`` the caller
#: gives: its shared memory grows with H x bn.
INTERP_THREADS = 64

#: Kernel launches, by kernel: ``rows`` the register kernel on a whole
#: stack, ``tiled`` the register kernel over H tiles, ``rows_interp`` the
#: shared-memory interpreter.  Added to where each kernel is launched.
LAUNCHES = {"rows": 0, "tiled": 0, "rows_interp": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _interp_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("csa_tree")))
    lib.csa_tree_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.csa_tree_rows.restype = _I
    lib.csa_tree_error_string.argtypes = [_I]
    lib.csa_tree_error_string.restype = ctypes.c_char_p
    return lib


def register_library(rows: int, use_compressors: bool) -> Path:
    """Build (at first use) the register kernel for ``rows`` rows and
    return its library's path."""
    return build_source(codegen.library_name(rows, use_compressors),
                        codegen.source(rows, use_compressors))


@functools.cache
def _reg_lib(rows: int, use_compressors: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(register_library(rows, use_compressors)))
    lib.csa_tree_reg.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.csa_tree_reg.restype = _I
    lib.csa_tree_reg_error_string.argtypes = [_I]
    lib.csa_tree_reg_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _program(rows: int, use_compressors: bool, device: torch.device
             ) -> tuple[torch.Tensor, int, int]:
    """The interpreter's ``rows``-row op program on ``device``: (ops,
    n_ops, result)."""
    sched = build_schedule(rows, use_compressors)
    ops = torch.as_tensor(sched.ops, dtype=torch.int32, device=device)
    return ops.contiguous(), len(sched.ops), sched.result


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
    """The kernel the rows route launches on an ``h``-row stack: ``rows``
    (the generated register kernel) up to ``CSA_REG_ROWS`` rows,
    ``rows_interp`` (the shared-memory interpreter) above."""
    return "rows" if h <= CSA_REG_ROWS else "rows_interp"


def _launch_reg(operands: torch.Tensor, rows: int, use_compressors: bool,
                bn: int, key: str) -> torch.Tensor:
    h, n = operands.shape
    out = torch.empty((n,), dtype=torch.int32, device=operands.device)
    if n:
        lib = _reg_lib(rows, use_compressors)
        with torch.cuda.device(operands.device):
            _check(lib.csa_tree_reg(operands.data_ptr(), out.data_ptr(), h, n,
                                    bn, _stream(operands)),
                   f"csa_tree_reg (R={rows})", lib.csa_tree_reg_error_string)
        LAUNCHES[key] += 1
    return out


def csa_tree_rows_cuda(operands: torch.Tensor, *, use_compressors: bool = True,
                       bn: int = 256) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card by the H-row
    schedule: the generated H-row register kernel in blocks of ``bn``
    columns for H <= ``CSA_REG_ROWS``, the shared-memory interpreter (blocks
    of ``INTERP_THREADS`` columns) up to ``CSA_MAX_ROWS``.  Taller stacks go
    through :func:`csa_tree_tiled_cuda` (``csa_tree_sum`` routes there)."""
    if operands.shape[0] > CSA_MAX_ROWS:
        raise ValueError(
            f"csa_tree_rows_cuda runs the whole H-row schedule at once; "
            f"H={operands.shape[0]} exceeds the H<={CSA_MAX_ROWS} limit — "
            f"use csa_tree_tiled_cuda (csa_tree_sum routes automatically)")
    h, n = _check_operands(operands)
    _check_block(min(h, CSA_REG_ROWS), bn)
    if rows_kernel(h) == "rows":
        return _launch_reg(operands, h, use_compressors, bn, "rows")
    ops, n_ops, result = _program(h, use_compressors, operands.device)
    out = torch.empty((n,), dtype=torch.int32, device=operands.device)
    if n:
        lib = _interp_lib()
        with torch.cuda.device(operands.device):
            _check(lib.csa_tree_rows(operands.data_ptr(), out.data_ptr(),
                                     ops.data_ptr(), n_ops, result, h, n,
                                     INTERP_THREADS, _stream(operands)),
                   "csa_tree_rows", lib.csa_tree_error_string)
        LAUNCHES["rows_interp"] += 1
    return out


def csa_tree_tiled_cuda(operands: torch.Tensor, *,
                        use_compressors: bool = True, bh: int = 128,
                        bn: int = 256) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card for any H: the
    generated bh-row register kernel over H tiles in sequence, the tile
    sums accumulated in 32 bits (rows past H read as 0)."""
    _check_operands(operands)
    _check_block(bh, bn)
    return _launch_reg(operands, bh, use_compressors, bn, "tiled")
