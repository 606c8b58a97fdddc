"""ctypes binding of the CUDA ``csa_tree`` kernels (``csrc/csa_tree.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  Each launch function checks
its operands, allocates the output with ``torch.empty`` on the operands'
device, uploads the schedule's op program once per (rows, compressors,
device), launches on torch's current stream without synchronising, and
raises if the launch was refused.  They take CUDA tensors only: the wrapper
in :mod:`repro_torch.kernels.csa_tree.ops` routes CPU tensors to the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library
from ..tiles import TileConfig, feasible
from .ref import build_schedule

#: Row budget of the whole-rows kernel: all H rows of a block's columns sit
#: in shared memory at once, 512 rows x 64 columns (the default block) x
#: 4 B = 128 KiB of the 227 KB a block may use, so the JAX package's bound
#: of 512 holds on the card too.
CSA_MAX_ROWS = 512

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("csa_tree")))
    lib.csa_tree_rows.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.csa_tree_rows.restype = _I
    lib.csa_tree_tiled.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.csa_tree_tiled.restype = _I
    lib.csa_tree_error_string.argtypes = [_I]
    lib.csa_tree_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _program(rows: int, use_compressors: bool, device: torch.device
             ) -> tuple[torch.Tensor, int, int]:
    """The ``rows``-row op program on ``device``: (ops, n_ops, result)."""
    sched = build_schedule(rows, use_compressors)
    ops = torch.as_tensor(sched.ops, dtype=torch.int32, device=device)
    return ops.contiguous(), len(sched.ops), sched.result


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().csa_tree_error_string(err).decode()
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


def csa_tree_rows_cuda(operands: torch.Tensor, *, use_compressors: bool = True,
                       bn: int = 64) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card, all H rows of a
    block of ``bn`` columns staged at once.  Requires H <= ``CSA_MAX_ROWS``;
    taller stacks go through :func:`csa_tree_tiled_cuda` (``csa_tree_sum``
    routes there)."""
    if operands.shape[0] > CSA_MAX_ROWS:
        raise ValueError(
            f"csa_tree_rows_cuda keeps all H rows of a block in shared "
            f"memory; H={operands.shape[0]} exceeds the H<={CSA_MAX_ROWS} "
            f"limit — use csa_tree_tiled_cuda (csa_tree_sum routes "
            f"automatically)")
    h, n = _check_operands(operands)
    _check_block(h, bn)
    ops, n_ops, result = _program(h, use_compressors, operands.device)
    out = torch.empty((n,), dtype=torch.int32, device=operands.device)
    if n:
        with torch.cuda.device(operands.device):
            _check(_lib().csa_tree_rows(operands.data_ptr(), out.data_ptr(),
                                        ops.data_ptr(), n_ops, result, h, n,
                                        bn, _stream(operands)),
                   "csa_tree_rows")
    return out


def csa_tree_tiled_cuda(operands: torch.Tensor, *,
                        use_compressors: bool = True, bh: int = 128,
                        bn: int = 64) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums on the card for any H: the
    bh-row schedule over H tiles in sequence, the tile sums accumulated in
    int32 (rows past H read as 0)."""
    h, n = _check_operands(operands)
    _check_block(bh, bn)
    ops, n_ops, result = _program(bh, use_compressors, operands.device)
    out = torch.empty((n,), dtype=torch.int32, device=operands.device)
    if n:
        with torch.cuda.device(operands.device):
            _check(_lib().csa_tree_tiled(operands.data_ptr(), out.data_ptr(),
                                         ops.data_ptr(), n_ops, result, bh, h,
                                         n, bn, _stream(operands)),
                   "csa_tree_tiled")
    return out
