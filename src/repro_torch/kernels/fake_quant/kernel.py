"""ctypes binding of the CUDA fake-quant (``csrc/fake_quant.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  :func:`fake_quant_cuda`
views its operand as ``(outer, R, inner)`` reduced over ``R``
(:func:`launch_plan`), allocates the result with ``torch.empty`` on the
operand's device, launches one kernel on torch's current stream without
synchronising, raises if the launch was refused, and adds one to
:data:`LAUNCHES` under its route.  It takes CUDA tensors in the dtypes of
:data:`DTYPES` at bits 1..8 and raises on anything else (bits 16's codes
do not fit in int8); an empty operand gives an empty result without a
launch.  The caller, :func:`repro_torch.quant.quantizers.fake_quant`,
sends every CUDA tensor here and CPU tensors to the plain version,
:func:`~repro_torch.quant.quantizers.quantize_int`, whose bits it equals.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ..build import build_library

#: Kernel launches, by route: ``rows`` (slices along the last axis) and
#: ``cols`` (slices along any other axis).
LAUNCHES = {"rows": 0, "cols": 0}

#: The dtypes the kernel takes, by the source's dtype code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: The most bits it takes: codes are int8.
MAX_BITS = 8

#: The plain version's floor under the scale (``quantize_int``'s ``eps``).
EPS = 1e-8

# The source's launch constants (csrc/fake_quant.cu).
ROW_KEEP, ROW_MAX_THREADS = 8, 512
COL_KEEP, COL_THREADS, MAX_CLUSTER = 8, 256, 8
GRID_Y = 65535
#: Blocks the cols route aims for at least: two per SM of an H100.
FILL_BLOCKS = 2 * 132

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@dataclass(frozen=True)
class Launch:
    """One launch's geometry.  ``rows``: ``outer`` rows of ``R`` elements
    ``ld`` apart, ``threads`` a block.  ``cols``: ``tiles`` column tiles of
    a contiguous ``(outer, R, inner)`` operand, each over a cluster of
    ``parts`` blocks taking ``rows_per`` rows; ``grid_y`` walks ``outer``.
    ``vec`` elements a load (16 bytes, or 1 where misaligned)."""

    route: str
    outer: int
    R: int
    inner: int
    vec: int
    ld: int = 0
    threads: int = 0
    tiles: int = 0
    parts: int = 0
    rows_per: int = 0
    grid_y: int = 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _collapsed_stride(shape, strides) -> int | None:
    """The one stride that walks the dims ``shape`` (with ``strides``) as
    a single dim, or None where they do not collapse (size-1 dims are
    skipped; no dim, or every dim of stride 0: 0)."""
    dims = [(n, st) for n, st in zip(shape, strides) if n != 1]
    for (_, st), (n, st_in) in zip(dims, dims[1:]):
        if st != st_in * n:
            return None
    return dims[-1][1] if dims else 0


@functools.lru_cache(maxsize=4096)
def _geometry(shape: tuple, strides: tuple, itemsize: int, axis: int,
              aligned: bool, contiguous: bool) -> Launch | None:
    """The launch for an operand of ``shape`` and ``strides`` reduced along
    ``axis`` (the operand's base ``aligned`` to 16 bytes; ``contiguous``
    its ``is_contiguous()``), or None where it must be made contiguous
    first."""
    outer = math.prod(shape[:axis])
    R, inner = shape[axis], math.prod(shape[axis + 1:])
    full = 16 // itemsize
    if inner == 1:
        if R > 1 and strides[axis] != 1:
            return None
        ld = _collapsed_stride(shape[:axis], strides[:axis])
        if ld is None:
            return None
        ld = ld if outer > 1 else R
        vec = full if aligned and R % full == 0 and ld % full == 0 else 1
        threads = min(ROW_MAX_THREADS,
                      32 * _ceil(_ceil(_ceil(R, vec), 4), 32))
        return Launch("rows", outer, R, 1, vec, ld=ld, threads=threads)
    if not contiguous:
        return None
    vec = full if aligned and inner % full == 0 else 1
    tx = 8 if vec > 1 else 32
    ty = COL_THREADS // tx
    tiles = _ceil(inner, tx * vec)
    grid_y = min(outer, GRID_Y)
    parts = max(_ceil(R, COL_KEEP * ty), _ceil(FILL_BLOCKS, tiles * grid_y))
    parts = max(1, min(MAX_CLUSTER, parts, _ceil(R, ty)))
    return Launch("cols", outer, R, inner, vec, tiles=tiles, parts=parts,
                  rows_per=_ceil(R, parts), grid_y=grid_y)


def launch_plan(x: torch.Tensor, axis: int | None
                ) -> tuple[torch.Tensor, Launch]:
    """(the operand as the kernel reads it, the launch) for ``x`` reduced
    along ``axis`` (None: the whole tensor, one slice).  A last-axis
    reduction whose rows are evenly strided with contiguous elements is
    read where it lies; any other layout is made contiguous first."""
    if axis is None or x.dim() == 0:
        x, axis = x.reshape(-1), 0
    else:
        axis = axis % x.dim()
    shape = tuple(x.shape)
    pl = _geometry(shape, x.stride(), x.element_size(), axis,
                   x.data_ptr() % 16 == 0, x.is_contiguous())
    if pl is None:
        x = x.contiguous()
        pl = _geometry(shape, x.stride(), x.element_size(), axis,
                       x.data_ptr() % 16 == 0, True)
    return x, pl


def bind(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/fake_quant.cu`` and declare its
    functions."""
    lib = ctypes.CDLL(str(path))
    lib.fake_quant_rows.argtypes = [_I, _P, _P, _P, _L, _L, _L, _I, _F, _F,
                                    _I, _P]
    lib.fake_quant_cols.argtypes = [_I, _P, _P, _P, _L, _L, _L, _I, _F, _F,
                                    _I, _I, _L, _I, _P]
    for fn in (lib.fake_quant_rows, lib.fake_quant_cols):
        fn.restype = _I
    lib.fake_quant_error_string.argtypes = [_I]
    lib.fake_quant_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("fake_quant"))


@functools.cache
def floor_value(dtype: torch.dtype) -> float:
    """:data:`EPS` as the plain version's floor tensor holds it in
    ``dtype`` (float16 rounds it to 0)."""
    return torch.tensor(EPS, dtype=dtype).item()


def fake_quant_cuda(x: torch.Tensor, bits: int, axis: int | None = -1, *,
                    codes: bool = False):
    """The symmetric per-slice fake-quant of ``x`` (bf16, f16 or f32 on a
    CUDA device) along ``axis`` to ``bits`` (1..8), as ``quantize_int``'s
    ``q.to(x.dtype) * s.to(x.dtype)``: a contiguous tensor of ``x``'s shape
    and dtype.  ``codes=True`` also returns the int8 codes ``q`` (for
    recorders that compare them)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"fake_quant on the card takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"fake_quant on the card takes bits 1..{MAX_BITS} "
                         f"(int8 codes), got {bits}")
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    q = (torch.empty(x.shape, dtype=torch.int8, device=x.device) if codes
         else None)
    if x.numel() == 0:
        return (out, q) if codes else out
    x2, pl = launch_plan(x, axis)
    lib = _lib()
    args = (DTYPES[x.dtype], x2.data_ptr(), out.data_ptr(),
            None if q is None else q.data_ptr())
    floor, qmax = floor_value(x.dtype), float((1 << (bits - 1)) - 1)
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pl.route == "rows":
            err = lib.fake_quant_rows(*args, pl.outer, pl.R, pl.ld, pl.vec,
                                      floor, qmax, pl.threads, stream)
        else:
            err = lib.fake_quant_cols(*args, pl.outer, pl.R, pl.inner,
                                      pl.vec, floor, qmax, pl.tiles,
                                      pl.parts, pl.rows_per, pl.grid_y,
                                      stream)
    if err != 0:
        msg = lib.fake_quant_error_string(err).decode()
        raise RuntimeError(f"fake_quant {pl.route} launch failed: CUDA "
                           f"error {err} ({msg})")
    LAUNCHES[pl.route] += 1
    return (out, q) if codes else out
