"""ctypes binding of the CUDA eps-band dominance kernel
(``csrc/pareto_dominated.cu``), rows A2 and A3 of the kernel table.

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  :func:`pareto_dominated_cuda`
checks its operands, allocates the verdicts with ``torch.empty`` on the
operands' device, launches one kernel on torch's current stream without
synchronising, raises if the launch was refused, and adds one to
:data:`LAUNCHES` under its mode.  It takes CUDA tensors only: the
dispatcher :func:`repro_torch.core.pareto.dominated` runs the plain version
for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library

#: Kernel launches, by mode: ``all`` tests each candidate against every row
#: (A2, A3's phase 2), ``seg`` against the rows of its own block (A3's
#: phase 1).  Added to where the kernel is launched.
LAUNCHES = {"all": 0, "seg": 0}

#: The largest objective count the kernel takes (``kMaxObjectives`` in the
#: source); more raise ``ValueError``.
MAX_OBJECTIVES = 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("pareto_dominated")))
    lib.pareto_dominated.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.pareto_dominated.restype = ctypes.c_int
    lib.pareto_dominated_max_objectives.restype = ctypes.c_int
    lib.pareto_dominated_error_string.argtypes = [ctypes.c_int]
    lib.pareto_dominated_error_string.restype = ctypes.c_char_p
    if lib.pareto_dominated_max_objectives() != MAX_OBJECTIVES:
        raise RuntimeError("pareto_dominated.cu and its binding disagree "
                           "on the largest objective count")
    return lib


def pareto_dominated_cuda(rows: torch.Tensor, cands: torch.Tensor,
                          eps: float, seg: int = 0) -> torch.Tensor:
    """rows (n, k) and cands (c, k) float64, contiguous on one CUDA device
    -> dominated (c,) bool on the card: entry i is True iff some row r has
    ``r[d] <= cands[i, d] + eps`` for every d and ``r[d] < cands[i, d] -
    eps`` for some d.  ``seg > 0`` tests candidate i only against rows
    ``[i // seg * seg, i // seg * seg + seg)`` and needs n == c."""
    for name, t in (("rows", rows), ("cands", cands)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be (count, k), got "
                             f"{tuple(t.shape)}")
    (n, k), c = rows.shape, cands.shape[0]
    if cands.shape[1] != k:
        raise ValueError(f"rows have {k} objectives, cands "
                         f"{cands.shape[1]}")
    if not 1 <= k <= MAX_OBJECTIVES:
        raise ValueError(f"the kernel takes 1 to {MAX_OBJECTIVES} "
                         f"objectives, got {k}")
    if seg < 0:
        raise ValueError(f"seg must be >= 0, got {seg}")
    if seg and n != c:
        raise ValueError(f"seg > 0 tests each candidate against its own "
                         f"block of rows: needs as many rows as "
                         f"candidates, got {n} and {c}")
    for name, t in (("rows", rows), ("cands", cands)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cands.device != rows.device:
        raise ValueError(f"cands on {cands.device}, rows on {rows.device}")
    out = torch.empty(c, dtype=torch.bool, device=cands.device)
    if c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        err = lib.pareto_dominated(rows.data_ptr(), n, cands.data_ptr(), c,
                                   k, float(eps), seg, out.data_ptr(),
                                   stream)
    if err != 0:
        msg = lib.pareto_dominated_error_string(err).decode()
        raise RuntimeError(f"pareto_dominated launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["seg" if seg else "all"] += 1
    return out
