"""ctypes binding of the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  The launch function checks
its operands, splits T into the chunks :func:`~.ref.ssm_chunks` fixes from
(T, D), allocates the outputs and the chunk summaries with ``torch.empty``
on the operands' device, launches on torch's current stream without
synchronising, and raises if a launch was refused.  Where it launches a
kernel it adds one to :data:`LAUNCHES` under the depth's route: two
kernels for a chunked call (S > 1), one for S = 1.  It takes CUDA tensors
only: the wrapper in :mod:`repro_torch.kernels.ssm_scan.ops` routes CPU
tensors to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import build_library
from ..tiles import TileConfig, feasible
from .ref import ssm_chunks

#: Kernel launches, by route: ``grid`` at depth 1, ``pipelined`` at depth
#: 2..4.  Added to where each kernel is launched: the summary launch of a
#: chunked call and the states launch each count one.
LAUNCHES = {"grid": 0, "pipelined": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/ssm_scan.cu`` (or a text derived
    from it) and declare its functions."""
    lib = ctypes.CDLL(str(path))
    lib.ssm_scan_summary.argtypes = [_P, _P, _P, *[_I] * 7, _P]
    lib.ssm_scan_states.argtypes = [_P, _P, _P, _P, _P, _P, *[_I] * 7, _P]
    for fn in (lib.ssm_scan_summary, lib.ssm_scan_states):
        fn.restype = _I
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("ssm_scan"))


def _check(err: int, which: str) -> None:
    if err != 0:
        msg = _lib().ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan {which} launch failed: CUDA error "
                           f"{err} ({msg})")


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                  bt: int = 32, bd: int = 128, depth: int = 2
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (T, D) float32 and h0 (D,) float32, contiguous on one CUDA
    device -> (states (T, D), final (D,)) on the card, by the chunked scan
    of ``ssm_scan_chunked_ref`` with ``ssm_chunks(T, D)`` chunks.
    ``depth`` 1 stages rows with plain loads (``ssm_scan_pallas``), 2..4
    through the cp.async ring (``ssm_scan_pipelined_pallas``); every tile
    and depth computes the same bits."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
    if a.dim() != 2 or b.shape != a.shape or h0.shape != a.shape[1:]:
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}: want (T, D), (T, D), (D,)")
    t_len, d = a.shape
    if max(t_len, d) >= 2 ** 31:
        raise ValueError("dimensions must fit in a 32-bit int")
    if not feasible("ssm_scan", TileConfig(bt=bt, bd=bd, depth=depth)):
        raise ValueError(f"ssm_scan cannot launch with bt={bt}, bd={bd}, "
                         f"depth={depth} (see repro_torch.kernels.tiles)")
    states = torch.empty_like(a)
    if t_len == 0 or d == 0:
        return states, h0.clone()
    final = torch.empty_like(h0)
    chunks, rows = ssm_chunks(t_len, d)
    summary = torch.empty(2 * (chunks - 1) * d, dtype=torch.float32,
                          device=a.device)
    route = "pipelined" if depth >= 2 else "grid"
    lib = _lib()
    split = (t_len, d, bt, bd, depth, chunks, rows)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if chunks > 1:
            _check(lib.ssm_scan_summary(a.data_ptr(), b.data_ptr(),
                                        summary.data_ptr(), *split, stream),
                   "summary")
            LAUNCHES[route] += 1
        _check(lib.ssm_scan_states(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                   summary.data_ptr(), states.data_ptr(),
                                   final.data_ptr(), *split, stream),
               "states")
        LAUNCHES[route] += 1
    return states, final
