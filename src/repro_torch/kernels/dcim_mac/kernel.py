"""ctypes binding of the CUDA ``dcim_mac`` kernels (``csrc/dcim_mac.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  Each launch function checks
its operands, allocates the output with ``torch.empty`` on the operands'
device, launches on torch's current stream without synchronising, and raises
if the launch was refused.  They take CUDA tensors only: the wrappers in
:mod:`repro_torch.kernels.dcim_mac.ops` route CPU tensors to the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("dcim_mac")))
    lib.dcim_mac_int.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    lib.dcim_mac_int.restype = _I
    lib.dcim_mac.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.dcim_mac.restype = _I
    lib.dcim_mac_error_string.argtypes = [_I]
    lib.dcim_mac_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().dcim_mac_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _check_operands(a_q: torch.Tensor, w_q: torch.Tensor) -> tuple[int, int,
                                                                   int]:
    for name, t in (("a_q", a_q), ("w_q", w_q)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
    if a_q.device != w_q.device:
        raise ValueError(f"operands on {a_q.device} and {w_q.device}")
    m, k = a_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(a_q.shape)} @ "
                         f"{tuple(w_q.shape)}")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError("dimensions must fit in a 32-bit int")
    return m, k, n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dcim_mac_int_cuda(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> (M,N) int32 on the card."""
    m, k, n = _check_operands(a_q, w_q)
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    if m and n:
        with torch.cuda.device(a_q.device):
            _check(_lib().dcim_mac_int(a_q.data_ptr(), w_q.data_ptr(),
                                       out.data_ptr(), m, k, n,
                                       _stream(a_q)), "dcim_mac_int")
    return out


def dcim_mac_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                  a_scale: torch.Tensor, w_scale: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 with the dequant epilogue on the card:
    ``a_scale`` (M,) and ``w_scale`` (N,) contiguous float32 on the same
    device; ``out_dtype`` float32 or bfloat16."""
    m, k, n = _check_operands(a_q, w_q)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    for name, s, size in (("a_scale", a_scale, m), ("w_scale", w_scale, n)):
        if (s.device != a_q.device or s.dtype != torch.float32
                or tuple(s.shape) != (size,) or not s.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({size},) float32 "
                             f"tensor on {a_q.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=a_q.device)
    if m and n:
        with torch.cuda.device(a_q.device):
            _check(_lib().dcim_mac(a_q.data_ptr(), w_q.data_ptr(),
                                   a_scale.data_ptr(), w_scale.data_ptr(),
                                   out.data_ptr(), m, k, n,
                                   int(out_dtype == torch.bfloat16),
                                   _stream(a_q)), "dcim_mac")
    return out
