"""ctypes binding of the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  The launch function checks
its operands, allocates the outputs with ``torch.empty`` on the operands'
device, launches on torch's current stream without synchronising, and
raises if the launch was refused.  It takes CUDA tensors only: the wrapper
in :mod:`repro_torch.kernels.ssm_scan.ops` routes CPU tensors to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library
from ..tiles import TileConfig, feasible

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("ssm_scan")))
    lib.ssm_scan.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.ssm_scan.restype = _I
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
                  bt: int = 32, bd: int = 128, depth: int = 2
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (T, D) float32 and h0 (D,) float32, contiguous on one CUDA
    device -> (states (T, D), final (D,)) on the card.  ``depth`` 1 is the
    plain-load kernel (``ssm_scan_pallas``), 2..4 the cp.async ring
    (``ssm_scan_pipelined_pallas``); all compute the same bits."""
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
    with torch.cuda.device(a.device):
        err = _lib().ssm_scan(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                              states.data_ptr(), final.data_ptr(), t_len, d,
                              bt, bd, depth,
                              torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        msg = _lib().ssm_scan_error_string(err).decode()
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {err} "
                           f"({msg})")
    return states, final
