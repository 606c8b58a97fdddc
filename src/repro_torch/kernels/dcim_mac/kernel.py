"""ctypes binding of the CUDA ``dcim_mac`` kernels (``csrc/dcim_mac.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  Each launch function checks
its operands, allocates the output with ``torch.empty`` on the operands'
device, picks the route by :func:`~.plan.mac_route` (the TMA / ``wgmma``
kernel, ``pipelined``, with the strips and K splits of
:func:`~.plan.mac_plan`; else the ``mma.sync`` kernel, ``grid``), launches
on torch's current stream without synchronising, and raises if the launch
was refused.  Where it launches a kernel it adds one to :data:`LAUNCHES`
under the function and the route.  They take CUDA tensors only: the
wrappers in :mod:`repro_torch.kernels.dcim_mac.ops` route CPU tensors to
the plain versions.

``dcim_mac_int_cuda``'s ``_mode`` (the JAX functions' profiling argument)
picks the TMA kernel's profiling skeletons, ``copy`` and ``compute``
(:mod:`repro_torch.kernels.profile`): built at first use from the same
source as a library of their own (:func:`~repro_torch.kernels.build.
build_library`, variant ``skeletons``), launched at any M on operands TMA
can describe, and counted in :data:`SKELETON_LAUNCHES`.  Their outputs are
data tokens, not products (``ref.dcim_mac_copy_ref``,
``ref.dcim_mac_compute_ref``).
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

from ..build import SKELETONS, build_library
from ..tiles import DEFAULT_TILES, MAC_DEPTHS
from .plan import mac_plan, mac_route, tma_describable

#: Kernel launches per function (``dcim_mac_int``: the int32 product;
#: ``dcim_mac``: with the dequant epilogue) and route (``pipelined``: the
#: TMA kernel; ``grid``: the ``mma.sync`` kernel).
LAUNCHES = {"dcim_mac_int": {"pipelined": 0, "grid": 0},
            "dcim_mac": {"pipelined": 0, "grid": 0}}

#: Launches of the TMA kernel's profiling skeletons, by mode.
SKELETON_LAUNCHES = {"copy": 0, "compute": 0}

#: The profiling modes of ``_mode`` and the C functions' mode numbers.
MODES = ("fused", "copy", "compute")
_SKELETON_MODE = {"copy": 1, "compute": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int

# the C functions' output kinds
_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/dcim_mac.cu`` (or a text derived
    from it) and declare its functions."""
    lib = ctypes.CDLL(str(path))
    lib.dcim_mac_tma.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.dcim_mac_grid.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.dcim_mac_tma_smem_bytes.argtypes = [_I]
    lib.dcim_mac_tma_max_clusters.argtypes = [_I, _I,
                                              ctypes.POINTER(_I)]
    for fn in (lib.dcim_mac_tma, lib.dcim_mac_grid,
               lib.dcim_mac_tma_smem_bytes, lib.dcim_mac_tma_max_clusters):
        fn.restype = _I
    lib.dcim_mac_error_string.argtypes = [_I]
    lib.dcim_mac_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("dcim_mac"))


@functools.cache
def _skeleton_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("dcim_mac", SKELETONS)))
    lib.dcim_mac_tma_skeleton.argtypes = [_P] * 3 + [_I] * 6 + [_P]
    lib.dcim_mac_tma_skeleton.restype = _I
    lib.dcim_mac_error_string.argtypes = [_I]
    lib.dcim_mac_error_string.restype = ctypes.c_char_p
    return lib


_TMA_KERNEL = re.compile(r"dcim_mac_tma_kernelILi(\d+)ELi(\d+)ELi(\d+)EE")


def tma_kernel_mode(symbol: str) -> str | None:
    """The mode (``fused``, ``copy``, ``compute``) of the TMA kernel a
    mangled symbol of a ptxas report names, or None for another kernel.
    The fused kernel and the compute skeleton need the 168 registers at
    entry that their ``setmaxnreg`` budget assumes; the copy skeleton has
    no ``setmaxnreg``."""
    m = _TMA_KERNEL.search(symbol)
    return MODES[int(m[3])] if m else None


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


def _launch(name: str, a_q: torch.Tensor, w_q: torch.Tensor,
            a_scale: torch.Tensor | None, w_scale: torch.Tensor | None,
            out: torch.Tensor, depth: int) -> None:
    """Launch the route's kernel for ``out = a_q @ w_q`` (with the
    epilogue when scales are given) and count it."""
    (m, k), n = a_q.shape, w_q.shape[1]
    if not (m and n):
        return
    if depth not in MAC_DEPTHS:
        raise ValueError(f"depth must be one of {MAC_DEPTHS}, got {depth}")
    route = mac_route(m, k, n, a_q.data_ptr(), w_q.data_ptr())
    ptrs = (a_q.data_ptr(), w_q.data_ptr(),
            a_scale.data_ptr() if a_scale is not None else None,
            w_scale.data_ptr() if w_scale is not None else None,
            out.data_ptr())
    with torch.cuda.device(a_q.device):
        if route == "pipelined":
            err = _lib().dcim_mac_tma(*ptrs, m, k, n, _KIND[out.dtype],
                                      depth, mac_plan(m, k, n).splits,
                                      _stream(a_q))
        else:
            err = _lib().dcim_mac_grid(*ptrs, m, k, n, _KIND[out.dtype],
                                       _stream(a_q))
    _check(err, name)
    LAUNCHES[name][route] += 1


def _launch_skeleton(mode: str, a_q: torch.Tensor, w_q: torch.Tensor,
                     out: torch.Tensor, depth: int) -> None:
    """Launch the TMA kernel's ``mode`` skeleton into ``out`` and count
    it."""
    (m, k), n = a_q.shape, w_q.shape[1]
    if not tma_describable(k, n, a_q.data_ptr(), w_q.data_ptr()):
        raise ValueError(
            f"the {mode} skeleton runs the TMA kernel, which needs K and N "
            f"multiples of 16 and 16-byte aligned operands; got "
            f"{m}x{k}x{n}")
    if depth not in MAC_DEPTHS:
        raise ValueError(f"depth must be one of {MAC_DEPTHS}, got {depth}")
    if not (m and n):
        return
    lib = _skeleton_lib()
    with torch.cuda.device(a_q.device):
        err = lib.dcim_mac_tma_skeleton(
            a_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), m, k, n,
            _SKELETON_MODE[mode], depth, mac_plan(m, k, n).splits,
            _stream(a_q))
    if err != 0:
        msg = lib.dcim_mac_error_string(err).decode()
        raise RuntimeError(f"dcim_mac_tma {mode} skeleton launch failed: "
                           f"CUDA error {err} ({msg})")
    SKELETON_LAUNCHES[mode] += 1


def dcim_mac_int_cuda(a_q: torch.Tensor, w_q: torch.Tensor, *,
                      depth: int = DEFAULT_TILES["dcim_mac"].depth,
                      _mode: str = "fused") -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> (M,N) int32 on the card; ``depth`` is
    the TMA route's ring depth.  ``_mode`` ``copy`` or ``compute`` runs
    the TMA kernel's profiling skeleton instead, at any M, and returns its
    data token (see the module doc)."""
    if _mode not in MODES:
        raise ValueError(f"_mode must be one of {MODES}, got {_mode!r}")
    m, k, n = _check_operands(a_q, w_q)
    out = torch.empty((m, n), dtype=torch.int32, device=a_q.device)
    if _mode == "fused":
        _launch("dcim_mac_int", a_q, w_q, None, None, out, depth)
    else:
        _launch_skeleton(_mode, a_q, w_q, out, depth)
    return out


def dcim_mac_cuda(a_q: torch.Tensor, w_q: torch.Tensor,
                  a_scale: torch.Tensor, w_scale: torch.Tensor,
                  out_dtype: torch.dtype, *,
                  depth: int = DEFAULT_TILES["dcim_mac"].depth
                  ) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 with the dequant epilogue on the card:
    ``a_scale`` (M,) and ``w_scale`` (N,) contiguous float32 on the same
    device; ``out_dtype`` float32 or bfloat16; ``depth`` the TMA route's
    ring depth."""
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
    _launch("dcim_mac", a_q, w_q, a_scale, w_scale, out, depth)
    return out


def tma_smem_bytes(depth: int) -> int:
    """Dynamic shared memory of one TMA block at ``depth``, by the
    kernel's own count."""
    return _lib().dcim_mac_tma_smem_bytes(depth)


def tma_max_clusters(depth: int, splits: int) -> int:
    """Clusters of ``splits`` TMA blocks at ``depth`` the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    count = _I(0)
    _check(_lib().dcim_mac_tma_max_clusters(depth, splits,
                                            ctypes.byref(count)),
           "dcim_mac_tma_max_clusters")
    return count.value
