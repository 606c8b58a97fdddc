"""ctypes binding of the CUDA MoE slot assignment (``csrc/moe_dispatch.cu``).

The source is compiled for ``sm_90a`` at first use (:mod:`repro_torch.
kernels.build`) and loaded once per process.  :func:`moe_dispatch_cuda`
takes a group's top-k choices ``(topv, topi)`` as ``models.moe._top_k``
returns them (strided views of the sorted gates are read in place),
allocates ``dispatch``, ``combine`` and ``held`` with ``torch.empty`` on
their device, launches one kernel on torch's current stream without
synchronising (the kernel writes every element), raises if the launch was
refused, and adds one to :data:`LAUNCHES`.  Its caller,
:func:`repro_torch.models.moe._top_k_dispatch`, sends CUDA gates here
(through ``models.moe._CardSlots``, which gives it a gradient) and CPU
gates to the plain version, :func:`~repro_torch.models.moe._slots_ref`,
whose bits it equals.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import build_library

#: Kernel launches.
LAUNCHES = {"dispatch": 0}

# The source's launch constants (csrc/moe_dispatch.cu).
THREADS, MAX_TILE, SMEM_LIMIT = 256, 32, 48 * 1024
#: The tile is halved down to MIN_TILE tokens while the grid has fewer
#: blocks than two per SM of the card.
MIN_TILE = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def smem_bytes(e: int, k: int, tile: int) -> int:
    """Shared memory of a block (the source's ``smem_bytes``): the
    group's counts by (slot, expert) twice, the tile's choices, and its
    (token, expert) slots and values."""
    return 4 * (2 * k * e + tile * k + 2 * tile * e)


def tile_tokens(g: int, s: int, e: int, k: int, sms: int) -> int:
    """Tokens a block takes: :data:`MAX_TILE`, halved down to
    :data:`MIN_TILE` while ``g`` groups of ``s`` tokens give fewer than
    two blocks per SM of a card of ``sms`` SMs, then while a block's
    shared memory exceeds :data:`SMEM_LIMIT`; at most ``s``.  Raises where even one token a
    block does not fit (``k`` x ``e`` beyond ~6,000)."""
    tile = MAX_TILE
    while tile > MIN_TILE and g * -(-s // tile) < 2 * sms:
        tile //= 2
    tile = max(1, min(tile, s))
    while tile > 1 and smem_bytes(e, k, tile) > SMEM_LIMIT:
        tile //= 2
    if smem_bytes(e, k, tile) > SMEM_LIMIT:
        raise ValueError(f"moe_dispatch on the card takes k x E up to "
                         f"~6,000 (48 KB of shared memory), got k {k}, "
                         f"E {e}")
    return tile


def bind(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/moe_dispatch.cu`` and declare its
    functions."""
    lib = ctypes.CDLL(str(path))
    lib.moe_dispatch.argtypes = [_P, _P, _L, _L, _L, _L, _I, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P]
    lib.moe_dispatch.restype = _I
    lib.moe_dispatch_error_string.argtypes = [_I]
    lib.moe_dispatch_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build_library("moe_dispatch"))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def moe_dispatch_cuda(topv: torch.Tensor, topi: torch.Tensor, n_experts: int,
                      capacity: int):
    """The slot assignment of ``(topv, topi)`` (G, S, k) float32 and int64
    on a CUDA device, a token's k experts distinct and in ``[0,
    n_experts)``, at ``capacity`` slots an expert: ``(dispatch (G, S, E, C)
    bool, combine (G, S, E, C) float32, held (G, S, E) float32)``, held
    being ``dispatch.any(-1)`` as float32."""
    if topv.dtype != torch.float32 or topi.dtype != torch.int64:
        raise TypeError(f"moe_dispatch on the card takes float32 values and "
                        f"int64 experts, got {topv.dtype} and {topi.dtype}")
    if not (topv.is_cuda and topi.device == topv.device):
        raise ValueError(f"topv and topi must be on one CUDA device, got "
                         f"{topv.device} and {topi.device}")
    if topv.dim() != 3 or topv.shape != topi.shape:
        raise ValueError(f"topv and topi must be (G, S, k) alike, got "
                         f"{tuple(topv.shape)} and {tuple(topi.shape)}")
    g, s, k = topv.shape
    e, c = n_experts, capacity
    if c < 1 or k > e:
        raise ValueError(f"capacity must be >= 1 and k <= E, got capacity "
                         f"{c}, k {k}, E {e}")
    dev = topv.device
    dispatch = torch.empty((g, s, e, c), dtype=torch.bool, device=dev)
    combine = torch.empty((g, s, e, c), dtype=torch.float32, device=dev)
    held = torch.empty((g, s, e), dtype=torch.float32, device=dev)
    tile = tile_tokens(g, s, e, k, _sms(dev.index))
    # the kernel reads rows of k with unit stride
    topv, topi = (x if x.stride(-1) == 1 else x.contiguous()
                  for x in (topv, topi))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.moe_dispatch(topv.data_ptr(), topi.data_ptr(),
                               topv.stride(0), topv.stride(1),
                               topi.stride(0), topi.stride(1), g, s, e, k, c,
                               tile, dispatch.data_ptr(), combine.data_ptr(),
                               held.data_ptr(), stream)
    if err != 0:
        msg = lib.moe_dispatch_error_string(err).decode()
        raise RuntimeError(f"moe_dispatch launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["dispatch"] += 1
    return dispatch, combine, held
