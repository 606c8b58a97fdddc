"""Public entry points for the DCIM MAC.

``dcim_matmul`` and ``dcim_matmul_int`` take int8 torch tensors and dispatch
on where they lie:

  * a CUDA tensor launches the hand-written Hopper kernel
    (:mod:`repro_torch.kernels.dcim_mac.kernel`), or raises;
  * a CPU tensor runs the plain torch version
    (:mod:`repro_torch.kernels.dcim_mac.ref`).

There is no fallback from the kernel to the plain version.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``, so a
run can show that its main path went through the kernel.

``tile_config`` is the JAX package's launch-posture argument.  Only ``None``
(the kernel's own blocks) is taken until the kernel-support slice re-derives
tile feasibility for Hopper; anything else raises.
"""

from __future__ import annotations

import torch

from . import ref
from .kernel import dcim_mac_cuda, dcim_mac_int_cuda


def _no_tiles(tile_config) -> None:
    if tile_config is not None:
        raise NotImplementedError(
            "tile_config is not taken yet: the Hopper kernel runs its own "
            "blocks until the kernel-support slice (ROADMAP.md queue 1, "
            "item 8)")


def dcim_matmul(a_q: torch.Tensor, w_q: torch.Tensor,
                a_scale: torch.Tensor | float = 1.0,
                w_scale: torch.Tensor | float = 1.0,
                *, out_dtype: torch.dtype = torch.float32,
                tile_config=None) -> torch.Tensor:
    """Quantized (M,K)x(K,N) matmul with fused dequant epilogue: per-row
    ``a_scale`` (M,) and per-column ``w_scale`` (N,), or scalars."""
    _no_tiles(tile_config)
    if not a_q.is_cuda:
        return ref.dcim_matmul_ref(a_q, w_q, a_scale, w_scale,
                                   out_dtype=out_dtype)
    m, n = a_q.shape[0], w_q.shape[1]
    asc = ref.scale_vector(a_scale, m, a_q.device).contiguous()
    wsc = ref.scale_vector(w_scale, n, a_q.device).contiguous()
    out = dcim_mac_cuda(a_q, w_q, asc, wsc, out_dtype)
    dcim_matmul.launches += 1
    return out


def dcim_matmul_int(a_q: torch.Tensor, w_q: torch.Tensor,
                    *, tile_config=None) -> torch.Tensor:
    """Integer-accumulator variant: returns int32 (M,N)."""
    _no_tiles(tile_config)
    if not a_q.is_cuda:
        return ref.dcim_matmul_int_ref(a_q, w_q)
    out = dcim_mac_int_cuda(a_q, w_q)
    dcim_matmul_int.launches += 1
    return out


dcim_matmul.launches = 0
dcim_matmul_int.launches = 0
