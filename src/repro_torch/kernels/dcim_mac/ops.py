"""Public entry points for the DCIM MAC.

``dcim_matmul`` and ``dcim_matmul_int`` take int8 torch tensors and dispatch
on where they lie:

  * a CUDA tensor launches the hand-written Hopper kernel
    (:mod:`repro_torch.kernels.dcim_mac.kernel`), or raises;
  * a CPU tensor runs the plain torch version
    (:mod:`repro_torch.kernels.dcim_mac.ref`).

There is no fallback from the kernel to the plain version.  Each wrapper's
``launches`` is its dict of kernel launches per route (:data:`~.kernel.
LAUNCHES`, added to where a kernel launches), so a run can show that its
main path went through the kernels.

The dispatch counter's route follows the JAX package's rule, by the
tile's depth: ``pipelined`` for a depth of 2 or more (every depth the port
compiles), ``grid`` for depth 1.  The kernel that runs follows from shape
and alignment (:func:`~.plan.mac_route`): the TMA / ``wgmma`` kernel with
its ``depth``-stage ring (tag ``kernel`` ``tma``), or the ``mma.sync``
kernel for operands TMA cannot describe (``mma_sync``); the span carries
it as its ``kernel`` tag, and ``launches`` counts it under its
:func:`~.plan.mac_route` name.
``tile_config`` is the JAX package's launch-posture argument, checked
against the Hopper tile space (:mod:`repro_torch.kernels.tiles`): None (the
TMA kernel's block at the default depth), that block at a depth it is
compiled for as an explicit :class:`~repro_torch.kernels.tiles.TileConfig`,
or ``"auto"`` for the autotuner's winner
(:func:`repro_torch.kernels.autotune.lookup`).  Any other block raises
ValueError.  Every call goes through
:func:`~repro_torch.kernels.instrument.dispatch_span` with its route; a
CPU tensor takes the same route and runs the plain version.
"""

from __future__ import annotations

import contextlib

import torch

from . import ref
from ..autotune import select_tile
from ..instrument import dispatch_span
from ..tiles import TileConfig
from .kernel import LAUNCHES, dcim_mac_cuda, dcim_mac_int_cuda
from .plan import mac_route


#: The ``kernel`` span tag of each :func:`~.plan.mac_route` result.
KERNEL_TAG = {"pipelined": "tma", "grid": "mma_sync"}


@contextlib.contextmanager
def _dispatch(a_q: torch.Tensor, w_q: torch.Tensor, tile_config):
    shape = (a_q.shape[0], a_q.shape[1], w_q.shape[1])
    tc, source = select_tile("dcim_mac", shape, tile_config, a_q.device)
    route = "pipelined" if tc.depth >= 2 else "grid"
    with dispatch_span("dcim_mac", shape, tc, source, route,
                       a_q.device) as span:
        if span:
            span.set_tag("kernel", KERNEL_TAG[mac_route(
                *shape, a_q.data_ptr(), w_q.data_ptr())])
        yield tc


def dcim_matmul(a_q: torch.Tensor, w_q: torch.Tensor,
                a_scale: torch.Tensor | float = 1.0,
                w_scale: torch.Tensor | float = 1.0,
                *, out_dtype: torch.dtype = torch.float32,
                tile_config: TileConfig | str | None = None) -> torch.Tensor:
    """Quantized (M,K)x(K,N) matmul with fused dequant epilogue: per-row
    ``a_scale`` (M,) and per-column ``w_scale`` (N,), or scalars."""
    with _dispatch(a_q, w_q, tile_config) as tc:
        if not a_q.is_cuda:
            return ref.dcim_matmul_ref(a_q, w_q, a_scale, w_scale,
                                       out_dtype=out_dtype)
        m, n = a_q.shape[0], w_q.shape[1]
        asc = ref.scale_vector(a_scale, m, a_q.device).contiguous()
        wsc = ref.scale_vector(w_scale, n, a_q.device).contiguous()
        return dcim_mac_cuda(a_q, w_q, asc, wsc, out_dtype, depth=tc.depth)


def dcim_matmul_int(a_q: torch.Tensor, w_q: torch.Tensor,
                    *, tile_config: TileConfig | str | None = None
                    ) -> torch.Tensor:
    """Integer-accumulator variant: returns int32 (M,N)."""
    with _dispatch(a_q, w_q, tile_config) as tc:
        if not a_q.is_cuda:
            return ref.dcim_matmul_int_ref(a_q, w_q)
        return dcim_mac_int_cuda(a_q, w_q, depth=tc.depth)


dcim_matmul.launches = LAUNCHES["dcim_mac"]
dcim_matmul_int.launches = LAUNCHES["dcim_mac_int"]
