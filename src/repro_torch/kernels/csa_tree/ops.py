"""Entry point for the carry-save adder-tree reduction.

``csa_tree_sum`` takes an (H, N) int32 tensor and dispatches on where it
lies: a CUDA tensor launches the hand-written Hopper kernels
(:mod:`repro_torch.kernels.csa_tree.kernel`) or raises; a CPU tensor runs
the plain version.  It routes as the JAX package's ``csa_tree_sum`` does:
the whole-rows route for H <= ``CSA_MAX_ROWS``, the tiled-H route for
taller stacks or whenever a ``tile_config`` is given (``None``, a
:class:`~repro_torch.kernels.tiles.TileConfig`, or ``"auto"`` for the
autotuner's winner).  Every call goes through :func:`~repro_torch.kernels.
instrument.dispatch_span`, whose span also carries the kernel the route
runs (tag ``kernel``).  ``csa_tree_sum.launches`` is the count the launch
functions keep (:data:`~repro_torch.kernels.csa_tree.kernel.LAUNCHES`):
the launches of the generated register kernels: ``rows`` and
``rows_tall`` on the rows route (up to ``CSA_REG_ROWS`` rows, and above),
``tiled`` on the tiled route.
"""

from __future__ import annotations

import torch

from ..autotune import select_tile
from ..instrument import dispatch_span
from ..tiles import TileConfig
from .kernel import (CSA_MAX_ROWS, LAUNCHES, csa_tree_rows_cuda,
                     csa_tree_tiled_cuda, rows_kernel)
from .ref import csa_tree_ref


def csa_tree_sum(operands: torch.Tensor, *, use_compressors: bool = True,
                 tile_config: TileConfig | str | None = None) -> torch.Tensor:
    """(H, N) int32 -> (N,) int32 column sums via the Fig. 4 CSA structure,
    wrapping mod 2^32 (any tiling gives the same bits)."""
    shape = tuple(operands.shape)
    tc, source = select_tile("csa_tree", shape, tile_config,
                             operands.device)
    route = ("tiled" if shape[0] > CSA_MAX_ROWS or tile_config is not None
             else "rows")
    with dispatch_span("csa_tree", shape, tc, source, route,
                       operands.device) as span:
        if span:
            span.set_tag("kernel", route if route == "tiled"
                         else rows_kernel(shape[0]))
        if not operands.is_cuda:
            return csa_tree_ref(operands)
        if route == "tiled":
            return csa_tree_tiled_cuda(operands,
                                       use_compressors=use_compressors,
                                       bh=tc.bh, bn=tc.bn)
        return csa_tree_rows_cuda(operands, use_compressors=use_compressors,
                                  bn=tc.bn)


csa_tree_sum.launches = LAUNCHES
