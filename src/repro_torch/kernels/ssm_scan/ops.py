"""Entry point for the SSM linear-recurrence scan.

``ssm_scan`` takes float32 torch tensors and dispatches on where they lie:
a CUDA tensor launches the hand-written Hopper kernel
(:mod:`repro_torch.kernels.ssm_scan.kernel`) or raises; a CPU tensor runs
the sequential plain version.  ``tile_config`` as in the JAX package's
``ssm_scan``: None is the default depth-2 pipeline, a
:class:`~repro_torch.kernels.tiles.TileConfig` with ``depth == 1`` the
plain-load ``grid`` kernel and ``>= 2`` the ``pipelined`` one, ``"auto"``
the autotuner's winner for this shape class.  Every call goes through
:func:`~repro_torch.kernels.instrument.dispatch_span`.
``ssm_scan.launches`` is the count the launch function keeps
(:data:`~repro_torch.kernels.ssm_scan.kernel.LAUNCHES`): every kernel
launched, per route, two for a chunked call and one for S = 1.
"""

from __future__ import annotations

import torch

from ..autotune import select_tile
from ..instrument import dispatch_span
from ..tiles import TileConfig
from .kernel import LAUNCHES, ssm_scan_cuda
from .ref import ssm_scan_ref


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
             tile_config: TileConfig | str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t.

    a, b: (T, D); h0: (D,).  Returns (states (T, D), final (D,))."""
    shape = tuple(a.shape)
    tc, source = select_tile("ssm_scan", shape, tile_config, a.device)
    route = "pipelined" if tc.depth >= 2 else "grid"
    with dispatch_span("ssm_scan", shape, tc, source, route, a.device):
        if not a.is_cuda:
            return ssm_scan_ref(a, b, h0)
        return ssm_scan_cuda(a, b, h0, bt=tc.bt, bd=tc.bd, depth=tc.depth)


ssm_scan.launches = LAUNCHES
