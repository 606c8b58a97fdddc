"""Plain versions of the chunked linear-recurrence (SSM) scan.

Recurrence (diagonal):  h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0
Returns every state h_0..h_{T-1} plus the final carry.

Two plain versions, as in the JAX package: a sequential loop (ground
truth; each step a multiply then an add, both rounded, which is what the
CUDA kernel computes) and an associative composition (A, B) o (A', B') =
(A'A, A'B + B') run as a log-depth doubling, since torch has no
``associative_scan``.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b: (T, D); h0: (D,) -> (states (T, D), final (D,))."""
    states = torch.empty_like(a)
    h = h0
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        states[t] = h
    return states, h.clone()


def ssm_scan_assoc_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract via the associative composition: Hillis-Steele
    doubling over [(1, h0), (a_0, b_0), ...], log2(T + 1) passes."""
    aa = torch.cat([torch.ones_like(h0)[None], a], dim=0)
    bb = torch.cat([h0[None], b], dim=0)
    span = 1
    while span < aa.shape[0]:
        # element t composes with element t - span: B_t += A_t * B_{t-span}
        bb = torch.cat([bb[:span], aa[span:] * bb[:-span] + bb[span:]], 0)
        aa = torch.cat([aa[:span], aa[span:] * aa[:-span]], 0)
        span *= 2
    states = bb[1:]
    return states, states[-1].clone() if len(states) else h0.clone()
