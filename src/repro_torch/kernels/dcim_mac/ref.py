"""Plain torch versions of the DCIM MAC kernel (the counterparts of the JAX
package's ``repro/kernels/dcim_mac/ref.py``).

Two references:

  * :func:`dcim_matmul_ref` / :func:`dcim_matmul_int_ref` — the
    mathematical contract: exact integer matmul plus the dequantization
    epilogue ``acc.float() * (a_scale[m] * w_scale[n])``.
  * :func:`dcim_matmul_bitserial_ref` — the *faithful DCIM semantics*:
    activations stream bit-serially (WL drivers), weights are bit-sliced
    across columns, every bit-plane product is reduced by the adder tree,
    partial sums shift-accumulate in the S&A, and weight-bit column results
    fuse in the OFU.  Two's-complement MSBs carry negative weight.

torch has no int32 matmul on CUDA, so the products are taken in float64 and
cast back to int32.  That is exact here: every int8 x int8 product is at
most 2**14 in magnitude and every partial sum an integer far below 2**53
for any K that fits in memory.

Scale contract: per-row ``a_scale`` (M,) and per-column ``w_scale`` (N,), or
Python scalars, as the Pallas kernels take them.
"""

from __future__ import annotations

import torch


def quant_range(bits: int) -> tuple[int, int]:
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def _exact_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer matmul through float64 (exact, see the module doc) -> int32."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.int32)


def scale_vector(scale, size: int, device: torch.device) -> torch.Tensor:
    """A scalar or a (size,) scale as a (size,) float32 tensor."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.dim() > 1 or (s.dim() == 1 and s.shape[0] not in (1, size)):
        raise ValueError(f"scale of shape {tuple(s.shape)} does not "
                         f"broadcast to ({size},)")
    return s.reshape(-1).expand(size)


def dcim_matmul_int_ref(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Integer-only oracle (no dequant): (M,K)i8 @ (K,N)i8 -> (M,N)i32."""
    return _exact_matmul(a_q, w_q)


def dcim_matmul_ref(a_q: torch.Tensor, w_q: torch.Tensor,
                    a_scale=1.0, w_scale=1.0,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact integer matmul + dequant: (M,K)i8 @ (K,N)i8 -> (M,N)out_dtype,
    scaled by ``a_scale[m] * w_scale[n]`` (the scale product first)."""
    m, n = a_q.shape[0], w_q.shape[1]
    asc = scale_vector(a_scale, m, a_q.device)
    wsc = scale_vector(w_scale, n, a_q.device)
    scale = asc[:, None] * wsc[None, :]
    acc = _exact_matmul(a_q, w_q)
    return (acc.to(torch.float32) * scale).to(out_dtype)


def _bit_planes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement bit planes: x == sum_b weight(b) * plane[b], with
    weight(b) = 2^b for b < bits-1 and -2^(bits-1) for the sign bit."""
    x_u = x.to(torch.int32) & ((1 << bits) - 1)    # two's complement view
    return torch.stack([(x_u >> b) & 1 for b in range(bits)], dim=0)


def _bit_weights(bits: int, device: torch.device) -> torch.Tensor:
    w = [1 << b for b in range(bits - 1)] + [-(1 << (bits - 1))]
    return torch.tensor(w, dtype=torch.float64, device=device)


def dcim_matmul_bitserial_ref(a_q: torch.Tensor, w_q: torch.Tensor,
                              a_bits: int = 8, w_bits: int = 8
                              ) -> torch.Tensor:
    """Faithful DCIM execution of the int matmul.

    Stage map (paper Fig. 1):
      WL bit-serial input  -> loop over activation bit planes ``ab``
      bit-sliced weights   -> loop over weight bit columns   ``wb``
      NOR multiplier       -> AND of bits == product of {0,1} planes
      adder tree           -> sum over K (the column reduction)
      S&A                  -> x2 shift-accumulate over activation bits
      OFU                  -> weighted fusion over weight bit columns

    Both reductions run in float64 (exact: see the module doc).
    """
    a_planes = _bit_planes(a_q, a_bits).to(torch.float64)   # (a_bits, M, K)
    w_planes = _bit_planes(w_q, w_bits).to(torch.float64)   # (w_bits, K, N)
    a_w = _bit_weights(a_bits, a_q.device)                  # signed weights
    w_w = _bit_weights(w_bits, a_q.device)

    # Adder tree: reduce over K for every (activation bit, weight bit) pair.
    partial = torch.einsum("amk,bkn->abmn", a_planes, w_planes)
    # S&A over activation bits, OFU over weight bits:
    fused = torch.einsum("a,b,abmn->mn", a_w, w_w, partial)
    return fused.to(torch.int32)
