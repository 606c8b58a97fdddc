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

The TMA kernel's profiling skeletons (``_mode``, :mod:`repro_torch.kernels.
profile`) compute data tokens, not products; :func:`dcim_mac_copy_ref` and
:func:`dcim_mac_compute_ref` define them.  The JAX package's skeletons
cannot stand in here: on its copy skeleton the token is one slot's first
element, and its compute skeleton reads buffers that nothing filled (in
interpret mode it returned 4,194,304 everywhere), so the port defines
both tokens itself.
"""

from __future__ import annotations

import torch

from .plan import BK, BM, BN, mac_plan


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


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 as int32 two's complement."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _first_words(x: torch.Tensor, width: int) -> torch.Tensor:
    """(R, C) int8 -> (R, ceil(C / width)) int64: the little-endian 32-bit
    word of the first four bytes of each ``width``-byte block of a row,
    bytes past C read as 0 (as TMA fills them)."""
    r, c = x.shape
    blocks = -(-c // width)
    u = torch.zeros((r, blocks * width), dtype=torch.int64, device=x.device)
    u[:, :c] = x.to(torch.int64) & 0xFF
    b = u.view(r, blocks, width)[:, :, :4]
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def dcim_mac_copy_ref(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The copy skeleton's token, (M, N) int32: every output of the BM x BN
    strip (i, j) holds, mod 2^32, the sum over the K stages t of the first
    A word and the first W word of stage t, the little-endian words of
    bytes A[BM i, BK t .. BK t + 3] and W[BK t, BN j .. BN j + 3].  The
    K split does not change it: the cluster's reduction sums the splits'
    stages."""
    (m, k), n = a_q.shape, w_q.shape[1]
    a_sum = _first_words(a_q[::BM], BK).sum(1)            # (M strips,)
    w_sum = _first_words(w_q[::BK], BN).sum(0)            # (N strips,)
    token = _wrap32(a_sum[:, None] + w_sum[None, :])
    return token.repeat_interleave(BM, 0)[:m].repeat_interleave(BN, 1)[:, :n]


def dcim_mac_compute_ref(a_q: torch.Tensor, w_q: torch.Tensor
                         ) -> torch.Tensor:
    """The compute skeleton's token, (M, N) int32: with ``mac_plan(M, K,
    N)`` as the kernel uses it, the sum over its K splits z of n_z times
    the product of split z's first stage, A[:, k_z:k_z + BK] @ W[k_z:k_z +
    BK, :] (n_z the split's stages, k_z its first K), mod 2^32."""
    (m, k), n = a_q.shape, w_q.shape[1]
    plan = mac_plan(m, k, n)
    acc = torch.zeros((m, n), dtype=torch.int64, device=a_q.device)
    for (begin, end), (k0, _) in zip(plan.stage_ranges, plan.k_ranges):
        k1 = min(k0 + BK, k)
        acc += (end - begin) * _exact_matmul(a_q[:, k0:k1],
                                             w_q[k0:k1]).to(torch.int64)
    return _wrap32(acc)
