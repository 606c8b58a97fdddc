"""Quantization substrate for DCIM execution semantics (the port of the JAX
package's ``repro/quant/quantizers.py``).

The synthesized macros execute INT1/2/4/8 natively and FP4/FP8/BF16 through
the FP&INT alignment unit (comparator tree finds the block-max exponent, then
mantissas shift into integer alignment — [9], paper §II-B).  This module makes
those semantics executable in torch:

  * ``quantize_int`` / ``dequantize``   — symmetric per-axis INT quantization
  * ``block_fp_align``                  — the alignment unit: block floating
    point (shared exponent + shifted integer mantissas), exactly the
    transform the hardware applies before the adder tree
  * ``fake_quant``                      — straight-through-estimator QAT node
    used by DCIM linear layers during training
  * ``fp8_e4m3_quant``                  — FP8 value grid (saturating)

Every step runs in the input's dtype, as the reference's weak-typed scalars
make it: under bfloat16 the scale ``max(amax, eps) / qmax`` is a bfloat16
value, and only then cast to float32.  The scalars are tensors on the
input's device: on CUDA, torch divides by a Python number as a product with
its reciprocal, which can miss the quotient by an ulp and flip a code.
``torch.round`` rounds half to even, as ``jnp.round`` does.

``fake_quant`` routes by the input's device: every CUDA tensor runs the
hand-written kernel (:mod:`repro_torch.kernels.fake_quant`, one launch,
the scalars passed as kernel arguments), bit for bit the plain version's
result, and any other tensor (the CPU's) runs the plain version
(``quantize_int``).  The kernel takes bfloat16, float16 and float32 at
``bits`` <= 8 and raises on anything else: ``bits`` 16, which no config
uses, gives codes that do not fit in int8 (``quantize_int``'s cast wraps
them, as the reference's does), so it runs on the CPU only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.fake_quant.kernel import fake_quant_cuda
from ..obs import tracer


@dataclass(frozen=True)
class QuantSpec:
    """Precision configuration of a DCIM-mapped layer (macro modes)."""

    a_bits: int = 8          # activation (bit-serial input) precision
    w_bits: int = 8          # weight (stored) precision
    mode: str = "int"        # 'int' | 'fp8' | 'bf16' (alignment-unit modes)

    def __post_init__(self):
        if self.a_bits not in (1, 2, 4, 8, 16):
            raise ValueError(f"a_bits must be 1, 2, 4, 8 or 16, got "
                             f"{self.a_bits}")
        if self.w_bits not in (1, 2, 4, 8, 16):
            raise ValueError(f"w_bits must be 1, 2, 4, 8 or 16, got "
                             f"{self.w_bits}")
        if self.mode not in ("int", "fp8", "bf16"):
            raise ValueError(f"mode must be 'int', 'fp8' or 'bf16', got "
                             f"{self.mode!r}")


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _amax(x: torch.Tensor, axis: int | None) -> torch.Tensor:
    if axis is None:
        return x.abs().amax()
    return x.abs().amax(dim=axis, keepdim=True)


def quantize_int(x: torch.Tensor, bits: int, axis: int | None = -1,
                 eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to signed ``bits`` integers.

    Returns (q int8, scale f32) with x ≈ q * scale.  ``axis=None`` gives a
    per-tensor scale; otherwise the scale is per-slice along ``axis``
    (per-channel for weights, per-row for activations).
    """
    qmax = _qmax(bits)
    floor = torch.tensor(eps, dtype=x.dtype, device=x.device)
    scale = torch.maximum(_amax(x, axis), floor) / torch.tensor(
        qmax, dtype=x.dtype, device=x.device)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _fake_quant_ref(x: torch.Tensor, bits: int, axis: int | None
                    ) -> torch.Tensor:
    """The plain version: ``quantize_int``, then dequantised in x's
    dtype."""
    q, s = quantize_int(x, bits, axis)
    return q.to(x.dtype) * s.to(x.dtype)


def _fake_quant_kernel(x: torch.Tensor, bits: int, axis: int | None
                       ) -> torch.Tensor:
    """The card's route (one launch); recorders of the codes patch it."""
    return fake_quant_cuda(x, bits, axis)


def _takes_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward (the kernel on the card, the plain
    version on the CPU), straight-through backward."""

    @staticmethod
    def forward(ctx, x, bits, axis):
        if _takes_kernel(x):
            return _fake_quant_kernel(x, bits, axis)
        return _fake_quant_ref(x, bits, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: int, axis: int | None = -1
               ) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT), in a
    ``fake_quant`` span tagged ``kernel`` (whether the kernel's route
    ran)."""
    with tracer.span("fake_quant") as span:
        if span:
            span.set_tag("kernel", _takes_kernel(x))
        return _FakeQuant.apply(x, bits, axis)


def block_fp_align(x: torch.Tensor, man_bits: int, block_axis: int = -1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The FP&INT alignment unit, executable.

    Per block (a slice along ``block_axis``): find the max exponent
    (comparator tree), shift every mantissa right so all values share that
    exponent (shifters), emit integer mantissas.  Returns
    (mantissas int32, shared_scale f32) with x ≈ mantissas * shared_scale.
    """
    bmax = x.abs().amax(dim=block_axis, keepdim=True)
    floor = torch.tensor(1e-30, dtype=x.dtype, device=x.device)
    # shared exponent: smallest e with max(|x|) < 2^e
    e = torch.ceil(torch.log2(torch.maximum(bmax, floor)))
    shared_scale = torch.exp2(e - man_bits)          # LSB weight after shift
    man = torch.clamp(torch.round(x / shared_scale),
                      -(1 << man_bits), (1 << man_bits) - 1)
    return man.to(torch.int32), shared_scale.to(torch.float32)


def fp8_e4m3_quant(x: torch.Tensor) -> torch.Tensor:
    """Round to the FP8 E4M3 grid (saturating at +-448) and back to f32."""
    y = torch.clamp(x.to(torch.float32), -448.0, 448.0)
    return y.to(torch.float8_e4m3fn).to(torch.float32)
