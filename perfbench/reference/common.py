"""Plain float32 operations shared by the model references.

Nothing here imports the program: each function restates, in plain torch
on float32 tensors, one piece of the mathematics the configurations state
(RMS norm, the DCIM int8 fake-quant of a linear layer, rotary positions,
causal GQA attention, SwiGLU).  ``rnd`` is applied wherever the program
holds a value in its compute dtype: the identity for the reference, a
lower precision for the control (:func:`fp8`).
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at +-448) and back to float32."""
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).to(F32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(F32)


# the control's rounding: the precision next below a configuration's
# compute dtype
BELOW = {"float32": bf16, "bfloat16": fp8, "float16": fp8}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * g.to(F32)


def fake_quant(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Symmetric int quantize-dequantize with one scale per slice along
    ``dim`` reduced: ``clamp(round(x / s), -2^(b-1), 2^(b-1) - 1) * s``
    with ``s = max(amax, 1e-8) / (2^(b-1) - 1)``; rounding half to even."""
    qmax = (1 << (bits - 1)) - 1
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-8) / qmax
    return torch.clamp(torch.round(x / s), -qmax - 1, qmax) * s


def dcim_linear(x: torch.Tensor, w: torch.Tensor, rnd, bits: int = 8
                ) -> torch.Tensor:
    """``x @ w`` (``w`` is ``(d_in, d_out)``) with the weight fake-quantised
    per output column and the activation per token."""
    return rnd(fake_quant(x, bits, -1) @ fake_quant(w.to(F32), bits, 0))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..T-1 on ``x`` (N, T, H, D), the two halves of
    the head rotated as pairs."""
    t, d = x.shape[1], x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(t, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, rnd, rows: int = 32) -> torch.Tensor:
    """Softmax attention of every position over itself and the positions
    before it; q (N, T, Hq, D), k and v (N, T, Hkv, D), Hq a multiple of
    Hkv (GQA).  Computed ``rows`` sequences at a time."""
    n, t, hq, d = q.shape
    g = hq // k.shape[2]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    out = []
    for i in range(0, n, rows):
        qi = q[i:i + rows].transpose(1, 2)                   # (n, Hq, T, D)
        ki = k[i:i + rows].repeat_interleave(g, dim=2).transpose(1, 2)
        vi = v[i:i + rows].repeat_interleave(g, dim=2).transpose(1, 2)
        s = (qi @ ki.transpose(-1, -2)) / math.sqrt(d)
        p = rnd(torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1))
        out.append(rnd(p @ vi).transpose(1, 2))
    return torch.cat(out).reshape(n, t, hq * d)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_up, w_down, rnd) -> torch.Tensor:
    g = dcim_linear(x, w_gate, rnd)
    u = dcim_linear(x, w_up, rnd)
    return dcim_linear(rnd(silu(g) * u), w_down, rnd)


def attention_block(x, w: dict, pre: str, c: dict, rnd) -> torch.Tensor:
    """``x + wo(attention(rope(wq h), rope(wk h), wv h))`` with
    ``h = rmsnorm(x)``; the weights under the prefix ``pre``."""
    n, t, _ = x.shape
    hd, hq, hkv = c["head_dim"], c["n_heads"], c["n_kv_heads"]
    h = rnd(rmsnorm(x, w[pre + "ln_attn.g"]))
    q = dcim_linear(h, w[pre + "attn.wq.w"], rnd).reshape(n, t, hq, hd)
    k = dcim_linear(h, w[pre + "attn.wk.w"], rnd).reshape(n, t, hkv, hd)
    v = dcim_linear(h, w[pre + "attn.wv.w"], rnd).reshape(n, t, hkv, hd)
    q, k = rnd(rope(q, c["rope_theta"])), rnd(rope(k, c["rope_theta"]))
    o = causal_attention(q, k, v, rnd)
    return rnd(x + dcim_linear(o, w[pre + "attn.wo.w"], rnd))
