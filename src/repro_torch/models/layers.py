"""Shared neural-net layers as ``nn.Module``s (the port of the JAX package's
``repro/models/layers.py``).

Every linear layer routes through the DCIM execution semantics
(:class:`DcimLinear`): weights and activations pass through straight-through
fake-quant at the macro's INT precision (QAT — what you train is what the
macro computes), and the product runs in the compute dtype.  As in the
reference, the product is ``torch.matmul`` of the fake-quantised operands,
not the ``dcim_mac`` kernel: the JAX layer calls ``jnp.matmul`` there too.

Attention is blockwise (FlashAttention-style online softmax in plain torch
ops) with the reference's query and key blocks and its merge order, so the
two agree block for block.

Parameters keep the reference's layouts (a linear weight is ``(d_in,
d_out)``) and are drawn by :func:`init_param`, the reference's
``parallel.logical.param`` law: normal in float32 times ``scale`` or
``fan_in ** -0.5``, cast to the parameter dtype.  The draws come from an
explicit ``torch.Generator``, so the numbers differ from ``jax.random``'s;
tests carry the reference's parameters across instead
(:func:`repro_torch.convert.model_params_from_numpy`).

Each parameter records the reference's logical axes where it is made
(:func:`repro_torch.parallel.logical.logical_axes`), and every weight is
read through :func:`repro_torch.parallel.zero.whole`: on a mesh of ranks a
sharded weight is gathered whole just before use, on one device it is the
parameter itself.  The reference's activation constraints
(:func:`~repro_torch.parallel.sharding.constrain_act`) sit at its call
sites.

Training rematerialises as the reference does (:func:`remat`, its
``jax.checkpoint``): each block, and each chunk of the chunked scan, keeps
only its inputs for the backward pass and runs again there.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint
from torch import nn

from ..obs import tracer
from ..parallel.sharding import constrain_act
from ..parallel.zero import whole
from ..quant import fake_quant

# weight out-axis -> activation logical axis (for constrain_act)
_ACT_OF = {"heads": "act_heads", "kv_heads": "act_heads", "ff": "act_ff",
           "embed": "act_embed", "vocab": "act_vocab"}

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


def init_param(t: torch.Tensor, generator: torch.Generator,
               scale: float | None = None) -> None:
    """Fill ``t`` in place by the reference's init law (module doc)."""
    shape = tuple(t.shape)
    fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
    s = scale if scale is not None else fan_in ** -0.5
    v = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=t.device) * s
    with torch.no_grad():
        t.copy_(v.to(t.dtype))


def remat(fn, *args, enabled: bool):
    """``fn(*args)``; with ``enabled`` and gradients on, its activations are
    dropped and recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  The
    recomputation runs the same ops on the same inputs, fake-quant
    included, so it gives the same bits."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _empty(shape, dtype, device, axes: tuple) -> nn.Parameter:
    """An uninitialised parameter recording its logical axes
    (:func:`repro_torch.parallel.logical.logical_axes`)."""
    assert len(shape) == len(axes), (shape, axes)
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    p.logical_axes = tuple(axes)
    return p


# ---------------------------------------------------------------------------
# DCIM linear
# ---------------------------------------------------------------------------


def dcim_linear_apply(w: torch.Tensor, x: torch.Tensor, *, a_bits: int = 8,
                      w_bits: int = 8, enabled: bool = True,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """y = x @ W under DCIM QAT semantics.

    Weights fake-quantized per-output-channel (columns live in macro
    columns), activations per-token (rows stream bit-serially) — gradients
    pass straight through.  ``enabled=False`` gives the plain (non-paper
    baseline) linear.  The weight's fake-quant runs inside every call, as
    the reference's does.
    """
    x = x.to(compute_dtype)
    w = w.to(compute_dtype)
    if enabled:
        w = fake_quant(w, w_bits, 0)      # per-out-channel (axis 0 reduced)
        x = fake_quant(x, a_bits, -1)     # per-token
    return torch.matmul(x, w)


class DcimLinear(nn.Module):
    """A ``(d_in, d_out)`` weight ``w`` with logical ``axes`` applied by
    :func:`dcim_linear_apply` with the config's DCIM precisions; a 3-D
    output is constrained to ``('batch', 'seq', <out_ax>)`` (``out_ax``
    defaults to the weight's output axis)."""

    def __init__(self, d_in: int, d_out: int, cfg, dtype: torch.dtype,
                 device, axes: tuple[str, str], out_ax: str | None = None):
        super().__init__()
        self.w = _empty((d_in, d_out), dtype, device, axes)
        self.out_ax = axes[1] if out_ax is None else out_ax
        self.a_bits, self.w_bits = cfg.dcim_a_bits, cfg.dcim_w_bits
        self.enabled = cfg.dcim_enabled

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_param(self.w, generator)

    def forward(self, x: torch.Tensor,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        y = dcim_linear_apply(
            whole(self.w), x, a_bits=self.a_bits, w_bits=self.w_bits,
            enabled=self.enabled,
            compute_dtype=x.dtype if compute_dtype is None else compute_dtype)
        if y.ndim == 3:
            y = constrain_act(y, ("batch", "seq",
                                  _ACT_OF.get(self.out_ax, self.out_ax)))
        return y


class Projection(nn.Module):
    """A plain ``(d_in, d_out)`` weight ``w`` (no fake-quant): the untied
    unembedding and the frontend projector."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device,
                 axes: tuple[str, str]):
        super().__init__()
        self.w = _empty((d_in, d_out), dtype, device, axes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_param(self.w, generator)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
        return torch.matmul(x.to(compute_dtype),
                            whole(self.w).to(compute_dtype))


# ---------------------------------------------------------------------------
# Norms / embeddings / rotary
# ---------------------------------------------------------------------------


def rmsnorm_apply(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * g).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm with a float32 gain ``g`` (ones at init); the math runs in
    float32 and the result is cast back to the input's dtype."""

    def __init__(self, d: int, device, axis: str = "act_embed"):
        super().__init__()
        self.g = _empty((d,), torch.float32, device, (axis,))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.g.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(whole(self.g), x)


class Embedding(nn.Module):
    """The ``(vocab, d)`` table ``emb``, drawn at scale ``d ** -0.5`` (keeps
    tied-embedding logits ~N(0,1) at init)."""

    def __init__(self, vocab: int, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.emb = _empty((vocab, d), dtype, device, ("vocab", "embed"))

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_param(self.emb, generator, scale=self.emb.shape[1] ** -0.5)

    def forward(self, tokens: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
        # the rows gathered, then cast: the same values as the reference's
        # cast-then-gather without casting the whole table
        out = whole(self.emb)[tokens].to(compute_dtype)
        return constrain_act(out, ("batch", "seq", "act_embed"))

    def unembed(self, x: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
        out = torch.matmul(x.to(compute_dtype),
                           whole(self.emb).to(compute_dtype).T)
        return constrain_act(out, ("batch", "seq", "act_vocab"))


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Neutralize the padding columns of a padded vocabulary with float32's
    ``min`` cast to the logits' dtype (``-inf`` in bfloat16)."""
    vp = logits.shape[-1]
    if vp == vocab:
        return logits
    mask = torch.arange(vp, device=logits.device) < vocab
    neg = torch.tensor(torch.finfo(torch.float32).min,
                       device=logits.device).to(logits.dtype)
    return torch.where(mask, logits, neg)


def _scalar(value: float, like: torch.Tensor,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """A Python number as a 0-d tensor of ``like``'s dtype (or ``dtype``)
    on its device: the reference's weak-typed scalar, rounded to the
    operand's dtype first; on CUDA it also keeps a division a true
    division (torch divides by a Python number as a product with its
    reciprocal there)."""
    return torch.tensor(value, dtype=dtype or like.dtype, device=like.device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      / _scalar(half, x, torch.float32))
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    ang = ang[..., None, :]                                   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (memory-efficient, causal-exact)
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D)."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d) \
        .reshape(b, s, h * groups, d)


def _attn_block(q, k, v, mask):
    """One (qb x kvb) tile: returns (m, l, acc) online-softmax stats.

    q: (B, H, qb, D); k, v: (B, H, kvb, D); mask: (qb, kvb).
    """
    s = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    s = torch.where(mask, s, torch.tensor(-1e30, device=s.device))
    m = torch.amax(s, dim=-1)                          # (B,H,qb)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.matmul(p.to(v.dtype), v)
    return m, l, acc


def _merge_stats(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    l = l1 * e1 + l2 * e2
    a = a1 * e1[..., None].to(a1.dtype) + a2 * e2[..., None].to(a2.dtype)
    return m, l, a


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_block: int, kv_block: int,
                        q_offset: int = 0) -> torch.Tensor:
    """FlashAttention-style attention in plain torch ops.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    Causal semantics: query position i (+q_offset) attends keys <= i+q_offset.
    Query blocks run with exact causal KV extents; KV blocks merge by online
    softmax in the reference's order.

    A KV block that would run past Skv is read from ``Skv - kv_block``, as
    the reference's ``lax.dynamic_slice_in_dim`` clamps its start, while
    its mask keeps the unclamped positions: with Skv not a multiple of the
    block, that block's keys and mask disagree in the reference, and the
    port reproduces it (ROADMAP.md, "Reference state").
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    qt = q.transpose(1, 2) * _scalar(1.0 / math.sqrt(d), q)   # (B,H,Sq,D)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)

    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    n_q = (sq + q_block - 1) // q_block
    dev = q.device
    outs = []
    for qi in range(n_q):
        q0 = qi * q_block
        qb = min(q_block, sq - q0)
        q_tile = qt[:, :, q0:q0 + qb]
        hi = min(skv, q0 + qb + q_offset) if causal else skv
        n_kv = (hi + kv_block - 1) // kv_block
        if n_kv <= 0:
            outs.append(torch.zeros_like(q_tile))
            continue
        m = torch.full((b, hq, qb), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hq, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hq, qb, d), dtype=qt.dtype, device=dev)
        for ki in range(n_kv):
            k0 = ki * kv_block
            start = min(k0, skv - kv_block)     # the reference's clamp
            k_tile = kt[:, :, start:start + kv_block]
            v_tile = vt[:, :, start:start + kv_block]
            kpos = k0 + torch.arange(kv_block, device=dev)
            valid = kpos < hi
            if causal:
                qpos = q0 + q_offset + torch.arange(qb, device=dev)
                mask = valid[None, :] & (kpos[None, :] <= qpos[:, None])
            else:
                mask = valid[None, :].expand(qb, kv_block)
            m, l, acc = _merge_stats(m, l, acc,
                                     *_attn_block(q_tile, k_tile, v_tile,
                                                  mask))
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype))
    out = torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]
    return out.transpose(1, 2)            # (B,Sq,Hq,D)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA attention: ``wq``, ``wk``, ``wv``, ``wo`` (DCIM linears) and,
    with ``cfg.qk_norm``, ``q_norm`` / ``k_norm`` over the head dim."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        self.cfg = cfg
        self.wq = DcimLinear(d, cfg.n_heads * hd, cfg, dtype, device,
                             ("embed", "heads"))
        self.wk = DcimLinear(d, cfg.n_kv_heads * hd, cfg, dtype, device,
                             ("embed", "kv_heads"))
        self.wv = DcimLinear(d, cfg.n_kv_heads * hd, cfg, dtype, device,
                             ("embed", "kv_heads"))
        self.wo = DcimLinear(cfg.n_heads * hd, d, cfg, dtype, device,
                             ("heads", "embed"))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor | None,
                causal: bool = True, kv_cache: dict | None = None,
                cache_pos: torch.Tensor | None = None,
                kv_override: tuple | None = None,
                prefill_fill: bool = False) -> torch.Tensor:
        """x: (B, S, d).

        Modes:
          * plain (kv_cache=None): blockwise attention over local K/V.
          * prefill (kv_cache + prefill_fill): blockwise attention, and the
            computed K/V written into the cache at position 0.
          * decode (kv_cache, prefill_fill=False): K/V written into the
            cache at ``cache_pos`` (a device scalar), attention over the
            cache (GQA-grouped einsum — no repeated-KV tensor).
        The caches (``kv_cache['k']`` / ``['v']``, (B, T, Hkv, D)) are
        written in place, where the reference returns updated copies (and
        donates the old buffers).  ``kv_override`` supplies external K/V
        (cross-attention).  The whole call is an ``attn`` span.
        """
        with tracer.span("attn"):
            cfg = self.cfg
            b, s, _ = x.shape
            hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
            g = hq // hkv
            q = self.wq(x).reshape(b, s, hq, hd)
            if kv_override is None:
                k = self.wk(x).reshape(b, s, hkv, hd)
                v = self.wv(x).reshape(b, s, hkv, hd)
            else:
                k, v = kv_override
            if cfg.qk_norm:
                q = self.q_norm(q)
                k = self.k_norm(k)
            if positions is not None:
                q = rope(q, positions, cfg.rope_theta)
                if kv_override is None:
                    k = rope(k, positions, cfg.rope_theta)

            if kv_cache is not None and prefill_fill:
                kv_cache["k"][:, :s] = k.to(kv_cache["k"].dtype)
                kv_cache["v"][:, :s] = v.to(kv_cache["v"].dtype)
                out = blockwise_attention(q, k, v, causal=causal,
                                          q_block=cfg.attn_q_block,
                                          kv_block=cfg.attn_kv_block)
            elif kv_cache is not None:
                ck, cv = kv_cache["k"], kv_cache["v"]
                t = ck.shape[1]
                steps = torch.arange(s, device=x.device)
                # the reference's dynamic_update_slice clamps the start
                idx = torch.clamp(cache_pos, max=t - s) + steps
                ck.index_copy_(1, idx, k.to(ck.dtype))
                cv.index_copy_(1, idx, v.to(cv.dtype))
                qg = q.reshape(b, s, hkv, g, hd) / _scalar(math.sqrt(hd), q)
                scores = torch.einsum("bskgd,btkd->bkgst", qg, ck.to(x.dtype))
                tpos = torch.arange(t, device=x.device)
                mask = tpos[None, :] <= (cache_pos + steps)[:, None]
                scores = torch.where(mask[None, None, None],
                                     scores.to(torch.float32),
                                     torch.tensor(-1e30, device=x.device))
                w = torch.softmax(scores, dim=-1).to(x.dtype)
                out = torch.einsum("bkgst,btkd->bskgd", w, cv.to(x.dtype))
                out = out.reshape(b, s, hq, hd)
            else:
                # K/V gathered across any sequence sharding once, before the
                # q-block loop
                k = constrain_act(k, ("batch", "attn_kv_seq", "act_heads",
                                   None))
                v = constrain_act(v, ("batch", "attn_kv_seq", "act_heads",
                                   None))
                out = blockwise_attention(q, k, v, causal=causal,
                                          q_block=cfg.attn_q_block,
                                          kv_block=cfg.attn_kv_block)
            return self.wo(out.reshape(b, s, hq * hd))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """SwiGLU: ``w_down(silu(w_gate x) * w_up x)``."""

    def __init__(self, cfg, dtype: torch.dtype, device,
                 d_ff: int | None = None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = DcimLinear(d, ff, cfg, dtype, device, ("embed", "ff"))
        self.w_up = DcimLinear(d, ff, cfg, dtype, device, ("embed", "ff"))
        self.w_down = DcimLinear(ff, d, cfg, dtype, device, ("ff", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.w_gate(x)
        u = self.w_up(x)
        return self.w_down(g * torch.sigmoid(g) * u)


# ---------------------------------------------------------------------------
# Model base
# ---------------------------------------------------------------------------


class ZooModel(nn.Module):
    """What every model of the zoo shares: its config, device, compute
    dtype, the parameter draw and the logits (the tied embedding, or an
    ``unembed`` :class:`Projection`).  A subclass sets ``cfg``, ``embed``,
    ``ln_f`` and ``unembed`` (``None`` when tied)."""

    @property
    def device(self) -> torch.device:
        return self.ln_f.g.device

    @property
    def _cd(self) -> torch.dtype:
        return dt(self.cfg.compute_dtype)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ZooModel":
        """Draw every parameter from ``generator`` (on the model's device),
        one tensor at a time in module order, each module's
        ``reset_parameters`` by the reference's law."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def _no_aux(self) -> torch.Tensor:
        """The load-balance loss ``forward_train`` returns beside the
        logits for a model without routed experts: 0."""
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cd = self._cd
        if self.unembed is None:
            out = self.embed.unembed(x, cd)
        else:
            out = constrain_act(self.unembed(x, cd),
                                ("batch", "seq", "act_vocab"))
        return mask_padded_vocab(out, self.cfg.vocab)
