"""RWKV6 "Finch" (attention-free, data-dependent decay) — arXiv:2404.05892
(the port of the JAX package's ``repro/models/rwkv6.py``).

Per block: Time-Mix (token-shift lerp, r/k/v/g projections, LoRA-produced
per-token decay w, WKV recurrence with bonus u) + Channel-Mix (token-shift,
squared-ReLU FFN gated by sigmoid(r)).  The WKV recurrence runs on the shared
chunked-GLA path (:mod:`repro_torch.models.ssm`); decode carries per-layer
``shift_t`` / ``shift_c`` (B, d) in the compute dtype and the ``wkv`` state
(B, H, dk, dk) in float32, stacked on the layer axis as in the reference,
and :meth:`RWKV6.decode_step` writes them in place.

:class:`RWKV6` is the JAX package's block, a simplification of Finch (static
lerps, a rank-64 clamped decay LoRA, RMS norms).  :class:`Finch` (family
``finch``) is the block as published, §4 of the paper: the data-dependent
token shift (*ddlerp*), the rank-128 decay LoRA, a GroupNorm per head on the
WKV output, LayerNorms with bias (``ln0`` on the embedding); both serve
through the same decode state.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import finch_lora_ranks
from ..device import resolve_device
from ..obs import tracer
from . import layers as L
from .ssm import chunked_gla, gla_decode_step

LORA_R = 64


def _shift(x: torch.Tensor, last: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Token shift: previous token's features ((B,T,D) -> shifted)."""
    if last is None:
        return nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] > 1:
        return torch.cat([last[:, None, :], x[:, :-1]], dim=1)
    return last[:, None, :]


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _channel_mix(blk, x, state=None):
    """Channel-Mix of ``blk`` (its ``mu_ck`` / ``mu_cr`` lerps and ``ck``,
    ``cv``, ``cr``): ``sigmoid(cr x_r) * cv(relu(ck x_k)^2)``; returns it
    and the layer's ``shift_c``."""
    cd = x.dtype
    last = state["shift_c"] if state is not None else None
    xs = _shift(x, last)
    xk = _lerp(x, xs, L.whole(blk.mu_ck)).to(cd)
    xr = _lerp(x, xs, L.whole(blk.mu_cr)).to(cd)
    kk = torch.square(torch.relu(blk.ck(xk, cd)))
    out = blk.cv(kk, cd)
    out = out * torch.sigmoid(blk.cr(xr, cd))
    return out, {"shift_c": x[:, -1, :]}


def _wkv_out(blk, x, r, k, v, log_w, g, state=None):
    """The Time-Mix's tail, shared by :class:`Block` and
    :class:`FinchBlock`: the WKV recurrence with the bonus ``blk.u``
    (exclusive; the ``rwkv.wkv`` span, chunked for a prefill, one
    ``gla_decode_step`` for decode), ``blk.ln_x``, the ``silu(g)`` gate and
    ``blk.wo``.  Returns the output and the layer's ``shift_t`` / ``wkv``."""
    cfg = blk.cfg
    b, t, d = x.shape
    h, dk = cfg.n_heads, cfg.hd
    u = L.whole(blk.u)
    rq, kq, vq, lw = (z.reshape(b, t, h, dk) for z in (r, k, v, log_w))
    with tracer.span("rwkv.wkv"):
        if state is None:
            y, s_fin = chunked_gla(rq, kq, vq, lw, u=u, inclusive=False,
                                   chunk=cfg.ssm.chunk, remat=cfg.remat)
        else:
            yv, s_fin = gla_decode_step(rq[:, 0], kq[:, 0], vq[:, 0],
                                        lw[:, 0], state["wkv"], u=u,
                                        inclusive=False)
            y = yv[:, None]
    new_state = {"shift_t": x[:, -1, :], "wkv": s_fin}
    y = blk.ln_x(y.reshape(b, t, d))
    y = y * (g * torch.sigmoid(g))
    return blk.wo(y, x.dtype), new_state


class Block(nn.Module):
    """One RWKV6 block's parameters (the reference's names and layouts)."""

    # the token-shift lerp weights (float32, 0.5 at init)
    MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr")

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, h, dk = cfg.d_model, cfg.n_heads, cfg.hd
        f32 = torch.float32
        self.cfg = cfg
        self.ln_t = L.RMSNorm(d, device)
        self.ln_c = L.RMSNorm(d, device)
        for name in self.MU:
            setattr(self, name, L._empty((d,), f32, device, ("act_embed",)))
        # time-mix
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, L.DcimLinear(d, d, cfg, dtype, device,
                                             ("embed", "heads")))
        self.wo = L.DcimLinear(d, d, cfg, dtype, device, ("heads", "embed"))
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        self.w0 = L._empty((d,), f32, device, ("act_embed",))
        self.wA = L._empty((d, LORA_R), dtype, device, ("embed", None))
        self.wB = L._empty((LORA_R, d), dtype, device, (None, "heads"))
        self.u = L._empty((h, dk), f32, device, ("act_heads", None))
        self.ln_x = L.RMSNorm(d, device)
        # channel-mix
        self.ck = L.DcimLinear(d, cfg.d_ff, cfg, dtype, device,
                               ("embed", "ff"))
        self.cv = L.DcimLinear(cfg.d_ff, d, cfg, dtype, device,
                               ("ff", "embed"))
        self.cr = L.DcimLinear(d, d, cfg, dtype, device, ("embed", "heads"),
                               out_ax="embed")

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for name in self.MU:
                getattr(self, name).fill_(0.5)
            self.w0.fill_(-1.0)
            self.u.fill_(0.5)
        L.init_param(self.wA, generator, scale=0.01)
        L.init_param(self.wB, generator, scale=0.01)

    def time_mix(self, x, state=None):
        """x: (B,T,d).  state: the layer's {'shift_t': (B,d), 'wkv':
        (B,H,dk,dv)} for decode."""
        cd = x.dtype
        last = state["shift_t"] if state is not None else None
        xs = _shift(x, last)
        w = L.whole
        r = self.wr(_lerp(x, xs, w(self.mu_r)).to(cd), cd)
        k = self.wk(_lerp(x, xs, w(self.mu_k)).to(cd), cd)
        v = self.wv(_lerp(x, xs, w(self.mu_v)).to(cd), cd)
        g = self.wg(_lerp(x, xs, w(self.mu_g)).to(cd), cd)
        xw = _lerp(x, xs, w(self.mu_w)).to(cd)
        lora = torch.matmul(torch.tanh(torch.matmul(xw, w(self.wA).to(cd))),
                            w(self.wB).to(cd))
        log_w = -torch.exp(torch.clamp(w(self.w0) + lora.to(torch.float32),
                                       -8.0, 4.0))
        return _wkv_out(self, x, r, k, v, log_w, g, state)

    def channel_mix(self, x, state=None):
        return _channel_mix(self, x, state)

    def forward(self, x, state=None):
        """Returns (x, state'): state' always carries the block's final
        recurrent state (shift_t, shift_c, wkv), so prefill hands exact
        state to decode."""
        h, st_t = self.time_mix(self.ln_t(x), state)
        x = x + h
        h2, st_c = self.channel_mix(self.ln_c(x), state)
        return x + h2, {**st_t, **st_c}


class RWKV6(L.ZooModel):
    """The model's parameters and its four functions (``forward_train``,
    ``init_decode_state``, ``prefill``, ``decode_step``), built with
    uninitialised parameters on ``device`` (``None``: the CUDA card)."""

    BLOCK = Block
    NORM = L.RMSNorm

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = L.dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_padded, cfg.d_model, dtype, dev)
        self.blocks = nn.ModuleList(self.BLOCK(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.ln_f = self.NORM(cfg.d_model, dev)
        self.unembed = L.Projection(cfg.d_model, cfg.vocab_padded, dtype, dev,
                                    ("embed", "vocab"))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens, self._cd)

    def forward_train(self, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {'tokens': (B,S)} -> (logits (B,S,vocab), aux 0).  Each
        block is rematerialised when training with ``cfg.remat``."""
        x = self._embed(batch["tokens"])
        for blk in self.blocks:
            x = L.remat(lambda h, blk=blk: blk(h)[0], x,
                        enabled=self.cfg.remat)
        return self._logits(self.ln_f(x)), self._no_aux()

    def init_decode_state(self, batch: int, cache_len: int = 0) -> dict:
        return init_decode_state(self.cfg, batch, cache_len, self.device)

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    frontend=None) -> tuple[torch.Tensor, dict]:
        """One token per row: tokens (B, 1) -> logits (B, 1, V); the state's
        tensors are updated in place, ``pos`` advanced."""
        x = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            x, ns = blk(x, {"shift_t": state["shift_t"][i],
                            "shift_c": state["shift_c"][i],
                            "wkv": state["wkv"][i]})
            for key in ("shift_t", "shift_c", "wkv"):
                state[key][i] = ns[key].to(state[key].dtype)
        logits = self._logits(self.ln_f(x))
        new_state = dict(state)
        new_state["pos"] = state["pos"] + tokens.shape[1]
        return logits, new_state

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int = 0,
                frontend=None) -> tuple[torch.Tensor, dict]:
        """The chunked-GLA forward; each block's token shifts and final WKV
        state hand off exactly into decode (``cache_len`` is unused: the
        state is O(1))."""
        x = self._embed(tokens)
        state = self.init_decode_state(tokens.shape[0])
        for i, blk in enumerate(self.blocks):
            x, st = blk(x)
            for key in ("shift_t", "shift_c", "wkv"):
                state[key][i] = st[key].to(state[key].dtype)
        logits = self._logits(self.ln_f(x))
        state["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                    device=x.device)
        return logits, state


# ---------------------------------------------------------------------------
# Finch as published (arXiv:2404.05892 §4)
# ---------------------------------------------------------------------------

# the WKV output's GroupNorm: LayerNorm's 1e-5 times head_size_divisor (8)
# squared, as RWKV-LM's ``RWKV_Tmix_x060`` sets it
FINCH_GN_EPS = 1e-5 * 8 ** 2


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, or over each of its ``groups`` equal
    slices (a GroupNorm per head), with a float32 gain ``g`` and bias ``b``
    (1 and 0 at init): one ``group_norm`` over the rows in float32 (one
    group: the LayerNorm), the result cast back to the input's dtype."""

    def __init__(self, d: int, device, eps: float = 1e-5, groups: int = 1):
        super().__init__()
        f32 = torch.float32
        self.eps, self.groups = eps, groups
        self.g = L._empty((d,), f32, device, ("act_embed",))
        self.b = L._empty((d,), f32, device, ("act_embed",))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.g.fill_(1.0)
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        y = nn.functional.group_norm(x.reshape(-1, d).float(), self.groups,
                                     L.whole(self.g), L.whole(self.b),
                                     self.eps)
        return y.reshape(x.shape).to(x.dtype)


class FinchBlock(nn.Module):
    """One Finch block (module doc).  With ``sx = x_{t-1} - x_t``, the
    ddlerp gives each of the targets w, k, v, r, g the input ``x + sx
    (maa_<target> + m_<target>)``, where ``m = tanh((x + sx maa_x)
    maa_w1) maa_w2`` per target (``maa_w1`` (d, 5 r), ``maa_w2`` (5, r,
    d)); the decay is ``log w = -exp(w0 + tanh(x_w decay_w1) decay_w2)``,
    unclamped; the WKV runs with the bonus ``u`` (exclusive); its output
    goes through ``ln_x``, a GroupNorm per head, gated by ``silu(W_g
    x_g)``.  The Channel-Mix is :class:`Block`'s.  The LoRAs are plain
    matmuls in the compute dtype; the eight projections are DCIM
    linears.  Spans: ``rwkv.time_mix`` over ``rwkv.wkv``, and
    ``rwkv.channel_mix``."""

    MIX = ("w", "k", "v", "r", "g")

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, h, dk = cfg.d_model, cfg.n_heads, cfg.hd
        r_mix, r_decay = finch_lora_ranks(d)
        f32 = torch.float32
        self.cfg = cfg
        self.ln1 = LayerNorm(d, device)
        self.ln2 = LayerNorm(d, device)
        for name in ("maa_x",) + tuple(f"maa_{m}" for m in self.MIX) \
                + ("mu_ck", "mu_cr"):
            setattr(self, name, L._empty((d,), f32, device, ("act_embed",)))
        self.maa_w1 = L._empty((d, 5 * r_mix), dtype, device, ("embed", None))
        self.maa_w2 = L._empty((5, r_mix, d), dtype, device,
                               (None, None, "embed"))
        self.w0 = L._empty((d,), f32, device, ("act_embed",))
        self.decay_w1 = L._empty((d, r_decay), dtype, device,
                                 ("embed", None))
        self.decay_w2 = L._empty((r_decay, d), dtype, device,
                                 (None, "heads"))
        self.u = L._empty((h, dk), f32, device, ("act_heads", None))
        for name in ("wr", "wk", "wv", "wg"):
            setattr(self, name, L.DcimLinear(d, d, cfg, dtype, device,
                                             ("embed", "heads")))
        self.wo = L.DcimLinear(d, d, cfg, dtype, device, ("heads", "embed"))
        self.ln_x = LayerNorm(d, device, eps=FINCH_GN_EPS, groups=h)
        self.ck = L.DcimLinear(d, cfg.d_ff, cfg, dtype, device,
                               ("embed", "ff"))
        self.cv = L.DcimLinear(cfg.d_ff, d, cfg, dtype, device,
                               ("ff", "embed"))
        self.cr = L.DcimLinear(d, d, cfg, dtype, device, ("embed", "heads"),
                               out_ax="embed")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The lerps at 0.5, ``w0`` on the published decay curve from -6
        to -1 over the channels, ``u`` 0.5, the LoRAs' A by the fan-in law
        and their B at scale 0.01."""
        d = self.w0.shape[0]
        with torch.no_grad():
            for name in ("maa_x",) + tuple(f"maa_{m}" for m in self.MIX) \
                    + ("mu_ck", "mu_cr"):
                getattr(self, name).fill_(0.5)
            n = torch.arange(d, dtype=torch.float32, device=self.w0.device)
            self.w0.copy_(-6.0 + 5.0 * (n / max(d - 1, 1)) ** 0.7)
            self.u.fill_(0.5)
        L.init_param(self.maa_w1, generator)
        L.init_param(self.maa_w2, generator, scale=0.01)
        L.init_param(self.decay_w1, generator)
        L.init_param(self.decay_w2, generator, scale=0.01)

    def time_mix(self, x, state=None):
        """x: (B,T,d) after ``ln1``.  state: the layer's {'shift_t': (B,d),
        'wkv': (B,H,dk,dv)} for decode (T = 1)."""
        with tracer.span("rwkv.time_mix"):
            b, t, d = x.shape
            cd = x.dtype
            w = L.whole
            sx = _shift(x, state["shift_t"] if state is not None else None) \
                - x
            xxx = (x + sx * w(self.maa_x)).to(cd)
            m = torch.tanh(torch.matmul(xxx, w(self.maa_w1).to(cd)))
            m = torch.bmm(m.reshape(b * t, 5, -1).transpose(0, 1),
                          w(self.maa_w2).to(cd)).reshape(5, b, t, d)
            xw, xk, xv, xr, xg = (
                (x + sx * (w(getattr(self, f"maa_{name}")) + m[i])).to(cd)
                for i, name in enumerate(self.MIX))
            r = self.wr(xr, cd)
            k = self.wk(xk, cd)
            v = self.wv(xv, cd)
            g = self.wg(xg, cd)
            lora = torch.matmul(
                torch.tanh(torch.matmul(xw, w(self.decay_w1).to(cd))),
                w(self.decay_w2).to(cd))
            log_w = -torch.exp(w(self.w0) + lora.to(torch.float32))
            return _wkv_out(self, x, r, k, v, log_w, g, state)

    def channel_mix(self, x, state=None):
        with tracer.span("rwkv.channel_mix"):
            return _channel_mix(self, x, state)

    def forward(self, x, state=None):
        """Returns (x, state') as :meth:`Block.forward` does."""
        h, st_t = self.time_mix(self.ln1(x), state)
        x = x + h
        h2, st_c = self.channel_mix(self.ln2(x), state)
        return x + h2, {**st_t, **st_c}


class Finch(RWKV6):
    """Finch as published (module doc): ``ln0`` on the embedding,
    :class:`FinchBlock` s and a LayerNorm ``ln_f`` before the untied head;
    the decode state, prefill and decode step are :class:`RWKV6`'s."""

    BLOCK = FinchBlock
    NORM = LayerNorm

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.ln0 = LayerNorm(cfg.d_model, self.device)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.ln0(super()._embed(tokens))


def init_decode_state(cfg, batch: int, cache_len: int = 0,
                      device=None) -> dict:
    """O(1) recurrent state, zeros, on ``device`` (``None``: the CUDA
    card) — ``cache_len`` is irrelevant (attention-free)."""
    dev = resolve_device(device)
    cd = L.dt(cfg.compute_dtype)
    lyr, d, h, dk = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd
    return {"shift_t": torch.zeros((lyr, batch, d), dtype=cd, device=dev),
            "shift_c": torch.zeros((lyr, batch, d), dtype=cd, device=dev),
            "wkv": torch.zeros((lyr, batch, h, dk, dk), dtype=torch.float32,
                               device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}
