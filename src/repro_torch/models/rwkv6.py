"""RWKV6 "Finch" (attention-free, data-dependent decay) — arXiv:2404.05892
(the port of the JAX package's ``repro/models/rwkv6.py``).

Per block: Time-Mix (token-shift lerp, r/k/v/g projections, LoRA-produced
per-token decay w, WKV recurrence with bonus u) + Channel-Mix (token-shift,
squared-ReLU FFN gated by sigmoid(r)).  The WKV recurrence runs on the shared
chunked-GLA path (:mod:`repro_torch.models.ssm`); decode carries per-layer
``shift_t`` / ``shift_c`` (B, d) in the compute dtype and the ``wkv`` state
(B, H, dk, dk) in float32, stacked on the layer axis as in the reference,
and :meth:`RWKV6.decode_step` writes them in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
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
            setattr(self, name, L._empty((d,), f32, device))
        # time-mix
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, L.DcimLinear(d, d, cfg, dtype, device))
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        self.w0 = L._empty((d,), f32, device)
        self.wA = L._empty((d, LORA_R), dtype, device)
        self.wB = L._empty((LORA_R, d), dtype, device)
        self.u = L._empty((h, dk), f32, device)
        self.ln_x = L.RMSNorm(d, device)
        # channel-mix
        self.ck = L.DcimLinear(d, cfg.d_ff, cfg, dtype, device)
        self.cv = L.DcimLinear(cfg.d_ff, d, cfg, dtype, device)
        self.cr = L.DcimLinear(d, d, cfg, dtype, device)

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
        cfg = self.cfg
        b, t, d = x.shape
        h, dk = cfg.n_heads, cfg.hd
        cd = x.dtype
        last = state["shift_t"] if state is not None else None
        xs = _shift(x, last)
        r = self.wr(_lerp(x, xs, self.mu_r).to(cd), cd)
        k = self.wk(_lerp(x, xs, self.mu_k).to(cd), cd)
        v = self.wv(_lerp(x, xs, self.mu_v).to(cd), cd)
        g = self.wg(_lerp(x, xs, self.mu_g).to(cd), cd)
        xw = _lerp(x, xs, self.mu_w).to(cd)
        lora = torch.matmul(torch.tanh(torch.matmul(xw, self.wA.to(cd))),
                            self.wB.to(cd))
        log_w = -torch.exp(torch.clamp(self.w0 + lora.to(torch.float32),
                                       -8.0, 4.0))

        rq = r.reshape(b, t, h, dk)
        kq = k.reshape(b, t, h, dk)
        vq = v.reshape(b, t, h, dk)
        lw = log_w.reshape(b, t, h, dk)
        if state is None:
            y, s_fin = chunked_gla(rq, kq, vq, lw, u=self.u, inclusive=False,
                                   chunk=cfg.ssm.chunk, remat=cfg.remat)
        else:
            yv, s_fin = gla_decode_step(rq[:, 0], kq[:, 0], vq[:, 0],
                                        lw[:, 0], state["wkv"], u=self.u,
                                        inclusive=False)
            y = yv[:, None]
        new_state = {"shift_t": x[:, -1, :], "wkv": s_fin}
        y = self.ln_x(y.reshape(b, t, d))
        y = y * (g * torch.sigmoid(g))
        return self.wo(y, cd), new_state

    def channel_mix(self, x, state=None):
        cd = x.dtype
        last = state["shift_c"] if state is not None else None
        xs = _shift(x, last)
        xk = _lerp(x, xs, self.mu_ck).to(cd)
        xr = _lerp(x, xs, self.mu_cr).to(cd)
        kk = torch.square(torch.relu(self.ck(xk, cd)))
        out = self.cv(kk, cd)
        out = out * torch.sigmoid(self.cr(xr, cd))
        return out, {"shift_c": x[:, -1, :]}

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

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = L.dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_padded, cfg.d_model, dtype, dev)
        self.blocks = nn.ModuleList(Block(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, dev)
        self.unembed = L.Projection(cfg.d_model, cfg.vocab_padded, dtype, dev)

    def forward_train(self, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {'tokens': (B,S)} -> (logits (B,S,vocab), aux 0).
        Forward only."""
        x = self.embed(batch["tokens"], self._cd)
        for blk in self.blocks:
            x, _ = blk(x)
        return self._logits(self.ln_f(x)), self._no_aux()

    def init_decode_state(self, batch: int, cache_len: int = 0) -> dict:
        return init_decode_state(self.cfg, batch, cache_len, self.device)

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    frontend=None) -> tuple[torch.Tensor, dict]:
        """One token per row: tokens (B, 1) -> logits (B, 1, V); the state's
        tensors are updated in place, ``pos`` advanced."""
        x = self.embed(tokens, self._cd)
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
        x = self.embed(tokens, self._cd)
        state = self.init_decode_state(tokens.shape[0])
        for i, blk in enumerate(self.blocks):
            x, st = blk(x)
            for key in ("shift_t", "shift_c", "wkv"):
                state[key][i] = st[key].to(state[key].dtype)
        logits = self._logits(self.ln_f(x))
        state["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                    device=x.device)
        return logits, state


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
