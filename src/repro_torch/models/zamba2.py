"""Mamba2 (SSD) blocks + Zamba2 hybrid (shared attention block every N Mamba
blocks, weights shared across invocations) — arXiv:2411.15242 (the port of
the JAX package's ``repro/models/zamba2.py``).

Mamba2 block: in_proj -> (z, x, B, C, dt); depthwise causal conv on (x,B,C);
SSD recurrence with scalar per-head decay a_t = exp(-softplus(dt + bias) *
exp(A_log)) executed on the shared chunked-GLA path (inclusive diagonal);
gated rmsnorm + out_proj.

Decode state, stacked on the layer axis as in the reference: per Mamba
layer the conv cache (B, K-1, conv_dim) in the compute dtype and the SSD
state (B, H, N, P) in float32; per invocation of the shared attention block
its own KV cache (B, cache_len, n_kv_heads, hd).  One set of the shared
block's weights serves every invocation.  :meth:`Zamba2.decode_step` writes
the state in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L
from .ssm import causal_conv1d, chunked_gla, gla_decode_step
from .transformer import Block as AttnBlock


class MambaBlock(nn.Module):
    """One Mamba2 block's parameters (the reference's names and layouts)."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim                  # ssd heads
        self.cfg = cfg
        self.ln = L.RMSNorm(d, device)
        self.in_proj = L.DcimLinear(d, 2 * di + 2 * s.state + nh, cfg, dtype,
                                    device)
        f32 = torch.float32
        self.conv_w = L._empty((s.conv_kernel, di + 2 * s.state), f32, device)
        self.A_log = L._empty((nh,), f32, device)
        self.dt_bias = L._empty((nh,), f32, device)
        self.D = L._empty((nh,), f32, device)
        self.ln_y = L.RMSNorm(di, device)
        self.out_proj = L.DcimLinear(di, d, cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.conv_w.zero_()
            self.conv_w[-1] = 1.0
            self.A_log.zero_()
            self.dt_bias.fill_(-2.0)
            self.D.fill_(1.0)

    def forward(self, xin, state=None):
        """xin: (B, T, d).  state: the layer's {'conv': (B,K-1,conv_dim),
        'ssd': (B,H,N,P)}.  Returns (xin + out, {'conv', 'ssd'})."""
        s = self.cfg.ssm
        cd = xin.dtype
        b, t, d = xin.shape
        di = s.expand * d
        nh = di // s.head_dim
        proj = self.in_proj(self.ln(xin), cd)
        z, xbc, dtp = torch.split(proj, [di, di + 2 * s.state, nh], dim=-1)

        conv_cache = state["conv"] if state is not None else None
        xbc, new_conv = causal_conv1d(xbc * torch.sigmoid(xbc), self.conv_w,
                                      conv_cache)
        xs, B, C = torch.split(xbc, [di, s.state, s.state], dim=-1)

        # SSD parameters: scalar decay per head, B/C shared across heads
        # (ngroups=1)
        x = dtp.to(torch.float32) + self.dt_bias
        dt = torch.logaddexp(x, torch.zeros_like(x))           # softplus
        decay = -torch.exp(self.A_log)[None, None, :] * dt     # log a_t <= 0

        v = xs.reshape(b, t, nh, s.head_dim)                   # values
        k = B[:, :, None, :].expand(b, t, nh, s.state)
        q = C[:, :, None, :].expand(b, t, nh, s.state)
        # dt scales the input (ZOH discretization of B x_t):
        v_in = (v.to(torch.float32) * dt[..., None]).to(cd)
        log_w = decay[..., None].expand(b, t, nh, s.state)

        if state is None or t > 1:
            # train / prefill: chunked scan (optionally continuing a state)
            s0 = state["ssd"] if state is not None else None
            y, ssd_fin = chunked_gla(q, k, v_in, log_w, inclusive=True,
                                     chunk=s.chunk, s0=s0,
                                     remat=self.cfg.remat)
        else:
            yv, ssd_fin = gla_decode_step(q[:, 0], k[:, 0], v_in[:, 0],
                                          log_w[:, 0], state["ssd"],
                                          inclusive=True)
            y = yv[:, None]
        y = y + v.to(y.dtype) * self.D[None, None, :, None]  # skip (D term)
        y = y.reshape(b, t, di)
        y = self.ln_y(y * (z * torch.sigmoid(z)))
        out = self.out_proj(y, cd)
        return xin + out, {"conv": new_conv, "ssd": ssd_fin}


def _segments(cfg) -> list[int]:
    """Mamba-layer counts between shared-attention invocations."""
    k = cfg.attn_every or cfg.n_layers
    full, rem = divmod(cfg.n_layers, k)
    return [k] * full + ([rem] if rem else [])


class Zamba2(L.ZooModel):
    """The model's parameters and its four functions (``forward_train``,
    ``init_decode_state``, ``prefill``, ``decode_step``), built with
    uninitialised parameters on ``device`` (``None``: the CUDA card)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = L.dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_padded, cfg.d_model, dtype, dev)
        self.mamba = nn.ModuleList(MambaBlock(cfg, dtype, dev)
                                   for _ in range(cfg.n_layers))
        self.shared_attn = AttnBlock(cfg, dtype, dev)     # ONE shared block
        self.ln_f = L.RMSNorm(cfg.d_model, dev)
        self.unembed = L.Projection(cfg.d_model, cfg.vocab_padded, dtype, dev)

    def forward_train(self, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {'tokens': (B,S)} -> (logits (B,S,vocab), aux 0).
        Forward only."""
        x = self.embed(batch["tokens"], self._cd)
        b, t, _ = x.shape
        pos = torch.arange(t, device=x.device).expand(b, t)
        lo = 0
        for seg in _segments(self.cfg):
            for blk in self.mamba[lo:lo + seg]:
                x, _ = blk(x)
            lo += seg
            # shared attention block after every segment (weights shared)
            x = self.shared_attn(x, positions=pos)
        return self._logits(self.ln_f(x)), self._no_aux()

    def init_decode_state(self, batch: int, cache_len: int) -> dict:
        return init_decode_state(self.cfg, batch, cache_len, self.device)

    def _run_stack(self, x, state, *, prefill_mode: bool):
        """Shared serve path: Mamba segments with their states, then the
        shared attention block with the segment's KV cache; the state is
        written in place, ``pos`` advanced by T."""
        b, t, _ = x.shape
        pos0 = state["pos"]
        positions = (pos0 + torch.arange(t, device=x.device)).expand(b, t)
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        lo = 0
        for i, seg in enumerate(_segments(self.cfg)):
            for li in range(lo, lo + seg):
                x, ns = self.mamba[li](x, {"conv": state["conv"][li],
                                           "ssd": state["ssd"][li]})
                state["conv"][li] = ns["conv"].to(state["conv"].dtype)
                state["ssd"][li] = ns["ssd"]
            lo += seg
            x = self.shared_attn(
                x, positions=positions,
                kv_cache={"k": state["k"][i], "v": state["v"][i]},
                cache_pos=zero if prefill_mode else pos0,
                prefill_fill=prefill_mode)
        new_state = dict(state)
        new_state["pos"] = pos0 + t
        return x, new_state

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    frontend=None) -> tuple[torch.Tensor, dict]:
        x = self.embed(tokens, self._cd)
        x, new_state = self._run_stack(x, state, prefill_mode=False)
        return self._logits(self.ln_f(x)), new_state

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int,
                frontend=None) -> tuple[torch.Tensor, dict]:
        x = self.embed(tokens, self._cd)
        state = self.init_decode_state(tokens.shape[0], cache_len)
        x, new_state = self._run_stack(x, state, prefill_mode=True)
        new_state["pos"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                        device=x.device)
        return self._logits(self.ln_f(x)), new_state


def init_decode_state(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Zeros on ``device`` (``None``: the CUDA card): per Mamba layer the
    conv cache and SSD state, per shared-attention invocation site a KV
    cache."""
    dev = resolve_device(device)
    cd = L.dt(cfg.compute_dtype)
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    n_attn = len(_segments(cfg))
    kv = (n_attn, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"conv": torch.zeros((cfg.n_layers, batch, s.conv_kernel - 1,
                                 di + 2 * s.state), dtype=cd, device=dev),
            "ssd": torch.zeros((cfg.n_layers, batch, nh, s.state,
                                s.head_dim), dtype=torch.float32, device=dev),
            "k": torch.zeros(kv, dtype=cd, device=dev),
            "v": torch.zeros(kv, dtype=cd, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}
