"""Dense GQA transformer family: llama3.2 / qwen3 / mistral-large / phi3,
plus the VLM (internvl2: stub patch embeddings + projector) and the audio
enc-dec (whisper: stub frame embeddings + encoder + cross-attending decoder)
(the port of the JAX package's ``repro/models/transformer.py``).

The reference stacks each layer's parameters on a ``layer`` axis and runs
them under ``lax.scan`` (with optional remat, which only training needs);
here the blocks are an ``nn.ModuleList`` run in a loop, and
:func:`repro_torch.convert.model_params_from_numpy` unstacks the layer axis.
The decode state keeps the reference's layout — ``k`` / ``v`` stacked as
``(L, B, cache_len, n_kv_heads, hd)`` in the compute dtype, ``pos`` an int32
scalar, ``enc_out`` for audio — and :meth:`Transformer.decode_step` writes
the caches in place, where the reference donates them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import layers as L


class Block(nn.Module):
    """Pre-norm decoder block: attention, cross-attention (``cross``), MLP."""

    def __init__(self, cfg, dtype: torch.dtype, device, cross: bool = False):
        super().__init__()
        self.ln_attn = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.ln_mlp = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.Mlp(cfg, dtype, device)
        if cross:
            self.ln_xattn = L.RMSNorm(cfg.d_model, device)
            self.xattn = L.Attention(cfg, dtype, device)

    def forward(self, x, *, positions, causal=True, kv_cache=None,
                cache_pos=None, enc_kv=None, prefill_fill=False):
        x = x + self.attn(self.ln_attn(x), positions=positions,
                          causal=causal, kv_cache=kv_cache,
                          cache_pos=cache_pos, prefill_fill=prefill_fill)
        if enc_kv is not None:
            x = x + self.xattn(self.ln_xattn(x), positions=None,
                               causal=False, kv_override=enc_kv)
        return x + self.mlp(self.ln_mlp(x))


class Transformer(L.ZooModel):
    """The model's parameters and its four functions (``forward_train``,
    ``init_decode_state``, ``prefill``, ``decode_step``).

    Built with uninitialised parameters on ``device`` (``None``: the CUDA
    card); :meth:`init_params` draws them, or
    :func:`repro_torch.convert.model_params_from_numpy` copies the
    reference's in.
    """

    block_cls = Block

    def __init__(self, cfg, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = L.dt(cfg.param_dtype)
        self.cfg = cfg
        self.embed = L.Embedding(cfg.vocab_padded, cfg.d_model, dtype, dev)
        cross = cfg.encoder_layers > 0
        self.blocks = nn.ModuleList(self.block_cls(cfg, dtype, dev,
                                                   cross=cross)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model, dev)
        self.unembed = (None if cfg.tie_embeddings else
                        L.Projection(cfg.d_model, cfg.vocab_padded, dtype,
                                     dev))
        self.frontend_proj = (None if cfg.frontend is None else
                              L.Projection(cfg.frontend.d_frontend,
                                           cfg.d_model, dtype, dev))
        if cfg.encoder_layers > 0:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, dtype, dev) for _ in range(cfg.encoder_layers))
            self.enc_ln_f = L.RMSNorm(cfg.d_model, dev)

    # ------------------------------------------------------------- helpers
    def _encode(self, frames):
        """Whisper encoder over (stubbed) frame embeddings (B, F,
        d_frontend)."""
        x = frames.to(self._cd)
        if self.frontend_proj is not None:
            x = self.frontend_proj(x, self._cd)
        b, f, _ = x.shape
        pos = torch.arange(f, device=x.device).expand(b, f)
        for blk in self.enc_blocks:
            x = blk(x, positions=pos, causal=False)
        return self.enc_ln_f(x)

    def _cross_kv(self, blk, enc_out):
        """Cross-attention K/V from the encoder output through the block's
        ``xattn`` ``wk`` / ``wv`` (no rope)."""
        cfg = self.cfg
        eb, ef, _ = enc_out.shape
        kx = blk.xattn.wk(enc_out, self._cd).reshape(eb, ef, cfg.n_kv_heads,
                                                     cfg.hd)
        vx = blk.xattn.wv(enc_out, self._cd).reshape(eb, ef, cfg.n_kv_heads,
                                                     cfg.hd)
        return kx, vx

    # ------------------------------------------------------------ training
    def forward_train(self, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {'tokens': (B,S)} (+ 'frontend': (B,F,d_frontend) for
        vlm/audio).  Returns (logits (B, S, vocab), aux 0): the vlm prefix
        is prepended to the sequence and sliced off the logits.  Forward
        only; training waits for ROADMAP.md queue 1, item 8."""
        cd = self._cd
        x = self.embed(batch["tokens"], cd)
        enc = None
        prefix = 0
        if self.cfg.family == "vlm":
            img = self.frontend_proj(batch["frontend"].to(cd), cd)
            x = torch.cat([img, x], dim=1)
            prefix = img.shape[1]
        if self.cfg.encoder_layers > 0:
            enc = self._encode(batch["frontend"])
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)
        for blk in self.blocks:
            ekv = None if enc is None else self._cross_kv(blk, enc)
            x = blk(x, positions=pos, enc_kv=ekv)
        logits = self._logits(self.ln_f(x))
        if prefix:
            logits = logits[:, prefix:]
        return logits, self._no_aux()

    # ------------------------------------------------------------- serving
    def init_decode_state(self, batch: int, cache_len: int) -> dict:
        """:func:`init_decode_state` on the model's device."""
        return init_decode_state(self.cfg, batch, cache_len, self.device)

    @torch.no_grad()
    def decode_step(self, state: dict, tokens: torch.Tensor,
                    frontend=None) -> tuple[torch.Tensor, dict]:
        """One decode step: tokens (B, S) -> logits (B, S, V).

        ``state['pos']`` is the number of tokens already cached; the caches
        ``state['k']`` / ``['v']`` are updated in place, and the returned
        state holds them with ``pos`` advanced by S.
        """
        x = self.embed(tokens, self._cd)
        b, s, _ = x.shape
        pos_idx = state["pos"]
        positions = (pos_idx + torch.arange(s, device=x.device)).expand(b, s)
        enc_out = (state.get("enc_out") if self.cfg.encoder_layers > 0
                   else None)
        for i, blk in enumerate(self.blocks):
            ekv = None if enc_out is None else self._cross_kv(blk, enc_out)
            x = blk(x, positions=positions,
                    kv_cache={"k": state["k"][i], "v": state["v"][i]},
                    cache_pos=pos_idx, enc_kv=ekv)
        logits = self._logits(self.ln_f(x))
        new_state = dict(state)
        new_state["pos"] = pos_idx + s
        return logits, new_state

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache_len: int,
                frontend=None) -> tuple[torch.Tensor, dict]:
        """Run the prompt through the model, filling the KV caches.  Like
        the reference, only the tokens are embedded: a vlm's image prefix
        is not prepended here (ROADMAP.md, "Reference state"); the audio
        encoder runs over ``frontend``."""
        x = self.embed(tokens, self._cd)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        state = self.init_decode_state(b, cache_len)
        enc_out = None
        if self.cfg.encoder_layers > 0:
            enc_out = self._encode(frontend)
        zero = state["pos"]
        for i, blk in enumerate(self.blocks):
            ekv = None if enc_out is None else self._cross_kv(blk, enc_out)
            x = blk(x, positions=positions,
                    kv_cache={"k": state["k"][i], "v": state["v"][i]},
                    cache_pos=zero, enc_kv=ekv, prefill_fill=True)
        logits = self._logits(self.ln_f(x))
        state["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
        if enc_out is not None:
            state["enc_out"] = enc_out
        return logits, state


def init_decode_state(cfg, batch: int, cache_len: int, device=None) -> dict:
    """Per-layer KV caches stacked on the layer axis, zeros, on ``device``
    (``None``: the CUDA card)."""
    dev = resolve_device(device)
    cd = L.dt(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    state = {"k": torch.zeros(shape, dtype=cd, device=dev),
             "v": torch.zeros(shape, dtype=cd, device=dev),
             "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.encoder_layers > 0:
        state["enc_out"] = torch.zeros(
            (batch, cfg.frontend.n_tokens, cfg.d_model), dtype=cd,
            device=dev)
    return state
