"""Mixture-of-Experts decoder (granite-3.0-moe family): GQA attention + top-k
routed SwiGLU experts with GShard/Switch capacity-based dispatch (the port
of the JAX package's ``repro/models/moe.py``).

Dispatch is the reference's einsum formulation: token groups of
``MOE_GROUP`` tokens build (group, S, E, C) dispatch/combine tensors, the
experts run as batched einsums over every expert's capacity slots, and the
combine einsum gathers them back.  All experts' weights pass through the
DCIM fake-quant in every call (per expert and output column), as in the
reference.  The reference's expert-parallel sharding constraints are left
out: on one device they do nothing.

The model is the port's :class:`~repro_torch.models.transformer.Transformer`
with each block's MLP replaced by :class:`MoeMlp`; ``forward_train``
returns the mean of the blocks' load-balance losses beside the logits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..quant import fake_quant
from . import layers as L
from .transformer import Transformer

MOE_GROUP = 256      # tokens per dispatch group


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest gates and their experts, largest first, ties to
    the lower index (``jax.lax.top_k``'s order): a stable descending sort,
    since ``torch.topk`` promises no order among equal values."""
    v, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int):
    """gates: (G, S, E) softmax router probs.  Returns (dispatch (G,S,E,C)
    bool, combine (G,S,E,C) f32, aux_loss) via the Switch/GShard slot
    assignment: iterate the k choices, positions within an expert given by a
    cumulative count over the group; overflow tokens drop (capacity factor)."""
    g, s, e = gates.shape
    topv, topi = _top_k(gates, k)                              # (G,S,k)
    dev = gates.device
    prio_used = torch.zeros((g, e), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((g, s, e, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, s, e, capacity), dtype=torch.float32,
                          device=dev)
    for slot in range(k):
        idx = topi[..., slot]                                  # (G,S)
        onehot = nn.functional.one_hot(idx, e).to(torch.int32)  # (G,S,E)
        pos = torch.cumsum(onehot, dim=1) - 1 + prio_used[:, None, :]
        prio_used = prio_used + onehot.sum(dim=1, dtype=torch.int32)
        mypos = torch.take_along_dim(pos, idx[..., None], -1)[..., 0]  # (G,S)
        keep = mypos < capacity
        posoh = nn.functional.one_hot(
            torch.where(keep, mypos, capacity).long(), capacity + 1
        ).to(torch.float32)[..., :capacity]                    # (G,S,C)
        d_slot = onehot.to(torch.float32)[..., None] * posoh[..., None, :]
        dispatch = dispatch | (d_slot > 0)
        combine = combine + d_slot * topv[..., slot][..., None, None]
    # load-balance aux (Switch): E * sum_e f_e * p_e
    density = dispatch.any(-1).to(torch.float32).mean(dim=(0, 1))  # (E,)
    p_mean = gates.mean(dim=(0, 1))
    aux = e * torch.sum(density * p_mean)
    return dispatch, combine, aux


class MoeMlp(nn.Module):
    """The router ``(d, E)`` and the experts' SwiGLU weights ``w_gate``,
    ``w_up`` ``(E, d, ff)`` and ``w_down`` ``(E, ff, d)``; the experts'
    weights fake-quantised per expert and output column when
    ``enabled``."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
        self.cfg = cfg
        self.router = L._empty((d, e), dtype, device)
        self.w_gate = L._empty((e, d, ff), dtype, device)
        self.w_up = L._empty((e, d, ff), dtype, device)
        self.w_down = L._empty((e, ff, d), dtype, device)
        self.a_bits, self.w_bits = cfg.dcim_a_bits, cfg.dcim_w_bits
        self.enabled = cfg.dcim_enabled

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            L.init_param(w, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) -> (y, aux_loss).  B·S must be at most
        ``MOE_GROUP`` or a multiple of it, as in the reference."""
        cd = x.dtype
        b, s, d = x.shape
        e, k = self.cfg.moe.n_experts, self.cfg.moe.top_k
        toks = b * s
        sg = min(MOE_GROUP, toks)
        gcount = toks // sg
        if gcount * sg != toks:
            # the reference's reshape raises TypeError here
            raise TypeError(f"cannot reshape array of shape {(b, s, d)} "
                            f"(size {toks * d}) into shape {(gcount, sg, d)} "
                            f"(size {gcount * sg * d})")
        xg = x.reshape(gcount, sg, d)
        logits = torch.matmul(xg.to(torch.float32),
                              self.router.to(torch.float32))
        gates = torch.softmax(logits, dim=-1)
        cap = max(1, int(math.ceil(sg * k / e * self.cfg.moe.capacity_factor)))
        dispatch, combine, aux = _top_k_dispatch(gates, k, cap)

        # dispatch: (G,Sg,E,C) x (G,Sg,d) -> (E,G,C,d)
        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(cd), xg)
        wg, wu, wd = (w.to(cd) for w in (self.w_gate, self.w_up,
                                         self.w_down))
        if self.enabled:
            wg = fake_quant(wg, self.w_bits, 1)
            wu = fake_quant(wu, self.w_bits, 1)
            wd = fake_quant(wd, self.w_bits, 1)
            xin = fake_quant(xin, self.a_bits, -1)
        gate = torch.einsum("egcd,edf->egcf", xin, wg)
        h = gate * torch.sigmoid(gate) * torch.einsum("egcd,edf->egcf", xin,
                                                      wu)
        hout = torch.einsum("egcf,efd->egcd", h, wd)
        # combine back: (G,Sg,E,C) x (E,G,C,d) -> (G,Sg,d)
        y = torch.einsum("gsec,egcd->gsd", combine.to(cd), hout)
        return y.reshape(b, s, d), aux


class MoeBlock(nn.Module):
    """Pre-norm block: attention, then the routed experts."""

    def __init__(self, cfg, dtype: torch.dtype, device, **_):
        super().__init__()
        self.ln_attn = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, dtype, device)
        self.ln_mlp = L.RMSNorm(cfg.d_model, device)
        self.moe = MoeMlp(cfg, dtype, device)

    def forward_aux(self, x, *, positions, kv_cache=None, cache_pos=None,
                    prefill_fill=False):
        """(x, the block's load-balance loss)."""
        x = x + self.attn(self.ln_attn(x), positions=positions,
                          kv_cache=kv_cache, cache_pos=cache_pos,
                          prefill_fill=prefill_fill)
        y, aux = self.moe(self.ln_mlp(x))
        return x + y, aux

    def forward(self, x, *, positions, kv_cache=None, cache_pos=None,
                enc_kv=None, prefill_fill=False):
        """The transformer block's interface as ``Transformer.prefill`` and
        ``decode_step`` call it (``enc_kv`` is None: no encoder), the loss
        dropped."""
        return self.forward_aux(x, positions=positions, kv_cache=kv_cache,
                                cache_pos=cache_pos,
                                prefill_fill=prefill_fill)[0]


class MoeTransformer(Transformer):
    """The granite MoE model: the transformer's embedding, KV caches,
    ``prefill``, ``decode_step`` and logits over :class:`MoeBlock`s."""

    block_cls = MoeBlock

    def forward_train(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {'tokens': (B,S)} -> (logits (B,S,vocab), the blocks'
        mean load-balance loss).  Forward only."""
        x = self.embed(batch["tokens"], self._cd)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)
        auxes = []
        for blk in self.blocks:
            x, aux = blk.forward_aux(x, positions=pos)
            auxes.append(aux)
        return self._logits(self.ln_f(x)), torch.stack(auxes).mean()
