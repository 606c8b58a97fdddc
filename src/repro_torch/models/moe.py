"""Mixture-of-Experts decoder (granite-3.0-moe family): GQA attention + top-k
routed SwiGLU experts with GShard/Switch capacity-based dispatch (the port
of the JAX package's ``repro/models/moe.py``).

Dispatch is the reference's einsum formulation: token groups of
``MOE_GROUP`` tokens build (group, S, E, C) dispatch/combine tensors, the
experts run as batched einsums over every expert's capacity slots, and the
combine einsum gathers them back.  On the card the slot assignment is
one hand-written kernel (:mod:`repro_torch.kernels.moe_dispatch`), in
serving and in training alike (:class:`_CardSlots` gives it the loop's
gradient); CPU tensors run the plain loop (:func:`_slots_ref`), whose
bits it equals.  All experts' weights pass through the DCIM fake-quant in
every call (per expert and output column), as in the reference.  The
reference's expert-parallel sharding constraints sit at its call sites
(:func:`~repro_torch.parallel.sharding.constrain_act`).

Over batch ranks (:func:`repro_torch.parallel.zero.data_parallel`, which
the sharded train step and the sharded serving launcher enter) each rank
groups its own tokens when it holds a multiple of ``MOE_GROUP`` tokens:
those are the reference's groups of the global token order, and the
load-balance loss's ``density`` and ``p_mean`` are averaged over the
batch ranks before their product, so it is the global one.  Otherwise a
group would span ranks, and every rank gathers the batch ranks' tokens
(:func:`repro_torch.parallel.zero.dp_all_rows`), runs the layer on the
global batch and keeps its own rows, in serving and in training alike.
The load-balance loss then comes from the global groups on every rank and
is not averaged again.  The gather's backward brings each rank's rows'
gradients back to it, summed over the batch ranks, so the sharded step
computes the one-device gradients (:mod:`repro_torch.parallel.zero`).

The model is the port's :class:`~repro_torch.models.transformer.Transformer`
with each block's MLP replaced by :class:`MoeMlp`; ``forward_train``
returns the mean of the blocks' load-balance losses beside the logits.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from ..kernels.moe_dispatch.kernel import moe_dispatch_cuda
from ..obs import tracer
from ..parallel.sharding import constrain_act
from ..parallel.zero import (dp_all_rows, dp_mean, dp_size_now,
                             single_batch_rank)
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


def _takes_kernel(gates: torch.Tensor) -> bool:
    """Whether the slot assignment of ``gates`` runs the card's kernel:
    on CUDA tensors; CPU tensors run the plain version."""
    return gates.is_cuda


def _dispatch_kernel(topv: torch.Tensor, topi: torch.Tensor, e: int,
                     capacity: int):
    """The card's route (one launch): (dispatch, combine, held)."""
    return moe_dispatch_cuda(topv, topi, e, capacity)


class _CardSlots(torch.autograd.Function):
    """The card's slot assignment, differentiable in ``topv`` as the loop
    is.  Each (g, s, e) holds at most one choice, in at most one slot, so
    the loop's gradient of choice j is that of its expert's row of
    ``combine`` where ``dispatch`` holds; dispatch and held take none."""

    @staticmethod
    def forward(ctx, topv, topi, e, capacity):
        dispatch, combine, held = _dispatch_kernel(topv, topi, e, capacity)
        ctx.mark_non_differentiable(dispatch, held)
        ctx.save_for_backward(topi, dispatch)
        return dispatch, combine, held

    @staticmethod
    def backward(ctx, _, g_combine, __):
        topi, dispatch = ctx.saved_tensors
        g = (g_combine * dispatch).sum(-1)                     # (G,S,E)
        return torch.take_along_dim(g, topi, -1), None, None, None


def _slots_ref(topv: torch.Tensor, topi: torch.Tensor, e: int,
               capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain slot assignment of the top-k choices ``(topv, topi)``
    (G, S, k): (dispatch (G,S,E,C) bool, combine (G,S,E,C) f32).  Iterate
    the k choices, positions within an expert given by a cumulative count
    over the group; overflow tokens drop (capacity factor)."""
    g, s, _ = topi.shape
    dev = topi.device
    prio_used = torch.zeros((g, e), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((g, s, e, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((g, s, e, capacity), dtype=torch.float32,
                          device=dev)
    for slot in range(topi.shape[-1]):
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
    return dispatch, combine


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int):
    """gates: (G, S, E) softmax router probs.  Returns (dispatch (G,S,E,C)
    bool, combine (G,S,E,C) f32, aux_loss) via the Switch/GShard slot
    assignment of the top-k choices: the card's kernel where
    :func:`_takes_kernel` says so, else the plain version
    (:func:`_slots_ref`), bit for bit the same."""
    e = gates.shape[-1]
    topv, topi = _top_k(gates, k)                              # (G,S,k)
    if _takes_kernel(gates):
        dispatch, combine, held = _CardSlots.apply(topv, topi, e, capacity)
    else:
        dispatch, combine = _slots_ref(topv, topi, e, capacity)
        held = dispatch.any(-1).to(torch.float32)
    # load-balance aux (Switch): E * sum_e f_e * p_e, both means over every
    # group, those of the other batch ranks too
    density = dp_mean(held.mean(dim=(0, 1)))
    p_mean = dp_mean(gates.mean(dim=(0, 1)))
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
        self.router = L._empty((d, e), dtype, device, ("embed", "experts"))
        self.w_gate = L._empty((e, d, ff), dtype, device,
                               ("experts", "embed", "expert_ff"))
        self.w_up = L._empty((e, d, ff), dtype, device,
                             ("experts", "embed", "expert_ff"))
        self.w_down = L._empty((e, ff, d), dtype, device,
                               ("experts", "expert_ff", "embed"))
        self.a_bits, self.w_bits = cfg.dcim_a_bits, cfg.dcim_w_bits
        self.enabled = cfg.dcim_enabled

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.router, self.w_gate, self.w_up, self.w_down):
            L.init_param(w, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, d) -> (y, aux_loss).  B·S must be at most
        ``MOE_GROUP`` or a multiple of it, as in the reference; over batch
        ranks, the global batch's (module doc)."""
        b, s, _ = x.shape
        if dp_size_now() > 1 and (b * s) % MOE_GROUP:
            xs, first = dp_all_rows(x)
            y, aux = self._grouped(xs, groups_global=True)
            return y[first:first + b], aux
        return self._grouped(x)

    def _grouped(self, x: torch.Tensor, groups_global: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The layer on the tokens of ``x`` in groups of ``MOE_GROUP``
        (``groups_global``: ``x`` is the global batch).  The router and the
        slot assignment run in a ``moe.route`` span, tagged ``kernel``
        (whether the card's kernel assigned the slots) and with the
        capacity count: ``routed`` assignments (G·S·top_k), ``slots``
        (G·E·C, what the expert einsums compute) and ``kept``, those that
        found a slot (a device scalar, resolved when the spans are read).
        The dispatch, the experts and the combine run in ``moe.experts``."""
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
        cap = max(1, int(math.ceil(sg * k / e * self.cfg.moe.capacity_factor)))
        with tracer.span("moe.route") as route:
            logits = torch.matmul(xg.to(torch.float32),
                                  L.whole(self.router).to(torch.float32))
            gates = torch.softmax(logits, dim=-1)
            # global groups: their aux is the global one already
            with single_batch_rank() if groups_global else \
                    contextlib.nullcontext():
                dispatch, combine, aux = _top_k_dispatch(gates, k, cap)
            if route:
                route.set_tag("kernel", _takes_kernel(gates))
                route.set_tag("routed", gcount * sg * k)
                route.set_tag("slots", gcount * e * cap)
                route.set_tag("kept", dispatch.sum())
        with tracer.span("moe.experts"):
            # dispatch: (G,Sg,E,C) x (G,Sg,d) -> (E,G,C,d)
            xin = torch.einsum("gsec,gsd->egcd", dispatch.to(cd), xg)
            xin = constrain_act(xin, ("experts", "batch", None, None))
            wg, wu, wd = (L.whole(w).to(cd) for w in (self.w_gate, self.w_up,
                                                      self.w_down))
            if self.enabled:
                wg = fake_quant(wg, self.w_bits, 1)
                wu = fake_quant(wu, self.w_bits, 1)
                wd = fake_quant(wd, self.w_bits, 1)
                xin = fake_quant(xin, self.a_bits, -1)
            gate = torch.einsum("egcd,edf->egcf", xin, wg)
            h = gate * torch.sigmoid(gate) * torch.einsum("egcd,edf->egcf",
                                                          xin, wu)
            hout = torch.einsum("egcf,efd->egcd", h, wd)
            hout = constrain_act(hout, ("experts", "batch", None, None))
            # combine back: (G,Sg,E,C) x (E,G,C,d) -> (G,Sg,d)
            y = torch.einsum("gsec,egcd->gsd", combine.to(cd), hout)
            y = constrain_act(y, ("batch", None, None))
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
        mean load-balance loss, which carries gradient into the routers
        through the gates' mean).  Each block is rematerialised when
        training with ``cfg.remat``."""
        x = self.embed(batch["tokens"], self._cd)
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device).expand(b, s)
        auxes = []
        for blk in self.blocks:
            x, aux = L.remat(lambda h, blk=blk: blk.forward_aux(h,
                                                                positions=pos),
                             x, enabled=self.cfg.remat)
            auxes.append(aux)
        return self._logits(self.ln_f(x)), torch.stack(auxes).mean()
