"""Plain float32 reference of the ``moe`` family (granite-3.0 MoE as the
configuration states it): pre-norm blocks of GQA attention with rotary
positions, then top-k routed SwiGLU experts with capacity dispatch, a tied
unembedding.

The experts see tokens in the groups the served traffic makes: a prefill
routes the batch's prompt tokens in row-major groups of
``moe_group_tokens``, a decode step routes the batch's one token per
sequence in groups of that many sequences.  Within a group each expert
takes at most ``ceil(S k / E * capacity_factor)`` tokens, filled choice
by choice (every token's first choice before any second choice), tokens
in order; a choice past the capacity is dropped (GShard / Switch).  The
reference therefore follows whole decode groups: :func:`sample` returns
every sequence of the job, and :func:`hidden` runs them teacher-forced,
one decode group at a time, with the groups the program saw.
"""

from __future__ import annotations

import math

import torch

from .common import F32, attention_block, fake_quant, rmsnorm, silu


def _groups(port: dict, batch: int, prompt_len: int) -> tuple[int, int]:
    """Tokens per prefill group, sequences per decode group."""
    group = port["moe_group_tokens"]
    return min(group, batch * prompt_len), min(group, batch)


def sample(cfg: dict, check: dict, batch: int, prompt_len: int,
           gen: torch.Generator) -> list:
    """Every sequence of the batch: each decode group couples its
    sequences, and a fault may touch any part of the batch."""
    return list(range(batch))


def _route(h: torch.Tensor, router: torch.Tensor, k: int, cap: int):
    """h (G, S, d) -> (top experts (G, S, k), their gates with dropped
    choices zeroed)."""
    gates = torch.softmax(h @ router.to(F32), dim=-1)
    e = gates.shape[-1]
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    used = torch.zeros(h.shape[0], e, dtype=torch.int64, device=h.device)
    keep = torch.zeros_like(topv, dtype=torch.bool)
    for slot in range(k):
        onehot = torch.nn.functional.one_hot(topi[..., slot], e)
        pos = torch.cumsum(onehot, dim=1) - 1 + used[:, None, :]
        used = used + onehot.sum(dim=1)
        mine = torch.gather(pos, 2, topi[..., slot:slot + 1])[..., 0]
        keep[..., slot] = mine < cap
    return topi, topv * keep


def moe_layer(h: torch.Tensor, w: dict, pre: str, port: dict, rnd
              ) -> torch.Tensor:
    """The routed experts on ``h`` (G, S, d), one routing group per row."""
    m = port["moe"]
    e, k = m["n_experts"], m["top_k"]
    s = h.shape[1]
    cap = max(1, int(math.ceil(s * k / e * m["capacity_factor"])))
    topi, wgt = _route(h, w[pre + "router"], k, cap)
    flat = h.reshape(-1, h.shape[-1])
    topi, wgt = topi.reshape(-1, k), wgt.reshape(-1, k)
    out = torch.zeros_like(flat)
    wg = fake_quant(w[pre + "w_gate"].to(F32), 8, 1)
    wu = fake_quant(w[pre + "w_up"].to(F32), 8, 1)
    wd = fake_quant(w[pre + "w_down"].to(F32), 8, 1)
    for x in range(e):
        gate = (wgt * (topi == x)).sum(-1)
        rows = torch.nonzero(gate > 0)[:, 0]
        if rows.numel() == 0:
            continue
        xs = fake_quant(flat[rows], 8, -1)
        hh = rnd(silu(rnd(xs @ wg[x])) * rnd(xs @ wu[x]))
        out.index_add_(0, rows, gate[rows, None] * rnd(hh @ wd[x]))
    return rnd(out).reshape(h.shape)


def hidden(cfg: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
           batch: int, rnd) -> torch.Tensor:
    """The final-norm hidden states (N, T - prompt_len, d) at the
    positions whose next token was served, for ``tokens`` (N, T): whole
    decode groups of the batch in order, prompts and served tokens, run
    teacher-forced (the last served token is not run), a group at a
    time."""
    _, sd = _groups(cfg["port"], batch, prompt_len)
    if tokens.shape[0] % sd:
        raise ValueError("the sample is not made of whole decode groups")
    return torch.cat([_group_hidden(cfg, w, tokens[i:i + sd], prompt_len,
                                    batch, rnd)
                      for i in range(0, tokens.shape[0], sd)])


def _group_hidden(cfg: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
                  batch: int, rnd) -> torch.Tensor:
    """:func:`hidden` of the sequences of one decode group."""
    port = cfg["port"]
    n, t = tokens.shape
    run = tokens[:, :-1]
    sp, sd = _groups(port, batch, prompt_len)
    if n != sd or (n * prompt_len) % sp:
        raise ValueError("the sample is not one whole decode group")
    x = rnd(w["embed.emb"][run].to(F32))
    d = x.shape[-1]
    for i in range(port["n_layers"]):
        pre = f"blocks.{i}."
        x = attention_block(x, w, pre, port, rnd)
        h = rnd(rmsnorm(x, w[pre + "ln_mlp.g"]))
        # prefill groups: the prompts' tokens row-major; decode groups: one
        # position of every sequence of the group
        y_pre = moe_layer(h[:, :prompt_len].reshape(-1, sp, d), w,
                          pre + "moe.", port, rnd)
        y_dec = moe_layer(h[:, prompt_len:].transpose(0, 1), w,
                          pre + "moe.", port, rnd)
        y = torch.cat([y_pre.reshape(n, prompt_len, d),
                       y_dec.transpose(0, 1)], dim=1)
        x = rnd(x + y)
    x = rnd(rmsnorm(x, w["ln_f.g"]))
    return x[:, prompt_len - 1:]


def unembed(cfg: dict, w: dict) -> torch.Tensor:
    """(V, d): the tied embedding's real rows."""
    return w["embed.emb"][:cfg["port"]["vocab"]].to(F32)

