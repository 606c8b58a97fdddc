"""Plain float32 reference of the ``rwkv6`` family: RWKV-6 "Finch" as
published (arXiv:2404.05892 §4), an untied unembedding.

The embedding goes through ``ln0``; each block adds
``time_mix(ln1(x))`` and then ``channel_mix(ln2(x))``; ``ln_f`` before the
head.  Every norm is a LayerNorm with gain and bias (eps 1e-5).  With
``sx = x_{t-1} - x_t`` (``x_{-1} = 0``):

* ddlerp: ``m = tanh((x + sx maa_x) maa_w1) maa_w2``, one rank-r slice of
  ``maa_w1`` and one ``(r, d)`` slab of ``maa_w2`` per target, in the order
  w, k, v, r, g; each target's input is ``x + sx (maa_<target> + m)``;
* decay: ``log w = -exp(w0 + tanh(x_w decay_w1) decay_w2)``;
* WKV per head: ``y_t = r_t (S + diag(u) k_t^T v_t)``, then
  ``S = diag(w_t) S + k_t^T v_t`` from ``S = 0``, run as the sequential
  recurrence over the tokens (no chunked form, no exponential of a
  summed decay);
* ``wo(GroupNorm_per_head(y) * silu(wg x_g))``, the GroupNorm's eps
  1e-5 x 8^2;
* channel-mix: ``sigmoid(cr x_r) * cv(relu(ck x_k)^2)`` on static lerps.

The eight projections are DCIM linears (int8 fake-quant); the LoRAs are
plain.  Sequences are independent: any sample of them can be run.
"""

from __future__ import annotations

import torch

from .common import F32, dcim_linear, silu

MIX = ("w", "k", "v", "r", "g")
GN_EPS = 1e-5 * 8 ** 2


def sample(cfg: dict, check: dict, batch: int, prompt_len: int,
           gen: torch.Generator) -> list:
    """``check['sample_sequences']`` sequences of the batch, drawn from
    ``gen``."""
    n = min(int(check["sample_sequences"]), batch)
    return sorted(torch.randperm(batch, generator=gen)[:n].tolist())


def layer_norm(x, g, b, eps: float = 1e-5, groups: int = 1):
    """LayerNorm over the last axis, or over each of ``groups`` equal
    slices of it."""
    xg = x.reshape(*x.shape[:-1], groups, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return y * g.to(F32) + b.to(F32)


def _ln(x, w: dict, pre: str, rnd, **kw):
    return rnd(layer_norm(x, w[pre + "g"], w[pre + "b"], **kw))


def _sx(x, rnd):
    """``x_{t-1} - x_t`` with ``x_{-1} = 0``."""
    prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return rnd(prev - x)


def wkv(r, k, v, log_w, u, heads: int):
    """The sequential recurrence (module doc); r, k, v, log_w (N, T, d),
    u (H, dk)."""
    n, t, d = r.shape
    r, k, v, dec = (z.reshape(n, t, heads, -1)
                    for z in (r, k, v, torch.exp(log_w)))
    u = u.to(F32)[None, :, :, None]
    s = torch.zeros(n, heads, d // heads, d // heads, dtype=F32,
                    device=r.device)
    out = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        out.append(torch.einsum("nhd,nhde->nhe", r[:, i], s + u * kv))
        s = dec[:, i, :, :, None] * s + kv
    return torch.stack(out, dim=1).reshape(n, t, d)


def time_mix(x, w: dict, pre: str, port: dict, rnd):
    n, t, d = x.shape
    sx = _sx(x, rnd)
    xxx = rnd(x + sx * w[pre + "maa_x"].to(F32))
    m = rnd(torch.tanh(rnd(xxx @ w[pre + "maa_w1"].to(F32))))
    m = m.reshape(n, t, len(MIX), -1)
    w2 = w[pre + "maa_w2"].to(F32)
    xs = {name: rnd(x + sx * (w[pre + f"maa_{name}"].to(F32)
                              + rnd(m[:, :, i] @ w2[i])))
          for i, name in enumerate(MIX)}
    r = dcim_linear(xs["r"], w[pre + "wr.w"], rnd)
    k = dcim_linear(xs["k"], w[pre + "wk.w"], rnd)
    v = dcim_linear(xs["v"], w[pre + "wv.w"], rnd)
    g = dcim_linear(xs["g"], w[pre + "wg.w"], rnd)
    lora = rnd(rnd(torch.tanh(rnd(xs["w"] @ w[pre + "decay_w1"].to(F32))))
               @ w[pre + "decay_w2"].to(F32))
    log_w = -torch.exp(w[pre + "w0"].to(F32) + lora)
    y = rnd(wkv(r, k, v, log_w, w[pre + "u"], port["n_heads"]))
    y = _ln(y, w, pre + "ln_x.", rnd, eps=GN_EPS, groups=port["n_heads"])
    return dcim_linear(rnd(y * rnd(silu(g))), w[pre + "wo.w"], rnd)


def channel_mix(x, w: dict, pre: str, rnd):
    sx = _sx(x, rnd)
    xk = rnd(x + sx * w[pre + "mu_ck"].to(F32))
    xr = rnd(x + sx * w[pre + "mu_cr"].to(F32))
    kk = rnd(torch.relu(dcim_linear(xk, w[pre + "ck.w"], rnd)) ** 2)
    return rnd(dcim_linear(kk, w[pre + "cv.w"], rnd)
               * rnd(torch.sigmoid(dcim_linear(xr, w[pre + "cr.w"], rnd))))


def hidden(cfg: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
           batch: int, rnd) -> torch.Tensor:
    """The final-norm hidden states (N, T - prompt_len, d) at the positions
    whose next token was served, for ``tokens`` (N, T) run teacher-forced
    (the last served token is not run)."""
    port = cfg["port"]
    x = _ln(rnd(w["embed.emb"][tokens[:, :-1]].to(F32)), w, "ln0.", rnd)
    for layer in range(port["n_layers"]):
        pre = f"blocks.{layer}."
        x = rnd(x + time_mix(_ln(x, w, pre + "ln1.", rnd), w, pre, port,
                             rnd))
        x = rnd(x + channel_mix(_ln(x, w, pre + "ln2.", rnd), w, pre, rnd))
    return _ln(x, w, "ln_f.", rnd)[:, prompt_len - 1:]


def unembed(cfg: dict, w: dict) -> torch.Tensor:
    """(V, d): the unembedding's real columns, transposed."""
    return w["unembed.w"][:, :cfg["port"]["vocab"]].to(F32).T
