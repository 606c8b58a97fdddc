"""Plain float32 reference of the ``hybrid`` family (Zamba2 as the
configuration states it): Mamba2 (SSD) blocks, and one shared attention +
SwiGLU block (one set of weights) after every ``attn_every`` of them, an
untied unembedding.

A Mamba2 block: ``h = rmsnorm(x)``; ``in_proj`` gives z, xBC and dt;
``xBC = conv(silu(xBC))``, a depthwise causal conv over the last
``conv_kernel`` inputs; dt = softplus(dt + dt_bias); per head h the
state ``S_t = exp(-exp(A_log_h) dt_t) S_{t-1} + B_t (dt_t x_t)^T`` and
``y_t = C_t^T S_t + D_h x_t``, B and C shared by the heads;
``out_proj(rmsnorm(y * silu(z)))`` added to x.  The recurrence is
evaluated in its quadratic form, ``y_t = sum_{s<=t} exp(c_t - c_s)
(C_t . B_s) dt_s x_s`` with ``c`` the running sum of the log decays, so
every exponent is at most 0.  Sequences are independent: any sample of
them can be run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import F32, attention_block, dcim_linear, rmsnorm, silu, swiglu


def sample(cfg: dict, check: dict, batch: int, prompt_len: int,
           gen: torch.Generator) -> list:
    """``check['sample_sequences']`` sequences of the batch, drawn from
    ``gen``."""
    n = min(int(check["sample_sequences"]), batch)
    return sorted(torch.randperm(batch, generator=gen)[:n].tolist())


def _ssd(xs, b, c, dt, a_log, heads: int, rows: int = 4):
    """The SSD recurrence of one block in its quadratic form.  xs (N, T,
    H*P), b and c (N, T, S), dt (N, T, H)."""
    n, t, _ = xs.shape
    v = xs.reshape(n, t, heads, -1) * dt[..., None]            # dt x_t
    cum = torch.cumsum(-torch.exp(a_log.to(F32)) * dt, dim=1)  # (N, T, H)
    causal = torch.ones(t, t, dtype=torch.bool, device=xs.device).tril()
    out = []
    for i in range(0, n, rows):
        ci = cum[i:i + rows].transpose(1, 2)                   # (n, H, T)
        decay = torch.exp((ci[..., :, None] - ci[..., None, :])
                          .masked_fill(~causal, -torch.inf))   # (n,H,T,T)
        cb = c[i:i + rows] @ b[i:i + rows].transpose(1, 2)     # (n, T, T)
        m = decay * cb[:, None]
        out.append((m @ v[i:i + rows].transpose(1, 2)).transpose(1, 2))
    return torch.cat(out)                                      # (N,T,H,P)


def mamba_block(x, w: dict, pre: str, port: dict, rnd):
    s = port["ssm"]
    n, t, d = x.shape
    di = s["expand"] * d
    heads = di // s["head_dim"]
    ksz = s["conv_kernel"]
    h = rnd(rmsnorm(x, w[pre + "ln.g"]))
    proj = dcim_linear(h, w[pre + "in_proj.w"], rnd)
    z, xbc, dtp = torch.split(proj, [di, di + 2 * s["state"], heads], -1)
    xbc = F.pad(rnd(silu(xbc)), (0, 0, ksz - 1, 0))
    conv_w = w[pre + "conv_w"].to(F32)
    xbc = rnd(sum(xbc[:, i:i + t] * conv_w[i] for i in range(ksz)))
    xs, b, c = torch.split(xbc, [di, s["state"], s["state"]], -1)
    dt = F.softplus(dtp + w[pre + "dt_bias"].to(F32))
    y = _ssd(xs, b, c, dt, w[pre + "A_log"], heads)
    y = y + xs.reshape(n, t, heads, -1) * w[pre + "D"].to(F32)[:, None]
    y = rnd(y.reshape(n, t, di))
    y = rnd(rmsnorm(y * silu(z), w[pre + "ln_y.g"]))
    return rnd(x + dcim_linear(y, w[pre + "out_proj.w"], rnd))


def _segments(port: dict) -> list:
    k = port["attn_every"]
    full, rem = divmod(port["n_layers"], k)
    return [k] * full + ([rem] if rem else [])


def hidden(cfg: dict, w: dict, tokens: torch.Tensor, prompt_len: int,
           batch: int, rnd) -> torch.Tensor:
    """The final-norm hidden states (N, T - prompt_len, d) at the positions
    whose next token was served, for ``tokens`` (N, T) run teacher-forced
    (the last served token is not run)."""
    port = cfg["port"]
    x = rnd(w["embed.emb"][tokens[:, :-1]].to(F32))
    layer = 0
    for seg in _segments(port):
        for _ in range(seg):
            x = mamba_block(x, w, f"mamba.{layer}.", port, rnd)
            layer += 1
        x = attention_block(x, w, "shared_attn.", port, rnd)
        h = rnd(rmsnorm(x, w["shared_attn.ln_mlp.g"]))
        x = rnd(x + swiglu(h, w["shared_attn.mlp.w_gate.w"],
                           w["shared_attn.mlp.w_up.w"],
                           w["shared_attn.mlp.w_down.w"], rnd))
    x = rnd(rmsnorm(x, w["ln_f.g"]))
    return x[:, prompt_len - 1:]


def unembed(cfg: dict, w: dict) -> torch.Tensor:
    """(V, d): the unembedding's real columns, transposed."""
    return w["unembed.w"][:, :cfg["port"]["vocab"]].to(F32).T
