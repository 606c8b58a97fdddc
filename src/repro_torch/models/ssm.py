"""Chunked decayed linear attention — the shared recurrence under RWKV6
("Finch", vector decay per key channel) and Mamba2 (SSD, scalar decay per
head) (the port of the JAX package's ``repro/models/ssm.py``).

Semantics per head with state S in R^{dk x dv}:

    S_t = Diag(w_t) S_{t-1} + k_t v_t^T
    y_t = q_t^T (S_{t-1} + Diag(u) k_t v_t^T)     [rwkv: bonus u, exclusive]
    y_t = q_t^T S_t                               [mamba: inclusive, no bonus]

Chunked evaluation (GLA-style): within a chunk of C tokens the decay factors
telescope into per-token exponentials of the cumulative log-decay, giving an
exact O(C^2) intra-chunk term plus an O(dk x dv) inter-chunk state.  The
reference carries that state by ``lax.scan`` over the chunks; here a Python
loop over the chunks runs the same einsums in the same order.

The factors ``exp(-cumsum(log_w))`` grow with the chunk's summed decay, as
in the reference: at RWKV6's initial decay (log w = -exp(-1) per channel) a
chunk of about 240 tokens or more overflows float32 and the output turns NaN
in both packages (ROADMAP.md, "Reference state").

Decode (T=1) uses the plain recurrence.
"""

from __future__ import annotations

import torch


def _to_chunks(x: torch.Tensor, nc: int, c: int) -> torch.Tensor:
    """(B, T, H, D) -> (NC, B, H, C, D)."""
    b, _, h, d = x.shape
    return x.reshape(b, nc, c, h, d).permute(1, 0, 3, 2, 4)


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, *, u: torch.Tensor | None = None,
                inclusive: bool = False, chunk: int = 256,
                s0: torch.Tensor | None = None, remat: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, T, H, dk); v: (B, T, H, dv); log_w: (B, T, H, dk) (<= 0).

    u: (H, dk) bonus (rwkv) — applied to the diagonal (current token) term.
    inclusive: diagonal uses decayed state *including* k_t v_t (mamba2).
    s0: (B, H, dk, dv) initial state.  ``remat`` (the reference's
    rematerialisation of the chunk body for training) has no effect here.
    Returns (y (B, T, H, dv) in v's dtype, final_state (B, H, dk, dv) f32).
    """
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    if pad:
        def padded(x):
            return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        q, k, v, log_w = padded(q), padded(k), padded(v), padded(log_w)
    tp = t + pad
    nc = tp // c
    f32 = torch.float32

    qc, kc, vc = (_to_chunks(x, nc, c) for x in (q, k, v))
    lwc = _to_chunks(log_w, nc, c).to(f32)

    ccum = torch.cumsum(lwc, dim=-2)                # inclusive over chunk
    ccum_ex = ccum - lwc                            # exclusive
    wtot = ccum[..., -1:, :]                        # (NC,B,H,1,dk)

    # Factored decay weights (exact; bounded within a chunk).  Convention:
    #   exclusive (rwkv):  y_i reads S_{i-1} -> q scales by exp(ccum_ex_i),
    #                      strictly-causal mask, diagonal via the u bonus;
    #   inclusive (mamba): y_i reads S_i     -> q scales by exp(ccum_i),
    #                      mask includes the diagonal.
    q_cum = ccum if inclusive else ccum_ex
    q_dec = qc.to(f32) * torch.exp(q_cum)                      # q~
    k_dec = kc.to(f32) * torch.exp(-ccum)                      # k~ (1/G_j)
    k_rem = kc.to(f32) * torch.exp(wtot - ccum)                # state update

    s = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
         if s0 is None else s0)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device),
                     0 if inclusive else -1)
    zero = torch.zeros((), dtype=f32, device=q.device)

    ys = []
    for i in range(nc):
        qd, kd, kr, wt = q_dec[i], k_dec[i], k_rem[i], wtot[i]
        vv = vc[i].to(f32)
        # inter-chunk: y_i += (q_i ⊙ E_i) S
        y_inter = torch.einsum("bhcd,bhde->bhce", qd, s)
        # intra-chunk: scores_ij = q~_i · k~_j  (masked causal)
        scores = torch.einsum("bhcd,bhkd->bhck", qd, kd)
        scores = torch.where(tri, scores, zero)
        y_intra = torch.einsum("bhck,bhke->bhce", scores, vv)
        y = y_inter + y_intra
        if u is not None and not inclusive:
            bonus = torch.einsum("bhcd,hd,bhcd->bhc", qc[i].to(f32),
                                 u.to(f32), kc[i].to(f32))
            y = y + bonus[..., None] * vv
        # state: S' = Diag(exp(wtot)) S + k_rem^T v
        s = torch.exp(wt[..., 0, :])[..., None] * s \
            + torch.einsum("bhck,bhce->bhke", kr, vv)
        ys.append(y)
    # (NC, B, H, C, dv) -> (B, T, H, dv)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, tp, h, dv)[:, :t]
    return y.to(v.dtype), s


def gla_decode_step(q, k, v, log_w, s, *, u=None, inclusive=False):
    """Single-token recurrence.  q,k: (B,H,dk); v: (B,H,dv); s: (B,H,dk,dv).
    Returns (y (B,H,dv) in v's dtype, new state f32)."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    w = torch.exp(log_w.to(f32))
    kv = kf[..., :, None] * vf[..., None, :]
    if inclusive:
        s_new = w[..., None] * s + kv
        y = torch.einsum("bhd,bhde->bhe", qf, s_new)
    else:
        eff = s + u.to(f32)[None, :, :, None] * kv if u is not None else s
        y = torch.einsum("bhd,bhde->bhe", qf, eff)
        s_new = w[..., None] * s + kv
    return y.to(v.dtype), s_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  cache: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv: x (B, T, D); w (K, D).  Returns (y, new_cache)
    with cache (B, K-1, D) carrying the last K-1 inputs for decode."""
    ksz = w.shape[0]
    if cache is None:
        cache = torch.zeros((x.shape[0], ksz - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xc = torch.cat([cache, x], dim=1)
    t = x.shape[1]
    y = xc[:, 0:t, :] * w[0]
    for i in range(1, ksz):             # the reference's left-to-right sum
        y = y + xc[:, i:i + t, :] * w[i]
    new_cache = xc[:, -(ksz - 1):, :] if ksz > 1 else cache
    return y.to(x.dtype), new_cache
