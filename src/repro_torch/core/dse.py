"""System-level workload description: the GEMM inventory of an assigned
model architecture, the workload the compiler's macros execute (the paper's
§I framing).

This slice of the port carries :class:`GemmShape` and
:func:`gemm_inventory`, which give the ``dcim_mac`` kernel its shapes; the
macro-array mapping and co-design reports of the JAX package's
``repro.core.dse`` come with the selection slice.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GemmShape:
    """One GEMM in a model: out[m, n] += a[m, k] @ w[k, n], executed
    ``count`` times per model step."""

    name: str
    m: int
    k: int
    n: int
    count: int = 1

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count


def gemm_inventory(cfg, seq: int = 256) -> list[GemmShape]:
    """Model-zoo GEMM inventory: the per-token-batch weight-side GEMMs of one
    decoder layer x n_layers for an assigned architecture config (attention
    score/value matmuls are activation-activation and stay outside the
    weight-stationary CIM mapping).  This is the workload description the
    co-design sweep and serving-time macro selection map onto macro arrays."""
    d, hd = cfg.d_model, cfg.hd
    gs = [
        GemmShape("wq", seq, d, cfg.n_heads * hd, cfg.n_layers),
        GemmShape("wk", seq, d, cfg.n_kv_heads * hd, cfg.n_layers),
        GemmShape("wv", seq, d, cfg.n_kv_heads * hd, cfg.n_layers),
        GemmShape("wo", seq, cfg.n_heads * hd, d, cfg.n_layers),
    ]
    if cfg.family == "moe":
        e_active = cfg.moe.top_k
        gs += [GemmShape("moe_up", seq, d, 2 * cfg.moe.d_expert,
                         cfg.n_layers * e_active),
               GemmShape("moe_down", seq, cfg.moe.d_expert, d,
                         cfg.n_layers * e_active)]
    else:
        gs += [GemmShape("mlp_up", seq, d, 2 * cfg.d_ff, cfg.n_layers),
               GemmShape("mlp_down", seq, cfg.d_ff, d, cfg.n_layers)]
    return gs
