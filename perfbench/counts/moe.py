"""What one decode step of the ``moe`` family needs, from the
configuration's shapes alone, whatever implements it.

FLOPs: 2 x the parameters each token uses (attention projections, the
router, its ``top_k`` experts, the unembedding) plus attention over the
filled positions (2 x 2 x heads x head size each).  Bytes: every weight
read once at its dtype (all experts: a batch routes to each of them), the
KV entries already cached read once, the new ones written once, the
logits written once.  Capacity slots, padding and dropped tokens are not
counted: they are not needed.
"""

from __future__ import annotations

from .common import DTYPE_BYTES


def _per_layer(p: dict) -> dict:
    d, hd = p["d_model"], p["head_dim"]
    m = p["moe"]
    attn = d * hd * (2 * p["n_heads"] + 2 * p["n_kv_heads"])
    expert = 3 * d * m["d_expert"]
    return {"attn": attn, "router": d * m["n_experts"], "expert": expert}


def weight_bytes(p: dict) -> int:
    w = DTYPE_BYTES[p["param_dtype"]]
    layer = _per_layer(p)
    per = (layer["attn"] + layer["router"]
           + p["moe"]["n_experts"] * layer["expert"]) * w \
        + 2 * p["d_model"] * 4                       # the two norm gains
    return p["n_layers"] * per + p["vocab"] * p["d_model"] * w \
        + p["d_model"] * 4


def decode_step(p: dict, batch: int, filled: int) -> dict:
    """FLOPs and bytes of one decode step of ``batch`` sequences whose new
    token attends ``filled`` positions (itself included)."""
    layer = _per_layer(p)
    active = layer["attn"] + layer["router"] + p["moe"]["top_k"] \
        * layer["expert"]
    hd, L = p["head_dim"], p["n_layers"]
    flops = 2 * batch * (L * active + p["vocab"] * p["d_model"]) \
        + 4 * batch * L * p["n_heads"] * hd * filled
    c = DTYPE_BYTES[p["compute_dtype"]]
    kv_entry = 2 * L * p["n_kv_heads"] * hd * c      # K and V, every layer
    nbytes = weight_bytes(p) + batch * kv_entry * filled \
        + batch * p["vocab"] * c
    return {"flops": flops, "bytes": nbytes}
