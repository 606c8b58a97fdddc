"""What one decode step of the ``hybrid`` family (Mamba2 blocks and one
shared attention block) needs, from the configuration's shapes alone,
whatever implements it.

FLOPs: 2 x the parameters each token uses (every Mamba2 block's
projections, the shared block once per run of it, the unembedding), the
depthwise conv (2 x taps x channels), the SSD state update and readout
(5 x heads x state x head size: decay, outer product and add, then the
readout's multiply-add) and attention over the filled positions at every
run of the shared block.  Bytes: every weight read once at its dtype (the
shared block once), each block's SSD state and conv window read once and
written once, the KV entries already cached read once and the new ones
written once, the logits written once.
"""

from __future__ import annotations

from .common import DTYPE_BYTES


def _sizes(p: dict) -> dict:
    d, s = p["d_model"], p["ssm"]
    di = s["expand"] * d
    heads = di // s["head_dim"]
    conv_dim = di + 2 * s["state"]
    mamba = d * (2 * di + 2 * s["state"] + heads) + di * d
    shared = 4 * d * p["n_heads"] * p["head_dim"] + 3 * d * p["d_ff"]
    runs = -(-p["n_layers"] // p["attn_every"])
    return {"di": di, "heads": heads, "conv_dim": conv_dim, "mamba": mamba,
            "shared": shared, "runs": runs,
            "state": heads * s["state"] * s["head_dim"]}


def weight_bytes(p: dict) -> int:
    w = DTYPE_BYTES[p["param_dtype"]]
    z = _sizes(p)
    d, s = p["d_model"], p["ssm"]
    mamba_f32 = s["conv_kernel"] * z["conv_dim"] + 3 * z["heads"] \
        + d + z["di"]                           # conv, A_log/dt_bias/D, gains
    return p["n_layers"] * (z["mamba"] * w + mamba_f32 * 4) \
        + z["shared"] * w + 2 * d * 4 \
        + 2 * p["vocab"] * d * w + d * 4


def decode_step(p: dict, batch: int, filled: int) -> dict:
    """FLOPs and bytes of one decode step of ``batch`` sequences whose new
    token attends ``filled`` positions at each run of the shared block."""
    z = _sizes(p)
    L, s = p["n_layers"], p["ssm"]
    hq, hd = p["n_heads"], p["head_dim"]
    per_token = 2 * (L * z["mamba"] + z["runs"] * z["shared"]
                     + p["vocab"] * p["d_model"]) \
        + L * (2 * s["conv_kernel"] * z["conv_dim"] + 5 * z["state"]) \
        + z["runs"] * 4 * hq * hd * filled
    c = DTYPE_BYTES[p["compute_dtype"]]
    state = L * (2 * z["state"] * 4
                 + 2 * (s["conv_kernel"] - 1) * z["conv_dim"] * c)
    kv_entry = z["runs"] * 2 * p["n_kv_heads"] * hd * c
    nbytes = weight_bytes(p) + batch * (state + kv_entry * filled
                                        + p["vocab"] * c)
    return {"flops": batch * per_token, "bytes": nbytes}
