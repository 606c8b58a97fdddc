"""What one decode step of the ``rwkv6`` family (RWKV-6 Finch as
published) needs, from the configuration's shapes alone, whatever
implements it.

FLOPs: 2 x the parameters each token uses (per block the time-mix's five
projections r, k, v, g, o and the channel-mix's three; the ddlerp LoRA,
``d x 5 r`` and ``5 r x d``; the decay LoRA, ``d x r_w`` and ``r_w x d``;
the unembedding) plus, per block and head, the WKV's 5 x dk x dv: decay,
outer product, bonus, readout multiply and add.  The LoRA ranks are
RWKV-LM's ``RWKV_Tmix_x060`` rule: 32 and 64, doubled at a width of 4,096.
Bytes: every weight read once at its dtype, each block's float32 WKV state
and both token shifts read once and written once, the logits written
once.  No attention: the step is the same at any context length.
"""

from __future__ import annotations

from .common import DTYPE_BYTES


def lora_ranks(d: int) -> tuple[int, int]:
    scale = 2 if d == 4096 else 1
    return 32 * scale, 64 * scale


def _sizes(p: dict) -> dict:
    d, ff = p["d_model"], p["d_ff"]
    r_mix, r_decay = lora_ranks(d)
    return {"proj": 6 * d * d + 2 * d * ff,
            "lora": 10 * d * r_mix + 2 * d * r_decay,
            # ddlerp's six and the channel-mix's two lerps, w0, u, and the
            # gains and biases of ln1, ln2 and ln_x
            "vectors": 16 * d,
            "state": p["n_heads"] * p["head_dim"] ** 2}


def weight_bytes(p: dict) -> int:
    w = DTYPE_BYTES[p["param_dtype"]]
    z, d = _sizes(p), p["d_model"]
    return p["n_layers"] * ((z["proj"] + z["lora"]) * w + z["vectors"] * 4) \
        + 2 * p["vocab"] * d * w + 4 * d * 4          # ln0 and ln_f


def decode_step(p: dict, batch: int, filled: int) -> dict:
    """FLOPs and bytes of one decode step of ``batch`` sequences
    (``filled`` does not matter: the state is the same size at any
    length)."""
    z, L = _sizes(p), p["n_layers"]
    per_token = 2 * (L * (z["proj"] + z["lora"]) + p["vocab"] * p["d_model"]) \
        + L * 5 * z["state"]
    c = DTYPE_BYTES[p["compute_dtype"]]
    per_seq = L * (2 * z["state"] * 4 + 2 * 2 * p["d_model"] * c) \
        + p["vocab"] * c
    return {"flops": batch * per_token,
            "bytes": weight_bytes(p) + batch * per_seq}
