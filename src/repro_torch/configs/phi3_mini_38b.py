"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32_064, head_dim=96,
        rope_theta=10_000.0,
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="phi3-mini-3.8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
