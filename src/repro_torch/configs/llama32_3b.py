"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128_256, head_dim=128,
        rope_theta=500_000.0, tie_embeddings=True,
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="llama3.2-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
