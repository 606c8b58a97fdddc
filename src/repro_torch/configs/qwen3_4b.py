"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936 —
qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=9728, vocab=151_936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
