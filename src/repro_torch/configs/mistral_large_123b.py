"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""

from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12_288, n_heads=96, n_kv_heads=8,
        d_ff=28_672, vocab=32_768, head_dim=128,
        rope_theta=1_000_000.0,
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="mistral-large-123b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=192, vocab=256, head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
