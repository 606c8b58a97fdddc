"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49_155, head_dim=64,
        rope_theta=10_000.0, tie_embeddings=True,
        moe=MoECfg(n_experts=32, top_k=8, d_expert=512),
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="granite-moe-1b-a400m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab=256, head_dim=16,
        moe=MoECfg(n_experts=4, top_k=2, d_expert=32),
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
