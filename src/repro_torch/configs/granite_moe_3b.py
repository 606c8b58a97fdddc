"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49_155, head_dim=64,
        rope_theta=10_000.0, tie_embeddings=True,
        moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
        # 40 experts % 16-way model axis != 0: run experts replicated with
        # per-expert TP (d_model over 'data', d_expert over 'model') instead
        # of expert-parallel dispatch (granite-1b keeps true EP with 32e).
        sharding_overrides={"experts": None, "expert_ff": "model"},
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="granite-moe-3b-a800m-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=32, vocab=256, head_dim=16,
        moe=MoECfg(n_experts=4, top_k=2, d_expert=32),
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
