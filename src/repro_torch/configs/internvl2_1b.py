"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 —
InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The ViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (256 tokens of d_frontend) which a learned
projector maps into the LM embedding space.
"""

from .base import ArchConfig, FrontendCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab=151_655, head_dim=64,
        rope_theta=1_000_000.0,
        frontend=FrontendCfg(kind="vision", n_tokens=256, d_frontend=1024),
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="internvl2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        frontend=FrontendCfg(kind="vision", n_tokens=8, d_frontend=32),
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
