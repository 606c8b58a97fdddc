"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38 Mamba2 blocks with one *shared* attention+MLP block invoked after every
6th Mamba block (weights shared across invocations, Zamba-style).
"""

from .base import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32_000, head_dim=64,
        ssm=SSMCfg(state=64, head_dim=64, conv_kernel=4, expand=2, chunk=256),
        attn_every=6,
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="zamba2-1.2b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        ssm=SSMCfg(state=8, head_dim=16, conv_kernel=4, expand=2, chunk=32),
        attn_every=2,
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
