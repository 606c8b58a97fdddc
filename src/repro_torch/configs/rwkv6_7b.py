"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf]"""

from .base import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14_336, vocab=65_536, head_dim=64,
        ssm=SSMCfg(state=64, head_dim=64, chunk=256),
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="rwkv6-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        ssm=SSMCfg(state=16, head_dim=16, chunk=32),
        param_dtype="float32", compute_dtype="float32",
    )
