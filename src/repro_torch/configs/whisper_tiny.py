"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865 —
enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (1500 frames x d_frontend = 2x-downsampled
mel-conv output) consumed by the transformer encoder; the decoder follows the
workload shape class.
"""

from .base import ArchConfig, FrontendCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51_865, head_dim=64,
        encoder_layers=4,
        frontend=FrontendCfg(kind="audio", n_tokens=1500, d_frontend=384),
    )


def smoke() -> ArchConfig:
    return config().replace(
        name="whisper-tiny-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, head_dim=16, encoder_layers=2,
        frontend=FrontendCfg(kind="audio", n_tokens=32, d_frontend=64),
        param_dtype="float32", compute_dtype="float32",
        attn_q_block=32, attn_kv_block=64,
    )
