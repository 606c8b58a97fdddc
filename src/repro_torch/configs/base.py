"""Architecture + workload-shape configuration.

Every assigned architecture is a selectable config (``--arch <id>``); each
pairs with the four workload shape classes.  ``smoke()`` returns the reduced
same-family config used by CPU smoke tests; full configs are exercised only
through the dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    state: int = 64           # N (ssm state per head-channel)
    head_dim: int = 64        # P
    conv_kernel: int = 4
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # chunked-scan block length


@dataclass(frozen=True)
class FrontendCfg:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""

    kind: str                 # 'vision' | 'audio'
    n_tokens: int             # patches / frames after the (stubbed) frontend
    d_frontend: int           # embedding dim delivered by the stub


def finch_lora_ranks(d_model: int) -> tuple[int, int]:
    """(ddlerp rank, decay rank) of a Finch block (family ``finch``):
    RWKV-LM's ``RWKV_Tmix_x060`` rule, 32 and 64, doubled at a width of
    4,096 (Finch 7B)."""
    scale = 2 if d_model == 4096 else 1
    return 32 * scale, 64 * scale


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | finch | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # defaults to d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    attn_every: int | None = None        # hybrid: shared attn after every N ssm blocks
    encoder_layers: int = 0              # enc-dec (whisper): encoder depth
    frontend: FrontendCfg | None = None
    # DCIM quantization of linear layers (the paper's technique in the model):
    dcim_a_bits: int = 8
    dcim_w_bits: int = 8
    dcim_enabled: bool = True
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # perf knobs (hillclimbed per arch x shape; see EXPERIMENTS.md §Perf)
    act_shard: bool = False      # activation sharding constraints (§Perf it.1)
    remat: bool = True
    attn_q_block: int = 512              # blockwise-attention query tile
    attn_kv_block: int = 1024
    sharding_overrides: dict[str, Any] = field(default_factory=dict)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding-table vocab padded for even sharding (multiple of 128
        when the exact vocab doesn't divide the 16-way model axis).  Logits
        are sliced back to the exact vocab before loss/argmax."""
        if self.vocab % 16 == 0:
            return self.vocab
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------- parameters
    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * hd * n_q + 2 * d * hd * n_kv + hd * n_q * d
        dense_mlp = 3 * d * ff
        if self.family == "moe":
            mlp = self.moe.n_experts * 3 * d * self.moe.d_expert \
                + d * self.moe.n_experts
        else:
            mlp = dense_mlp
        if self.family == "ssm":        # rwkv6: time-mix + channel-mix
            tmix = 4 * d * d + d * d // 2
            cmix = 2 * d * int(self.d_ff)
            block = tmix + cmix
        elif self.family == "finch":    # rwkv6 as published
            r_mix, r_decay = finch_lora_ranks(d)
            block = 6 * d * d + 2 * d * int(self.d_ff) \
                + 10 * d * r_mix + 2 * d * r_decay
        elif self.family == "hybrid":   # mamba2 blocks + one shared attn
            di = self.d_inner
            mamba = d * (2 * di + 2 * self.ssm.state + di // self.ssm.head_dim) \
                + di * d
            block = mamba + dense_mlp // self.n_layers  # amortized shared blk
        else:
            block = attn + dense_mlp if self.family != "moe" else attn + mlp
        total = v * d * (1 if self.tie_embeddings else 2) \
            + self.n_layers * block + self.encoder_layers * (attn + dense_mlp)
        return int(total)

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count()
        all_experts = self.moe.n_experts * 3 * d * self.moe.d_expert
        active = self.moe.top_k * 3 * d * self.moe.d_expert
        return int(dense - self.n_layers * (all_experts - active))


# ---------------------------------------------------------------------------
# Workload shapes (assigned): seq_len x global_batch per class
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}

# Families with sub-quadratic long-context decode (O(1) or O(window) state).
SUBQUADRATIC_FAMILIES = ("ssm", "finch", "hybrid")


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        out.append("long_500k")
    return out
