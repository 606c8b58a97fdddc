"""Assigned architecture configs the port carries so far: copies of the
JAX package's, with their smoke variants.

``get_config(name)`` / ``list_archs()`` / ``smoke_config(name)`` mirror the
JAX package's ``repro.configs``.  The port carries seven of its ten configs:
the transformer family the port's model zoo serves — ``qwen3-4b`` (whose
GEMMs also drive the ``dcim_mac`` and ``csa_tree`` kernels),
``llama3.2-3b``, ``phi3-mini-3.8b``, ``mistral-large-123b`` (246 GB of
bfloat16 weights: on one card it runs only as ``--smoke``),
``internvl2-1b`` (vlm) and ``whisper-tiny`` (audio) — and ``zamba2-1.2b``,
whose Mamba2 state sizes the ``ssm_scan`` kernel (its model comes with
ROADMAP.md queue 1, item 7, as do rwkv6-7b and the two granite MoE
configs).
"""

from __future__ import annotations

from .base import (ArchConfig, FrontendCfg, MoECfg, SSMCfg, SHAPES, ShapeCfg,
                   SUBQUADRATIC_FAMILIES, applicable_shapes)
from . import (internvl2_1b, llama32_3b, mistral_large_123b, phi3_mini_38b,
               qwen3_4b, whisper_tiny, zamba2_12b)

_MODULES = {
    "llama3.2-3b": llama32_3b,
    "qwen3-4b": qwen3_4b,
    "mistral-large-123b": mistral_large_123b,
    "phi3-mini-3.8b": phi3_mini_38b,
    "internvl2-1b": internvl2_1b,
    "zamba2-1.2b": zamba2_12b,
    "whisper-tiny": whisper_tiny,
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    return _MODULES[name].config()


def smoke_config(name: str) -> ArchConfig:
    return _MODULES[name].smoke()


__all__ = ["ArchConfig", "FrontendCfg", "MoECfg", "SSMCfg", "SHAPES",
           "ShapeCfg", "SUBQUADRATIC_FAMILIES", "applicable_shapes",
           "get_config", "smoke_config", "list_archs"]
