"""Assigned architecture configs: copies of the JAX package's ten, with
their smoke variants.

``get_config(name)`` / ``list_archs()`` / ``smoke_config(name)`` mirror the
JAX package's ``repro.configs``; every family is served by the port's model
zoo (``repro_torch.models.get_model``).  ``qwen3-4b``'s GEMMs also drive
the ``dcim_mac`` and ``csa_tree`` kernels and ``zamba2-1.2b``'s Mamba2
state sizes the ``ssm_scan`` kernel; ``mistral-large-123b`` (246 GB of
bfloat16 weights) runs on one card only as ``--smoke``.
"""

from __future__ import annotations

from .base import (ArchConfig, FrontendCfg, MoECfg, SSMCfg, SHAPES, ShapeCfg,
                   SUBQUADRATIC_FAMILIES, applicable_shapes)
from . import (granite_moe_1b, granite_moe_3b, internvl2_1b, llama32_3b,
               mistral_large_123b, phi3_mini_38b, qwen3_4b, rwkv6_7b,
               whisper_tiny, zamba2_12b)

_MODULES = {
    "llama3.2-3b": llama32_3b,
    "qwen3-4b": qwen3_4b,
    "mistral-large-123b": mistral_large_123b,
    "phi3-mini-3.8b": phi3_mini_38b,
    "internvl2-1b": internvl2_1b,
    "zamba2-1.2b": zamba2_12b,
    "rwkv6-7b": rwkv6_7b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "granite-moe-3b-a800m": granite_moe_3b,
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
