"""Assigned architecture configs the port carries so far.

``get_config(name)`` / ``list_archs()`` mirror the JAX package's
``repro.configs``; the port carries ``qwen3-4b``, whose GEMMs drive the
``dcim_mac`` and ``csa_tree`` kernels, and ``zamba2-1.2b``, whose Mamba2
state sizes the ``ssm_scan`` kernel.
"""

from __future__ import annotations

from .base import (ArchConfig, FrontendCfg, MoECfg, SSMCfg, SHAPES, ShapeCfg,
                   SUBQUADRATIC_FAMILIES, applicable_shapes)
from . import qwen3_4b, zamba2_12b

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "zamba2-1.2b": zamba2_12b,
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
