"""Carry state across from the JAX package without importing it.

The reference dataclasses (``repro.core.tech.TechModel``,
``repro.core.macro.MacroSpec``) reach the port as their plain field dicts —
``dataclasses.asdict`` of the reference object, with enum members given by
name — so a test can hand both packages the same inputs while this package
imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Mapping

import numpy as np
import torch

from .core.macro import MacroSpec
from .core.tech import TechModel
from .device import resolve_device


def _field_value(value: Any, kind: Any) -> Any:
    if isinstance(kind, type) and issubclass(kind, enum.Enum):
        return value if isinstance(value, kind) else kind[value]
    if isinstance(value, list):
        return tuple(value)
    return value


def _from_fields(cls, d: Mapping[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    return cls(**{k: _field_value(v, hints[k]) for k, v in d.items()})


def tech_from_fields(d: Mapping[str, Any]) -> TechModel:
    """The port's :class:`TechModel` from the reference's field dict."""
    return _from_fields(TechModel, d)


def spec_from_fields(d: Mapping[str, Any]) -> MacroSpec:
    """The port's :class:`MacroSpec` from the reference's field dict."""
    return _from_fields(MacroSpec, d)


def mac_operands_from_numpy(a_q: np.ndarray, w_q: np.ndarray,
                            a_scale: np.ndarray, w_scale: np.ndarray,
                            device=None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """numpy int8 operands and float32 scales as the port's tensors on
    ``device`` (``None``: the CUDA card): ``(a_q, w_q, a_scale, w_scale)``
    with int8 operands and float32 scales, contiguous."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    return (put(a_q, torch.int8), put(w_q, torch.int8),
            put(a_scale, torch.float32), put(w_scale, torch.float32))


def csa_operands_from_numpy(operands: np.ndarray, device=None
                            ) -> torch.Tensor:
    """An (H, N) numpy operand stack as the port's contiguous int32 tensor
    on ``device`` (``None``: the CUDA card).  Values must fit in int32."""
    x = np.ascontiguousarray(operands)
    if x.dtype != np.int32:
        if x.size and (x.min() < -2 ** 31 or x.max() >= 2 ** 31):
            raise ValueError("operand values do not fit in int32")
        x = x.astype(np.int32)
    return torch.as_tensor(x, device=resolve_device(device))


def ssm_operands_from_numpy(a: np.ndarray, b: np.ndarray, h0: np.ndarray,
                            device=None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """numpy ``a``, ``b`` (T, D) and ``h0`` (D,) as the port's contiguous
    float32 tensors on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                                 device=dev) for x in (a, b, h0))
