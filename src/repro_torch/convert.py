"""Carry state across from the JAX package without importing it.

The reference dataclasses (``repro.core.tech.TechModel``,
``repro.core.macro.MacroSpec``) reach the port as their plain field dicts —
``dataclasses.asdict`` of the reference object, with enum members given by
name — so a test can hand both packages the same inputs while this package
imports nothing of ``repro``.  Arrays cross as numpy: a model's parameter
tree (:func:`model_params_from_numpy`) and its decode state
(:func:`decode_state_to_numpy`, :func:`decode_state_from_numpy`); a
bfloat16 array may come as ``ml_dtypes.bfloat16`` (what ``np.asarray`` of a
JAX bfloat16 array gives) and is read bit for bit.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
from typing import Any, Mapping

import numpy as np
import torch

from .core.macro import MacroSpec
from .models.layers import dt
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


def _tensor_from_numpy(x: np.ndarray, dtype: torch.dtype,
                       device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``: an ``ml_dtypes``
    bfloat16 array bit for bit, anything else through ``torch.as_tensor``
    and a cast."""
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(x)
    return t.to(device=device, dtype=dtype)


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def model_params_from_numpy(cfg, tree: Mapping[str, Any], device=None):
    """The port's model for ``cfg`` on ``device`` (``None``: the CUDA card)
    holding the JAX package's plain parameter tree ``tree``
    (``split_logical(api.init_params(key), rules)[0]`` with its leaves as
    numpy arrays).

    The reference stacks each block's parameters on a leading ``layer``
    axis (``stack_init``); they are unstacked into ``blocks.<i>`` /
    ``enc_blocks.<i>``.  A leaf that is a linear's weight (``attn.wq``)
    lands in that module's ``w``.  Every parameter must be given once, with
    the model's shape and dtype."""
    from .models.transformer import Transformer

    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    params = dict(model.named_parameters())
    filled: set[str] = set()

    def put(name: str, value: np.ndarray) -> None:
        target = name if name in params else f"{name}.w"
        if target not in params:
            raise ValueError(f"{cfg.name}: no parameter for {name!r}")
        p = params[target]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{target}: shape {tuple(value.shape)}, the "
                             f"model's {tuple(p.shape)}")
        dtype = value.dtype.name
        if dtype != str(p.dtype).removeprefix("torch."):
            raise ValueError(f"{target}: dtype {dtype}, the model's "
                             f"{p.dtype}")
        with torch.no_grad():
            p.copy_(_tensor_from_numpy(value, p.dtype, dev))
        filled.add(target)

    for name, value in _flatten(tree):
        value = np.asarray(value)
        top, _, rest = name.partition(".")
        if top in ("blocks", "enc_blocks"):
            for i in range(value.shape[0]):
                put(f"{top}.{i}.{rest}", value[i])
        else:
            put(name, value)
    missing = sorted(set(params) - filled)
    if missing:
        raise ValueError(f"{cfg.name}: parameters not given: {missing}")
    return model


def decode_state_to_numpy(state: Mapping[str, torch.Tensor]
                          ) -> dict[str, np.ndarray]:
    """A decode state as numpy arrays, on the host: bfloat16 caches as
    float32 (exact)."""
    out = {}
    for key, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[key] = t.numpy()
    return out


def decode_state_from_numpy(cfg, tree: Mapping[str, np.ndarray],
                            device=None) -> dict[str, torch.Tensor]:
    """A decode state of ``cfg`` (the reference's plain state tree, or
    :func:`decode_state_to_numpy`'s) as the port's tensors on ``device``
    (``None``: the CUDA card): caches and ``enc_out`` in the compute dtype,
    ``pos`` int32."""
    dev = resolve_device(device)
    cd = dt(cfg.compute_dtype)
    return {key: _tensor_from_numpy(np.asarray(value),
                                    torch.int32 if key == "pos" else cd, dev)
            for key, value in tree.items()}
