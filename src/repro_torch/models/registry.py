"""Uniform model API over the zoo (the port of the JAX package's
``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelApi` with the reference's fields
for every family: ``dense``, ``vlm`` and ``audio``
(:mod:`~repro_torch.models.transformer`), ``moe``
(:mod:`~repro_torch.models.moe`), ``ssm`` and ``finch``
(:mod:`~repro_torch.models.rwkv6`) and ``hybrid``
(:mod:`~repro_torch.models.zamba2`).  Where the reference's
functions take a plain parameter tree, the port's take the model module
that ``init_params`` returns; ``init_params`` and ``init_decode_state``
take the device explicitly (``None``: the CUDA card).

Every model's ``forward_train`` returns (logits, aux_loss) (aux = 0 for
non-MoE).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import transformer as tfm_mod
from . import zamba2 as zamba_mod


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable          # (generator=None, device=None) -> model
    forward_train: Callable        # (model, batch) -> (logits, aux)
    prefill: Callable              # (model, tokens, cache_len, frontend) -> (logits, state)
    decode_step: Callable          # (model, state, tokens, frontend) -> (logits, state)
    init_decode_state: Callable    # (batch, cache_len, device=None) -> state


def _family(cfg: ArchConfig):
    """(model class, its module's ``init_decode_state``) of ``cfg``'s
    family."""
    if cfg.family in ("dense", "vlm", "audio"):
        return tfm_mod.Transformer, tfm_mod.init_decode_state
    if cfg.family == "moe":
        return moe_mod.MoeTransformer, tfm_mod.init_decode_state
    if cfg.family == "ssm":
        return rwkv_mod.RWKV6, rwkv_mod.init_decode_state
    if cfg.family == "finch":
        return rwkv_mod.Finch, rwkv_mod.init_decode_state
    if cfg.family == "hybrid":
        return zamba_mod.Zamba2, zamba_mod.init_decode_state
    raise ValueError(f"unknown family {cfg.family}")


def model_class(cfg: ArchConfig) -> type:
    """The model class of ``cfg``'s family: ``model_class(cfg)(cfg,
    device=...)`` builds it with uninitialised parameters."""
    return _family(cfg)[0]


def _init_params(cls, cfg, generator: torch.Generator | None, device):
    """A ``cls`` for ``cfg`` on ``device`` (``None``: the CUDA card), its
    parameters drawn from ``generator`` (default: a generator on that
    device seeded 0)."""
    model = cls(cfg, device=device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return model.init_params(generator)


def get_model(cfg: ArchConfig) -> ModelApi:
    cls, init_state = _family(cfg)
    return ModelApi(
        cfg=cfg,
        init_params=lambda generator=None, device=None:
            _init_params(cls, cfg, generator, device),
        forward_train=lambda model, batch: model.forward_train(batch),
        prefill=lambda model, tokens, cache_len, frontend=None:
            model.prefill(tokens, cache_len, frontend=frontend),
        decode_step=lambda model, state, tokens, frontend=None:
            model.decode_step(state, tokens, frontend=frontend),
        init_decode_state=lambda batch, cache_len, device=None:
            init_state(cfg, batch, cache_len, device),
    )


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Token-mean CE in f32 (logits may be bf16)."""
    lf = logits.to(torch.float32)
    mx = lf.amax(-1)
    logz = torch.log(torch.sum(torch.exp(lf - mx[..., None]), -1)) + mx
    gold = torch.take_along_dim(lf, labels[..., None].long(), -1)[..., 0]
    return torch.mean(logz - gold)
