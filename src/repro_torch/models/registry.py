"""Uniform model API over the zoo (the port of the JAX package's
``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelApi` with the reference's fields.
Where the reference's functions take a plain parameter tree, the port's take
the model module (:class:`repro_torch.models.transformer.Transformer`) that
``init_params`` returns; ``init_params`` and ``init_decode_state`` take the
device explicitly (``None``: the CUDA card).

forward_train returns (logits, aux_loss) uniformly (aux = 0 for non-MoE).

The port carries the transformer family (``dense``, ``vlm``, ``audio``).
The ``moe``, ``ssm`` and ``hybrid`` families raise ``NotImplementedError``:
they come with ROADMAP.md queue 1, item 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from . import transformer as tfm_mod


@dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init_params: Callable          # (generator=None, device=None) -> model
    forward_train: Callable        # (model, batch) -> (logits, aux)
    prefill: Callable              # (model, tokens, cache_len, frontend) -> (logits, state)
    decode_step: Callable          # (model, state, tokens, frontend) -> (logits, state)
    init_decode_state: Callable    # (batch, cache_len, device=None) -> state


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: it "
            "comes with ROADMAP.md queue 1, item 7 (moe.py, ssm.py + "
            "rwkv6.py, zamba2.py)")
    if cfg.family not in ("dense", "vlm", "audio"):
        raise ValueError(f"unknown family {cfg.family}")
    return ModelApi(
        cfg=cfg,
        init_params=lambda generator=None, device=None:
            tfm_mod.init_params(cfg, generator, device=device),
        forward_train=lambda model, batch: (
            model.forward_train(batch),
            torch.zeros((), dtype=torch.float32, device=model.device)),
        prefill=lambda model, tokens, cache_len, frontend=None:
            model.prefill(tokens, cache_len, frontend=frontend),
        decode_step=lambda model, state, tokens, frontend=None:
            model.decode_step(state, tokens, frontend=frontend),
        init_decode_state=lambda batch, cache_len, device=None:
            tfm_mod.init_decode_state(cfg, batch, cache_len, device),
    )


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Token-mean CE in f32 (logits may be bf16)."""
    lf = logits.to(torch.float32)
    mx = lf.amax(-1)
    logz = torch.log(torch.sum(torch.exp(lf - mx[..., None]), -1)) + mx
    gold = torch.take_along_dim(lf, labels[..., None].long(), -1)[..., 0]
    return torch.mean(logz - gold)
