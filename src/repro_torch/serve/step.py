"""Serving steps: prefill + cached decode (the port of the JAX package's
``repro/serve/step.py``).

The reference jits both and donates the decode state (in-place KV-cache
update on device); here both run eagerly under ``torch.no_grad`` and decode
writes the caches in place (:meth:`repro_torch.models.transformer.
Transformer.decode_step`), so the cache is never double-buffered either.

Each prefill and decode call is the root of a trace, ``serve.prefill`` /
``serve.decode_step``, tagged with the model's name and the batch, over
the models' layer spans (:mod:`repro_torch.obs`); it records only while
tracing is on or a profiler records.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.registry import ModelApi
from ..obs import tracer


def _root(name: str, api: ModelApi, tokens: torch.Tensor):
    """The step's trace root (a no-op while tracing is off)."""
    span = tracer.start_trace(name)
    if span:
        span.set_tag("model", api.cfg.name)
        span.set_tag("batch", tokens.shape[0])
    return span


def make_prefill(api: ModelApi, cache_len: int) -> Callable:
    def prefill(model, tokens, frontend=None):
        with _root("serve.prefill", api, tokens):
            return api.prefill(model, tokens, cache_len, frontend=frontend)
    return prefill


def make_decode_step(api: ModelApi) -> Callable:
    def decode_step(model, state, tokens):
        with _root("serve.decode_step", api, tokens):
            return api.decode_step(model, state, tokens)
    return decode_step


def greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The last position's greedy token per row, (B, 1): the first maximal
    index, as ``jnp.argmax`` takes it."""
    return torch.argmax(logits[:, -1:], dim=-1)


def greedy_generate(api: ModelApi, model, prompt_tokens: torch.Tensor,
                    n_steps: int, cache_len: int | None = None,
                    frontend=None) -> torch.Tensor:
    """Host-side loop: prefill the prompt then greedy-decode ``n_steps``
    tokens, (B, n_steps) on the model's device."""
    b, s = prompt_tokens.shape
    cache_len = cache_len or (s + n_steps)
    prefill = make_prefill(api, cache_len)
    decode = make_decode_step(api)
    logits, state = prefill(model, prompt_tokens, frontend)
    tok = greedy_argmax(logits)
    out = [tok]
    for _ in range(n_steps - 1):
        logits, state = decode(model, state, tok)
        tok = greedy_argmax(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
