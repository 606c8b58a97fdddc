"""Meta-tensor stand-ins and shardings for every (arch x shape) cell (the
port of the JAX package's ``repro/launch/specs.py``).

Each function returns trees in the reference's layout (nested dicts, the
blocks' leaves stacked on a ``layer`` axis) of meta tensors, the
counterpart of ``jax.ShapeDtypeStruct``: nothing is allocated, so every
full-width config is covered, mistral-large-123b included.  A sharding is
a :class:`Sharding`, the mesh beside the spec (a tuple with one entry per
dimension, the reference's ``PartitionSpec``), the counterpart of
``NamedSharding``; the mesh may be a ``DeviceMesh`` or anything with axis
names (the rules read only those).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..models.registry import ModelApi
from ..parallel.logical import Logical, logical_tree, split_logical


class Sharding(NamedTuple):
    mesh: Any
    spec: tuple


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def train_batch_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32),
             "labels": sds((b, s), torch.int32)}
    if cfg.frontend is not None:
        batch["frontend"] = sds((b, cfg.frontend.n_tokens,
                                 cfg.frontend.d_frontend), torch.float32)
    return batch


def batch_shardings(cfg: ArchConfig, batch, mesh, rules) -> dict:
    bspec = rules.get("batch")
    return _map(lambda x: Sharding(mesh, (bspec,) + (None,) * (x.ndim - 1)),
                batch)


def abstract_params(api: ModelApi, mesh, rules):
    """(meta tree, Sharding tree) for the model's parameters."""
    from ..models import model_class

    model = model_class(api.cfg)(api.cfg, device="meta")
    vals, specs = split_logical(logical_tree(model), rules)
    return vals, _map(lambda sp: Sharding(mesh, sp), specs)


def abstract_opt_state(params_sds, param_shardings, mesh):
    """AdamW ``m`` / ``v`` mirror the parameters (float32); ``count``
    replicated."""
    f32 = lambda p: sds(p.shape, torch.float32)  # noqa: E731
    return (
        {"m": _map(f32, params_sds), "v": _map(f32, params_sds),
         "count": sds((), torch.int32)},
        {"m": param_shardings, "v": param_shardings,
         "count": Sharding(mesh, ())},
    )


# the logical axes of every decode-state entry of the zoo's families
DECODE_AXES: dict[str, tuple] = {
    "k": ("layer", "batch", "kv_seq", "cache_heads", None),
    "v": ("layer", "batch", "kv_seq", "cache_heads", None),
    "pos": (),
    "enc_out": ("batch", None, "act_embed"),
    "shift_t": ("layer", "batch", "act_embed"),
    "shift_c": ("layer", "batch", "act_embed"),
    "wkv": ("layer", "batch", "act_heads", None, None),
    "conv": ("layer", "batch", None, "act_ff"),
    "ssd": ("layer", "batch", "act_heads", None, None),
}


def abstract_decode_state(api: ModelApi, shape: ShapeCfg, mesh, rules):
    """(meta tree, Sharding tree) for the serve state: a KV cache of
    ``seq_len`` (one new token against a cache of seq_len)."""
    b, s = shape.global_batch, shape.seq_len
    state = api.init_decode_state(b, s, device="meta")
    ltree = {k: Logical(v, DECODE_AXES[k]) for k, v in state.items()}
    vals, specs = split_logical(ltree, rules)
    return vals, _map(lambda sp: Sharding(mesh, sp), specs)


def decode_token_specs(cfg: ArchConfig, shape: ShapeCfg, mesh, rules):
    toks = sds((shape.global_batch, 1), torch.int32)
    return toks, Sharding(mesh, (rules.get("batch"), None))


def prefill_token_specs(cfg: ArchConfig, shape: ShapeCfg, mesh, rules):
    toks = sds((shape.global_batch, shape.seq_len), torch.int32)
    return toks, Sharding(mesh, (rules.get("batch"), None))
