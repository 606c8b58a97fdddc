"""AdamW over a model's parameter tensors (the port of the JAX package's
``repro/optim/adamw.py``).

Moments are float32 whatever the parameter dtype (bf16 parameters with
float32 ``m`` / ``v``).  The arithmetic is the reference's, in its order:
the clip scale from the global norm, ``m``, ``v``, the bias corrections
``1 - b ** count``, ``mhat / (sqrt(vhat) + eps)``, the decay, then the cast
back to the parameter's dtype.  ``torch.optim.AdamW`` is not used: its
update is ordered otherwise and would not follow the reference's numbers.

Parameters, gradients and moments are mappings from a parameter's name to
its tensor (``dict(model.named_parameters())``), in one order.  The
reference decays a leaf of rank 2 or more; its blocks' parameters are
stacked on a layer axis, so a per-layer norm gain there has rank 2 and
decays.  ``adamw_update`` takes that decision per name (``decay``); the
port's unstacked names get it from
:func:`repro_torch.convert.reference_leaf_rank`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero float32 moments beside each parameter and an int32 ``count``,
    on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's squares, leaf by leaf in the
    mapping's order."""
    total = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-d float32 tensor on ``like``'s device (a
    division by it stays a true division on CUDA)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Mapping[str, torch.Tensor], lr: torch.Tensor,
                 cfg: AdamWConfig = AdamWConfig(),
                 decay: Mapping[str, bool] | None = None):
    """One AdamW step: returns (params, opt_state, metrics).

    The parameters and the moments ``m`` / ``v`` are written in place (the
    reference donates them) and returned; the state's ``count`` becomes
    ``count + 1``.  ``decay[name]`` says
    whether a parameter takes weight decay (default: rank 2 or more, the
    reference's rule on an unstacked tree).  ``metrics`` holds the raw
    ``grad_norm`` and ``lr``."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    countf = count.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, count), countf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, count), countf)
    eps = _f32(cfg.eps, count)
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)             # b1 m + (1-b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if (p.ndim >= 2) if decay is None else decay[name]:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
