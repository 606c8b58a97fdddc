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

On a mesh of ranks the parameters, gradients and moments are DTensors of
one placement per parameter (the moments mirror the parameters' specs,
:func:`opt_specs_like`; ``count`` is replicated).  The update is
elementwise, so each rank updates its own pieces; :func:`global_norm`
sums the squares over the ranks, so the clip factor is the one-device
one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from ..parallel import collectives as C
from ..parallel.zero import like, local as _local


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    if _is_dtensor(p):
        return like(p, torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    """Zero float32 moments beside each parameter (DTensors of its
    placements for a DTensor parameter) and an int32 ``count``, on the
    parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: _zeros_f32(p) for k, p in params.items()},
        "v": {k: _zeros_f32(p) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def opt_specs_like(param_specs):
    """Specs for the optimizer state mirroring the parameters' specs; the
    step ``count`` replicated."""
    return {"m": param_specs, "v": param_specs, "count": ()}


def _counted_here(t) -> bool:
    """Whether this rank's piece of DTensor ``t`` is the one that counts
    for the global norm: along every mesh axis that does not shard ``t``,
    the ranks hold the same piece, and only the first counts it."""
    mesh = t.device_mesh
    return all(pl.is_shard() or mesh.get_local_rank(i) == 0
               for i, pl in enumerate(t.placements))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's squares, leaf by leaf in the
    mapping's order.  For DTensor leaves each rank sums its own pieces
    (a piece that several ranks hold counted once) and the sum is
    all-reduced over the mesh: the norm of the whole tensors."""
    total = None
    mesh = None
    for leaf in tree.values():
        sq = torch.sum(torch.square(_local(leaf).to(torch.float32)))
        if _is_dtensor(leaf):
            mesh = leaf.device_mesh
            if not _counted_here(leaf):
                sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    if mesh is not None:
        for i in range(mesh.ndim):
            C.all_reduce(total, mesh.get_group(i), "sum")
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
    for name, param in params.items():
        p = _local(param)
        m, v = _local(opt_state["m"][name]), _local(opt_state["v"][name])
        g = _local(grads[name]).to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)             # b1 m + (1-b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if (param.ndim >= 2) if decay is None else decay[name]:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    opt_state["count"] = count
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
