"""The train step: loss -> gradients -> AdamW, with optional gradient
microbatching (the port of the JAX package's ``repro/train/step.py``), on
one device or over a mesh of ranks.

The step keeps the reference's contract, ``(model, opt_state, batch) ->
(model, opt_state, metrics)``: the model is the port's module, updated in
place with its AdamW state (where the reference donates them), and the
batch a dict of numpy arrays or tensors that the step moves to the model's
device.  ``metrics`` holds 0-d tensors: ``loss``, ``ce``, ``aux``,
``grad_norm`` and ``lr``.

With ``microbatches > 1`` the batch splits on its leading axis; each
microbatch's gradients are cast to float32, divided by ``microbatches`` and
added, the loss is summed as ``loss / microbatches``, and ``ce`` / ``aux``
are the last microbatch's, in the reference's order.  Autograd's own
accumulation into ``.grad`` is not used: it would sum in the parameter
dtype.  With one microbatch the gradients stay in the parameter dtype until
AdamW casts them.

Over a mesh (``mesh=``, a ``DeviceMesh`` over every rank of the process
group), the model's parameters and the AdamW moments are DTensors placed
by the logical rules (:func:`repro_torch.parallel.zero.shard_model`) and
each weight is gathered whole just before use.  The step still takes the
**global** batch: microbatch ``i`` is rows ``[i*mb, (i+1)*mb)`` of it, as
in the one-device step, and those rows split evenly over the batch ranks
(the mesh axes the rules give ``batch``), so each rank runs its share of
every microbatch, the way GSPMD shards each microbatch of the reference.
Gradients are averaged over the batch ranks as they are reduced onto the
shards; the reported ``loss`` and ``ce`` are averaged over them too, and
a MoE model's ``aux`` is the global one
(:mod:`repro_torch.models.moe`).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..convert import reference_leaf_rank
from ..models.registry import ModelApi, cross_entropy_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..parallel.sharding import (activation_rules, reset_activation_rules,
                                 rules_for_mesh)
from ..parallel.zero import (batch_axes, data_parallel, dp_mean, dp_rank,
                             dp_size, like, local)

AUX_COEF = 0.01     # MoE load-balance loss weight


def make_loss_fn(api: ModelApi) -> Callable:
    def loss_fn(model, batch):
        logits, aux = api.forward_train(model, batch)
        ce = cross_entropy_loss(logits, batch["labels"])
        return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}
    return loss_fn


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A batch entry on ``device``: integer token ids as int64, floats as
    they are."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if not t.is_floating_point():
        t = t.to(torch.int64)
    return t.to(device)


def make_train_step(api: ModelApi, lr_schedule: Callable,
                    adamw_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1, mesh=None) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics) (module doc)."""
    loss_fn = make_loss_fn(api)
    n_mb = max(microbatches, 1)
    rules = axes = None
    n_dp, r_dp = 1, 0
    if mesh is not None:
        rules = rules_for_mesh(mesh, api.cfg.sharding_overrides)
        axes = batch_axes(mesh, rules)
        n_dp, r_dp = dp_size(mesh, axes), dp_rank(mesh, axes)

    def rows(batch, i):
        """This rank's rows of microbatch ``i``."""
        b = next(iter(batch.values())).shape[0]
        mb = b // n_mb
        if mb % n_dp:
            raise ValueError(f"a microbatch of {mb} rows does not split "
                             f"over {n_dp} batch ranks")
        per = mb // n_dp
        lo = i * mb + r_dp * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def grads_of(model, params, batch):
        loss, aux = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                grads)

    def compute_grads(model, params, batch):
        if microbatches <= 1:
            return grads_of(model, params, rows(batch, 0))
        div = torch.tensor(microbatches, dtype=torch.float32,
                           device=model.device)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = {name: (like(p, torch.float32) if mesh is not None else
                      torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device))
               for name, p in params.items()}
        for i in range(microbatches):
            l_i, aux, grads = grads_of(model, params, rows(batch, i))
            for name, g in grads.items():
                local(acc[name]).add_(local(g).to(torch.float32) / div)
            del grads
            loss = loss + l_i / div
        return loss, aux, acc

    def train_step(model, opt_state, batch):
        dev = model.device
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        params = dict(model.named_parameters())
        decay = {name: reference_leaf_rank(name, p.ndim) >= 2
                 for name, p in params.items()}
        if mesh is None:
            loss, aux, grads = compute_grads(model, params, batch)
        else:
            if not all(hasattr(p, "device_mesh") for p in params.values()):
                raise ValueError("a step over a mesh needs the model's "
                                 "parameters placed on it (shard_model)")
            token = activation_rules(rules if api.cfg.act_shard else None)
            try:
                with data_parallel(mesh, axes):
                    loss, aux, grads = compute_grads(model, params, batch)
                    loss = dp_mean(loss)
                    aux = {k: dp_mean(v) if k == "ce" else v
                           for k, v in aux.items()}
            finally:
                reset_activation_rules(token)
        lr = lr_schedule(opt_state["count"])
        _, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                        adamw_cfg, decay=decay)
        metrics = {"loss": loss, **aux, **om}
        return model, opt_state, metrics

    return train_step


def init_train_state(api: ModelApi, generator: torch.Generator | None = None,
                     device=None, mesh=None) -> tuple[Any, dict]:
    """A model drawn on ``device`` (``None``: the CUDA card; ``generator``
    defaults to one seeded 0 there) and its zero AdamW state.  With a
    ``mesh`` the parameters are placed on it by the logical rules, each
    rank keeping its pieces of the one-device draw
    (:func:`repro_torch.parallel.zero.shard_model`)."""
    if mesh is None:
        model = api.init_params(generator, device=device)
    else:
        from ..device import resolve_device
        from ..models import model_class
        from ..parallel.zero import shard_model

        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model = shard_model(model_class(api.cfg)(api.cfg, device="meta"),
                            mesh,
                            rules_for_mesh(mesh, api.cfg.sharding_overrides),
                            generator=generator, device=dev)
    return model, adamw_init(dict(model.named_parameters()))
