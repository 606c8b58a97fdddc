"""The train step: loss -> gradients -> AdamW, with optional gradient
microbatching (the port of the JAX package's ``repro/train/step.py``, on
one device; the int8 gradient compression across hosts waits for
ROADMAP.md queue 1, item 8c).

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
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..convert import reference_leaf_rank
from ..models.registry import ModelApi, cross_entropy_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update

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
                    microbatches: int = 1) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics) (module doc)."""
    loss_fn = make_loss_fn(api)

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
            return grads_of(model, params, batch)
        b = next(iter(batch.values())).shape[0]
        mb = b // microbatches
        div = torch.tensor(microbatches, dtype=torch.float32,
                           device=model.device)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = {name: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
               for name, p in params.items()}
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l_i, aux, grads = grads_of(model, params, part)
            for name, g in grads.items():
                acc[name].add_(g.to(torch.float32) / div)
            del grads
            loss = loss + l_i / div
        return loss, aux, acc

    def train_step(model, opt_state, batch):
        dev = model.device
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        params = dict(model.named_parameters())
        decay = {name: reference_leaf_rank(name, p.ndim) >= 2
                 for name, p in params.items()}
        loss, aux, grads = compute_grads(model, params, batch)
        lr = lr_schedule(opt_state["count"])
        _, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                        adamw_cfg, decay=decay)
        metrics = {"loss": loss, **aux, **om}
        return model, opt_state, metrics

    return train_step


def init_train_state(api: ModelApi, generator: torch.Generator | None = None,
                     device=None) -> tuple[Any, dict]:
    """A model drawn on ``device`` (``None``: the CUDA card; ``generator``
    defaults to one seeded 0 there) and its zero AdamW state."""
    model = api.init_params(generator, device=device)
    return model, adamw_init(dict(model.named_parameters()))
