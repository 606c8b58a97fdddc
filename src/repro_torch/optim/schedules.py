"""Learning-rate schedules: pure functions of the step counter (the port of
the JAX package's ``repro/optim/schedules.py``).

Each schedule takes the step as a 0-d integer tensor (an optimizer state's
``count``) or a Python int and returns a 0-d float32 tensor on the step's
device (the CPU for an int).
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def constant_lr(lr: float):
    return lambda step: _f32(lr, _step(step))


def cosine_schedule(peak: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        step = _step(step)
        t = torch.clamp(step.to(torch.float32)
                        / _f32(max(1, total_steps), step), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(_f32(math.pi, step) * t))
        return _f32(peak, step) * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak, max(1, total_steps - warmup), final_frac)

    def f(step):
        step = _step(step)
        warm = _f32(peak, step) * torch.clamp(
            step.to(torch.float32) / _f32(max(1, warmup), step), max=1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return f
