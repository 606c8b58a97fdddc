"""Optimizer and learning-rate schedules of the port (the JAX package's
``repro.optim`` without the int8 gradient compression, which waits for
ROADMAP.md queue 1, item 8c)."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import constant_lr, cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "constant_lr", "cosine_schedule", "linear_warmup_cosine"]
