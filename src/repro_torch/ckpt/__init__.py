"""Checkpoints and restarts of the port (the JAX package's ``repro.ckpt``
in its file format; the elastic re-sharding waits for ROADMAP.md queue 1,
item 8c)."""

from .failures import FailureInjector, InjectedFailure, run_with_restarts
from .manager import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "FailureInjector", "InjectedFailure", "run_with_restarts"]
