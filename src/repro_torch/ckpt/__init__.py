"""Checkpoints, restarts and elastic re-meshing of the port (the JAX
package's ``repro.ckpt``, in its file format)."""

from .elastic import reshard_tree
from .failures import FailureInjector, InjectedFailure, run_with_restarts
from .manager import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint",
           "reshard_tree", "FailureInjector", "InjectedFailure",
           "run_with_restarts"]
