"""Optimizer, learning-rate schedules and int8 gradient compression of the
port (the JAX package's ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,
                    opt_specs_like)
from .compression import (compress_int8, compressed_all_reduce_tree,
                          compressed_allreduce_spec, decompress_int8,
                          ef_state_init)
from .schedules import constant_lr, cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "opt_specs_like", "constant_lr", "cosine_schedule",
           "linear_warmup_cosine", "compress_int8", "decompress_int8",
           "compressed_all_reduce_tree", "compressed_allreduce_spec",
           "ef_state_init"]
