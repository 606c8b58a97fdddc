"""Meshes and the distribution strategy (the JAX package's
``repro.parallel``): the compiler's spec-sweep meshes, the logical-axis
rules and parameter trees, and the models' sharding over a mesh of ranks
(:mod:`~repro_torch.parallel.zero`, :mod:`~repro_torch.parallel.collectives`).
"""

from .logical import Logical, logical_axes, param, split_logical, spec_of
from .sharding import (MESH_RULES, Mesh, host_spec_mesh, logical_to_spec,
                       placements, rules_for_mesh, shard_batch_spec,
                       spec_sweep_mesh, with_sharding, world_size)

__all__ = ["Logical", "param", "split_logical", "spec_of", "logical_axes",
           "MESH_RULES", "logical_to_spec", "rules_for_mesh", "placements",
           "shard_batch_spec", "with_sharding", "Mesh", "host_spec_mesh",
           "spec_sweep_mesh", "world_size"]
