"""Device meshes (the JAX package's ``repro.parallel``).

So far the spec-sweep part: the meshes the sharded compiler engine places
its spec lanes on.  The logical-axis rules (``MESH_RULES``,
``rules_for_mesh``, ``logical_to_spec``), the model-side helpers
(``with_sharding``, ``activation_rules``, ``constrain_act``,
``shard_batch_spec``) and ``parallel/logical.py`` come with training and
scale-out, their first caller.
"""

from .sharding import Mesh, host_spec_mesh, spec_sweep_mesh, world_size

__all__ = ["Mesh", "host_spec_mesh", "spec_sweep_mesh", "world_size"]
