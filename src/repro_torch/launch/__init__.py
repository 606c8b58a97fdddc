"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``), their meshes of ranks
(:mod:`~repro_torch.launch.mesh`), the abstract stand-ins of every
(arch x shape) cell (:mod:`~repro_torch.launch.specs`) and the dry run's
per-cell tuned overrides (:mod:`~repro_torch.launch.tuned`)."""
