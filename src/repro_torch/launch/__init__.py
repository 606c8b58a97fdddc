"""Launchers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), their meshes of ranks
(:mod:`~repro_torch.launch.mesh`) and the abstract stand-ins of every
(arch x shape) cell (:mod:`~repro_torch.launch.specs`)."""
