"""Command-line drivers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), and the launch stack's meshes
(:mod:`.mesh`) and input specs (:mod:`.specs`)."""
