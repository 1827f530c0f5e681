"""Launchers: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (the mesh and dry-run launchers are
ROADMAP A12's)."""
