"""Launchers: ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.serve`` and the dry run
``python -m repro_torch.launch.dryrun``; the meshes they build
(``launch.mesh``)."""
