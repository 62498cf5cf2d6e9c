"""Launchers of the port: ``python -m repro_torch.launch.train`` (training)
and ``python -m repro_torch.launch.dryrun`` (the per-cell launch report on
the production meshes, ``mesh``; collectives counted by ``comm_stats``)."""
