"""Launchers of the port: ``python -m repro_torch.launch.train``.  The
dry-run report of the JAX package's ``repro.launch`` waits for ROADMAP A9
(launch)."""
