"""Launchers of the port, as in ``repro.launch``: so far the training loop
(``python -m repro_torch.launch.train``).  The cluster launcher, the
dry-run and the mesh helpers come with later items of ``ROADMAP.md`` §1."""
