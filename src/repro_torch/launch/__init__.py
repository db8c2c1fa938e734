"""Launchers of the port, as in ``repro.launch``: the training loop
(``python -m repro_torch.launch.train``) and the device meshes
(``launch.mesh``).  The cluster launcher and the dry-run come with a later
item of ``ROADMAP.md`` §1."""
