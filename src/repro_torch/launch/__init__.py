"""Launchers of the port, as in ``repro.launch``: the training loop
(``python -m repro_torch.launch.train``, one device or sharded under
``torchrun``), the device meshes (``launch.mesh``), the dry run of every
model on the production mesh (``python -m repro_torch.launch.dryrun``) and
the clustering planes' dry run (``python -m repro_torch.launch.cluster
--dryrun``)."""
