"""Distribution layer, the port of ``repro.dist``.

``sharding``         — logical-axis sharding rules on DTensor (specs ->
                       placements on a ``DeviceMesh``), activation
                       constraints, and the sharding factories the
                       launcher and the dry runs use for parameters,
                       optimizer states, batches and caches.
``cluster_parallel`` — the clustering pipeline over row-sharded points on
                       ``torch.distributed``: the ring kNN, the exact lune
                       scan and the per-mpts Borůvka rows across ranks.
"""

from . import cluster_parallel, sharding

__all__ = ["cluster_parallel", "sharding"]
