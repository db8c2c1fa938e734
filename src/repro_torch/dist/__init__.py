"""Distribution layer, the port of ``repro.dist``.

``cluster_parallel`` — the clustering pipeline over row-sharded points on
                       ``torch.distributed``: the ring kNN, the exact lune
                       scan and the per-mpts Borůvka rows across ranks.

The reference's ``sharding`` (logical-axis rules for the LMs' sharded
train step) is not ported yet (``ROADMAP.md`` §1).
"""

from . import cluster_parallel

__all__ = ["cluster_parallel"]
