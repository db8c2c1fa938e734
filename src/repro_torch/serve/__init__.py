"""Serving layer of the port, as in ``repro.serve``.

``engine.ClusterServeEngine`` is the clustering serve surface:
process-resident fitted state — fit in-process or booted refit-free from a
saved ``FittedModel`` artifact with ``ClusterServeEngine.load(path)`` —
micro-batched out-of-sample prediction on the model's device, per-request
``SelectionPolicy``, LRU-bounded per-(mpts, policy) extraction.
``lm`` keeps the small batched LM decode engine (prefill, then a decode
loop) that ``examples/serve_lm_torch.py`` drives.
"""

from . import engine, lm
from .engine import ClusterServeEngine

__all__ = ["ClusterServeEngine", "engine", "lm"]
