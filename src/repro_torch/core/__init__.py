"""Core library of the port: the paper's method as PyTorch modules.

Public API:
  multi_hdbscan       — all hierarchies for mpts in [kmin, kmax] via RNG^kmax
  fit_msts            — the shared graph + all MSTs, no extraction
  extract_hierarchies — batched on-demand extraction from a MultiMSTResult
  build_rng_graph     — the single RNG^kmax (variants rng_ss / rng_star / rng),
                        or the dual-tree tier's kNN ∪ Borůvka graph at large n
  dualtree            — the dual-tree candidate searches (a numpy copy)
  boruvka_mst(_range) — batched edge-list MSTs
  linkage             — batched single-linkage (extraction stage 1)
  hierarchy           — extraction (a numpy copy of the reference's module)
  predict             — out-of-sample prediction over the fitted state
  dbcv                — DBCV relative validity (a numpy copy)
"""

from . import boruvka, dbcv, dualtree, hierarchy, linkage, mrd, multi, predict, rng, sbcn, wspd
from .boruvka import boruvka_mst, boruvka_mst_range
from .linkage import single_linkage_batch
from .mrd import core_distances2, mrd2_from_parts, reweight_all_mpts
from .multi import (
    HierarchyResult,
    LinkageRange,
    MultiDensityResult,
    MultiMSTResult,
    extract_hierarchies,
    fit_msts,
    linkage_range,
    multi_hdbscan,
)
from .rng import RngGraph, build_rng_graph

__all__ = [
    "boruvka", "dbcv", "dualtree", "hierarchy", "linkage", "mrd", "multi", "predict", "rng", "sbcn", "wspd",
    "boruvka_mst", "boruvka_mst_range", "single_linkage_batch",
    "core_distances2", "mrd2_from_parts", "reweight_all_mpts",
    "HierarchyResult", "LinkageRange", "MultiDensityResult", "MultiMSTResult",
    "extract_hierarchies", "fit_msts", "linkage_range", "multi_hdbscan",
    "RngGraph", "build_rng_graph",
]
