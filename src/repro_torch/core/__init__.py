"""Core library of the port: the paper's method as PyTorch modules.

Public API:
  multi_hdbscan       — all hierarchies for mpts in [kmin, kmax] via RNG^kmax
  hdbscan_baseline    — the paper's re-run baseline (shared kNN + dense Prim
                        MST per mpts)
  fit_msts            — the shared graph + all MSTs, no extraction
  extract_hierarchies — batched on-demand extraction from a MultiMSTResult
  build_rng_graph     — the single RNG^kmax (variants rng_ss / rng_star / rng),
                        or the dual-tree tier's kNN ∪ Borůvka graph at large n
  dualtree            — the dual-tree candidate searches (a numpy copy)
  boruvka_mst(_range) — batched edge-list MSTs; prim_dense_mst the dense one
  linkage             — batched single-linkage on the device (extraction stage 1)
  hierarchy           — extraction (a numpy copy of the reference's module)
  predict_range       — batched out-of-sample assignment over the fitted state
  dbcv                — DBCV relative validity (a numpy copy)
"""

from . import boruvka, dbcv, dualtree, hierarchy, linkage, mrd, multi, rng, sbcn, wspd
from .boruvka import boruvka_mst, boruvka_mst_range, prim_dense_mst
from .linkage import single_linkage_batch
from .mrd import core_distances2, edge_mrd2, mrd2_from_parts, reweight_all_mpts
from .multi import (
    HierarchyResult,
    LinkageRange,
    MultiDensityResult,
    MultiMSTResult,
    extract_hierarchies,
    fit_msts,
    hdbscan_baseline,
    linkage_range,
    multi_hdbscan,
)
from .rng import RngGraph, build_rng_graph

# predict consumes multi's result types; import after them (no cycle)
from . import predict
from .predict import PredictResult, membership_probabilities, predict_range

# the reference's public names, in its order
__all__ = [
    "predict", "PredictResult", "membership_probabilities", "predict_range",
    "boruvka", "dbcv", "hierarchy", "linkage", "mrd", "rng", "sbcn", "wspd",
    "boruvka_mst", "boruvka_mst_range", "prim_dense_mst", "single_linkage_batch",
    "core_distances2", "edge_mrd2", "mrd2_from_parts", "reweight_all_mpts",
    "HierarchyResult", "LinkageRange", "MultiDensityResult", "MultiMSTResult",
    "extract_hierarchies", "fit_msts", "hdbscan_baseline", "linkage_range",
    "multi_hdbscan",
    "RngGraph", "build_rng_graph",
]
