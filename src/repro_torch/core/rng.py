"""RNG construction pipeline: RNG** -> RNG* -> exact RNG (paper §IV-E,
Alg. 1), the port of ``repro/core/rng.py``.

Variants: ``rng_ss`` (RNG**, the WSPD+SBCN supergraph, no filtering),
``rng_star`` (RNG*, + the kNN-lune filter and the core-distance
certificate) and ``rng`` (exact: + a scan of the whole point set for the
edges the cheap filter could not certify either way, Alg. 1 lines 22-26,
through the ``lune_filter`` kernel).  At n at or above
``Plan.dualtree_min_n`` the dual-tree tier (``_build_dualtree``) replaces
the WSPD build: kNN ∪ a dual-tree Borůvka edge set, which is not an RNG, so
``variant`` filters nothing there.

Two data planes build the filtered graph, as in the reference:

  * the fused cascade (default): ``sbcn.cascade_candidates`` emits sorted
    packed keys, then ``edge_cascade`` runs staged, stage 1 over each
    endpoint's ``cascade_stage1_k`` nearest neighbours and stage 2 over the
    full list on the open stage-1 survivors.  On a per-row tie overflow the
    build falls back to
  * the slot path (``sbcn_candidates`` + ``filter_cascade_device``): dense
    per-cell slots and the unstaged kNN-lune check; also the ``ref``
    backend's path.

Host syncs are the named ledger points only: ``candidate_count`` and
``stage1_count`` (scalars sizing the compactions), ``graph``, and
``lune_exact`` for the exact variant; the dual-tree tier syncs at ``graph``
alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import engine
from . import dualtree as dualtree_mod
from . import mrd as mrd_mod
from . import sbcn as sbcn_mod
from . import wspd as wspd_mod
from ..kernels import fused_cascade
from ..kernels.ops import sum_order, sum_sq

VARIANTS = ("rng_ss", "rng_star", "rng")

# the fused path packs (lo, hi) as lo * n + hi into int32 keys
_PACK_LIMIT = 46340


@dataclasses.dataclass
class RngGraph:
    """The single precomputed graph that serves the whole mpts range."""

    edges: np.ndarray      # (m, 2) int64, a < b
    d2: np.ndarray         # (m,)  squared Euclidean edge lengths
    w2_kmax: np.ndarray    # (m,)  squared mrd_kmax weights
    variant: str
    n_points: int
    stats: dict


def filter_cascade_device(x, cd2, knn_idx, knn_d2, lo, hi, valid, *, plan):
    """Unstaged filter cascade over padded/masked candidate slots.

    The reference's ``_knn_lune_check`` (paper lines 14-17: is any kmax-NN
    of a or b strictly inside lune(a, b)?) plus the certificate is exactly
    ``edge_cascade`` over the full kNN lists, so the slot path runs that
    kernel too, summing in the order of the reference's slot path.
    Returns ``(keep, certified, inside_any, d2_e, w2)``; invalid slots read
    point 0 and are masked.  Nothing is materialized.
    """
    inside_any, certified, d2_e, w2 = plan.edge_cascade(
        x, cd2[:, -1], knn_idx, knn_d2, lo, hi, valid,
        k_check=knn_idx.shape[1],
        order=sum_order(int(x.shape[1]), "slot"),
    )
    return valid & ~inside_any, certified, inside_any, d2_e, w2


def _exact_lune_pass(keep, certified, ea_h, eb_h, w2_h, x, cd2k, plan, stats):
    """variant="rng" (Alg. 1 lines 22-26): exact lune scan of the edges the
    cheap filter could not certify either way.  ``w2_h`` holds the filter
    stages' own weights (their verdicts carry the eps margins).  Updates
    ``stats``; returns the new keep mask (host bool array)."""
    unresolved = keep & ~certified
    stats["m_unresolved"] = int(unresolved.sum())
    if not unresolved.any():
        return keep
    keep = keep.copy()
    ui = np.nonzero(unresolved)[0]
    ea, eb, w2 = (
        torch.as_tensor(v[ui], dtype=dt).to(x.device)
        for v, dt in ((ea_h, torch.int32), (eb_h, torch.int32), (w2_h, torch.float32))
    )
    nonempty = engine.to_host(plan.lune_nonempty(ea, eb, w2, x, cd2k), "lune_exact")
    keep[ui[nonempty]] = False
    stats["m_removed_exact"] = int(nonempty.sum())
    return keep


def filter_edges(x, cd2, knn_idx, knn_d2, edges: np.ndarray, variant: str, *, plan) -> tuple[np.ndarray, dict]:
    """Apply the paper's filter cascade to an explicit (m, 2) host edge
    array; returns (kept edge array, stats dict)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    stats = {"m_candidates": int(len(edges))}
    if variant == "rng_ss" or len(edges) == 0:
        return edges, stats
    lo = torch.as_tensor(edges[:, 0].astype(np.int32)).to(x.device)
    hi = torch.as_tensor(edges[:, 1].astype(np.int32)).to(x.device)
    valid = torch.ones((len(edges),), dtype=torch.bool, device=x.device)
    keep_d, certified_d, inside_d, _, w2_d = filter_cascade_device(
        x, cd2, knn_idx, knn_d2, lo, hi, valid, plan=plan
    )
    keep, certified, inside_any, w2 = engine.to_host((keep_d, certified_d, inside_d, w2_d), "graph")
    stats["m_removed_knn"] = int(inside_any.sum())
    stats["m_certified"] = int((keep & certified).sum())
    if variant == "rng":
        keep = _exact_lune_pass(keep, certified, edges[:, 0], edges[:, 1], w2, x, cd2[:, -1], plan, stats)
    return edges[keep], stats


def canonical_edge_weights(x, cd2k, ea, eb):
    """Exact f32 (d2, w2_kmax) for an edge list: the one export function.

    Every path that exports edge weights (fused, slot and the dual-tree
    tier) goes through here, with the fused-add order the
    reference's canonical weight program compiles to, so the exported
    weights are bitwise the reference's and do not depend on the path.
    """
    ea, eb = ea.long(), eb.long()
    d2 = sum_sq(x[ea].float() - x[eb].float(), sum_order(int(x.shape[1]), "weights"))
    return d2, mrd_mod.mrd2_from_parts(d2, cd2k[ea], cd2k[eb])


def _empty_graph(variant: str, n: int, n_pairs: int) -> RngGraph:
    return RngGraph(
        edges=np.zeros((0, 2), np.int64),
        d2=np.zeros((0,), np.float32),
        w2_kmax=np.zeros((0,), np.float32),
        variant=variant,
        n_points=n,
        stats={"m_candidates": 0, "n_wspd_pairs": n_pairs, "m_edges": 0},
    )


def _build_fused(x, cd2, knn_d2, knn_idx, tree, pu, pv, variant, plan) -> RngGraph | None:
    """Fused-cascade RNG build; returns None on tie overflow (the caller
    falls back to the slot path, which keeps every tied SBCN minimum)."""
    n = int(x.shape[0])
    cd2k = cd2[:, -1]
    keys_sorted, n_real_d, n_unique_d, n_mutual_d, n_overflow_d = sbcn_mod.cascade_candidates(
        x, cd2k, tree.perm,
        tree.start[pu], tree.end[pu] - tree.start[pu],
        tree.start[pv], tree.end[pv] - tree.start[pv],
        tie_cap=plan.cascade_tie_cap,
        tier_chunk_elems=plan.tier_chunk_elems,
    )
    n_real, n_unique, n_mutual, n_overflow = (
        int(v) for v in engine.to_host(
            torch.stack([n_real_d, n_unique_d, n_mutual_d, n_overflow_d]), "candidate_count"
        )
    )
    if n_overflow:
        return None
    if n_real == 0:
        return _empty_graph(variant, n, int(len(pu)))
    stats = {
        "m_candidates": n_unique,
        "n_wspd_pairs": int(len(pu)),
        "m_candidate_slots": n_real,
        "m_mutual_slots": n_mutual,
        "path": "fused",
    }

    # stage 1: cheap prefilter over each endpoint's k1 nearest (its kills are
    # a subset of the full check's); the certificate splits the survivors:
    # a certified edge has w == max(cd(a), cd(b)) and nothing can lie
    # strictly inside its lune, so it skips stage 2
    k_full = knn_idx.shape[1]
    k1 = min(plan.cascade_stage1_k, k_full)
    order = sum_order(int(x.shape[1]), "cascade")
    lo, hi, _, w2_1, surv_cert, surv_open, nc_d, no_d = fused_cascade.stage1_packed(
        x, cd2k, knn_idx, knn_d2, keys_sorted[:n_real], n,
        k_check=k1, order=order, chunk=plan.cascade_chunk, block_e=plan.cascade_block_e,
    )
    n_cert, n_open = (int(v) for v in engine.to_host(torch.stack([nc_d, no_d]), "stage1_count"))
    if n_cert + n_open == 0:
        return _empty_graph(variant, n, int(len(pu)))

    parts_dev = []
    if n_cert:
        posc = sbcn_mod.compact_idx(surv_cert, n_cert)
        d2c, w2c = canonical_edge_weights(x, cd2k, lo[posc], hi[posc])
        keepc = torch.ones((n_cert,), dtype=torch.bool, device=x.device)
        parts_dev.append((lo[posc], hi[posc], keepc, keepc, d2c, w2c, w2_1[posc]))
    if n_open:
        poso = sbcn_mod.compact_idx(surv_open, n_open)
        valido = torch.ones((n_open,), dtype=torch.bool, device=x.device)
        killed2, _, _, w2_2 = plan.edge_cascade(
            x, cd2k, knn_idx, knn_d2, lo[poso], hi[poso], valido, k_check=k_full, order=order
        )
        d2o, w2o = canonical_edge_weights(x, cd2k, lo[poso], hi[poso])
        # open survivors are never certified: every kept one is unresolved
        parts_dev.append((lo[poso], hi[poso], ~killed2, torch.zeros_like(valido), d2o, w2o, w2_2))

    parts = engine.to_host(parts_dev, "graph")
    lo_h, hi_h, keep, certified, d2_h, w2_h, w2_stage = (
        np.concatenate([p[i] for p in parts]) for i in range(7)
    )
    # restore the slot path's sorted-(lo, hi) edge order: MST tie-breaks are
    # by edge id, so order parity keeps the two paths bit-equal
    order = np.lexsort((hi_h, lo_h))
    lo_h, hi_h, keep, certified, d2_h, w2_h, w2_stage = (
        v[order] for v in (lo_h, hi_h, keep, certified, d2_h, w2_h, w2_stage)
    )
    stats["m_removed_knn"] = n_unique - int(keep.sum())
    stats["m_certified"] = int((keep & certified).sum())
    if variant == "rng":
        # the lune scan thresholds on the stage weights; exports stay canonical
        keep = _exact_lune_pass(keep, certified, lo_h, hi_h, w2_stage, x, cd2k, plan, stats)
    edges = np.stack([lo_h[keep].astype(np.int64), hi_h[keep].astype(np.int64)], axis=1)
    stats["m_edges"] = int(len(edges))
    return RngGraph(
        edges=edges, d2=d2_h[keep], w2_kmax=w2_h[keep],
        variant=variant, n_points=n, stats=stats,
    )


def _build_dualtree(x, knn_d2, variant, plan, x_host, knn_d2_host, knn_idx_host) -> RngGraph:
    """Large-n tier: dual-tree Borůvka candidate edges + device weights.

    The host traversals select edge structure only (``core.dualtree``); the
    d2 and w2_kmax values that reach results come from
    ``canonical_edge_weights``, in one ``graph`` sync.  The graph is
    kNN^kmax ∪ S with S ⊇ an MST under mrd_kmax: a superset of every
    per-mpts MST, but not an RNG, so ``variant`` filters nothing here.  The
    edges keep the order ``candidate_edges`` returns (sorted by (lo, hi)):
    Borůvka breaks ties by edge id.
    """
    n = int(x.shape[0])
    edges, stats = dualtree_mod.candidate_edges(
        x_host, knn_d2_host, knn_idx_host,
        leaf_size=plan.dualtree_leaf, margin=plan.dualtree_margin,
    )
    stats["path"] = "dualtree"
    stats["m_edges"] = len(edges)
    if len(edges) == 0:
        return _empty_graph(variant, n, 0)
    ea = torch.as_tensor(edges[:, 0].astype(np.int32)).to(x.device)
    eb = torch.as_tensor(edges[:, 1].astype(np.int32)).to(x.device)
    d2_h, w2_h = engine.to_host(canonical_edge_weights(x, knn_d2[:, -1], ea, eb), "graph")
    return RngGraph(edges=edges, d2=d2_h, w2_kmax=w2_h, variant=variant, n_points=n, stats=stats)


def build_rng_graph(
    x: torch.Tensor,
    knn_d2: torch.Tensor,
    knn_idx: torch.Tensor,
    *,
    variant: str = "rng_star",
    separation: float = 1.0,
    plan: "engine.Plan",
    x_host: np.ndarray | None = None,
    cd_kmax_host: np.ndarray | None = None,
    knn_d2_host: np.ndarray | None = None,
    knn_idx_host: np.ndarray | None = None,
) -> RngGraph:
    """End-to-end candidate graph construction (Alg. 1 lines 5-21).

    ``x_host`` / ``cd_kmax_host`` / ``knn_*_host`` feed the host control
    planes without a device sync when the caller already holds host views
    (fit_msts does); left None they are materialized here under the
    ``input`` tag.  Large n (``plan.use_dualtree``) routes to the dual-tree
    tier (stats ``path="dualtree"``); otherwise the WSPD build below runs,
    fused cascade by default, slot path as fallback and oracle.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    n = int(x.shape[0])
    if x_host is None:
        x_host = engine.io.ensure_host(x)
    if n > 2 and plan.use_dualtree(n):
        if knn_d2_host is None or knn_idx_host is None:
            knn_d2_host, knn_idx_host = engine.io.ensure_host(knn_d2), engine.io.ensure_host(knn_idx)
        return _build_dualtree(x, knn_d2, variant, plan, x_host, knn_d2_host, knn_idx_host)
    cd2 = mrd_mod.core_distances2(knn_d2)
    if cd_kmax_host is None:
        cd_kmax_host = np.sqrt(engine.io.ensure_host(cd2[:, -1]).astype(np.float64))

    # -- host control plane: fair-split tree + well-separated pairs ---------
    tree = wspd_mod.build_fair_split_tree(np.asarray(x_host, np.float64), cd_kmax_host)
    pu, pv = wspd_mod.wspd_pairs(tree, s=separation)

    if variant != "rng_ss" and plan.backend != "ref" and n <= _PACK_LIMIT:
        g = _build_fused(x, cd2, knn_d2, knn_idx, tree, pu, pv, variant, plan)
        if g is not None:
            return g
        # per-row tie overflow (mass duplicates): the slot path below keeps
        # every tied SBCN minimum, so no candidate is lost

    # -- slot path: dense candidates + unstaged filter cascade ---------------
    lo_s, hi_s, keep_s = sbcn_mod.sbcn_candidates(
        x, cd2[:, -1], tree.perm,
        tree.start[pu], tree.end[pu] - tree.start[pu],
        tree.start[pv], tree.end[pv] - tree.start[pv],
        tile_elems=plan.sbcn_tile_elems,
        pair_cap=plan.sbcn_pair_cap,
        row_chunk=plan.sbcn_row_chunk,
    )
    m_cand = int(engine.to_host(keep_s.sum(), "candidate_count"))
    if m_cand == 0:
        return _empty_graph(variant, n, int(len(pu)))
    pos = sbcn_mod.compact_idx(keep_s, m_cand)
    lo, hi = lo_s[pos], hi_s[pos]
    valid = torch.ones((m_cand,), dtype=torch.bool, device=x.device)
    if variant == "rng_ss":
        keep_d = valid
        certified_d = inside_d = torch.zeros_like(valid)
        w2_d = torch.zeros((m_cand,), dtype=torch.float32, device=x.device)
    else:
        keep_d, certified_d, inside_d, _, w2_d = filter_cascade_device(
            x, cd2, knn_idx, knn_d2, lo, hi, valid, plan=plan
        )
    d2c_d, w2c_d = canonical_edge_weights(x, cd2[:, -1], lo, hi)
    lo_h, hi_h, keep, certified, inside_any, d2_h, w2_h, w2_stage = engine.to_host(
        (lo, hi, keep_d, certified_d, inside_d, d2c_d, w2c_d, w2_d), "graph"
    )
    stats = {"m_candidates": m_cand, "n_wspd_pairs": int(len(pu))}
    if variant != "rng_ss":
        stats["m_removed_knn"] = int(inside_any.sum())
        stats["m_certified"] = int((keep & certified).sum())
    if variant == "rng":
        keep = _exact_lune_pass(keep, certified, lo_h, hi_h, w2_stage, x, cd2[:, -1], plan, stats)
    edges = np.stack([lo_h[keep].astype(np.int64), hi_h[keep].astype(np.int64)], axis=1)
    stats["m_edges"] = int(len(edges))
    return RngGraph(
        edges=edges, d2=d2_h[keep], w2_kmax=w2_h[keep],
        variant=variant, n_points=n, stats=stats,
    )
