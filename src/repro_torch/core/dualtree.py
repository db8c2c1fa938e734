"""Dual-tree Borůvka candidate generation — the large-n tier.

A copy of ``repro/core/dualtree.py`` (pure numpy host control plane).

The WSPD/SBCN candidate stage (core.sbcn) is exact but O(n^2)-flavored: the
number of well-separated pairs is linear, but dense regions produce pair
tiles whose total area grows superlinearly, which capped routine benchmarks
at n≈4000.  This module replaces the *candidate generation* for large n with
two dual-tree traversals over the same fair-split tree (core.wspd, built
with ``leaf_size > 1`` so recursion bottoms out in batched leaf tiles):

  ``knn_candidates``   — dual-tree kNN candidate search.  Host-side f64
                         control plane that returns, per point, a superset
                         of its ``k_eff`` nearest neighbours; the *exact*
                         distances and final top-k come from the same device
                         ``_refine_knn`` program every other backend uses,
                         so kNN output is bit-identical to the small-n tier.
  ``dualtree_graph``   — margin-collecting dual-tree Borůvka under the
                         mutual-reachability metric at mpts=kmax.  Produces
                         a candidate edge set S such that kNN ∪ S contains
                         an MST of the complete mrd_kmax graph; edge
                         weights are then computed ON DEVICE by the same
                         ``mrd`` programs as the small-n tier.

Why kNN ∪ (an MST under mrd_kmax) suffices for the WHOLE mpts range
(the CORE-SG containment argument; docs/architecture.md "Dual-tree
Borůvka" has the full derivation): for any cut and any mpts <= kmax, take a
minimum-w_mpts crossing edge e=(a,b).  Either d(a,b) <= c_kmax(a) (or the
symmetric case) — then b is in a's kmax-NN list and e is a kNN-graph edge —
or d(a,b) strictly exceeds both core distances, in which case
w_kmax(e) = d(a,b) = w_mpts(e); since w_kmax >= w_mpts pointwise, e is also
a minimum-w_kmax crossing edge, so MST_kmax contains a crossing edge f* with
w_kmax(f*) = w_kmax(e), hence w_mpts(f*) <= w_mpts(e): f* is a minimum
crossing edge under mpts too.  Every cut therefore has a minimum crossing
edge inside kNN ∪ MST_kmax, which makes it a valid MST candidate graph for
every mpts — exactly the property the RNG^kmax supergraph provides on the
small-n tier, at a fraction of the edges.

Exactness discipline (the defense against pruning bugs):

  * Host traversals run in f64 and NEVER produce a distance that reaches
    results — they only select candidate STRUCTURE (index sets).  All
    distances/weights that downstream stages consume are computed by the
    same f32 device programs as the oracle path.
  * Pruning and emission use a relative margin (``margin``, default from
    ``Plan.dualtree_margin``) on the f64 bounds, so f32-vs-f64 ordering
    disagreements near ties can only ADD candidates, never drop one.
  * Per point we keep the best AND the runner-up outgoing edge within the
    margin of its component's bound, so an f32 tie-break that prefers a
    different minimum edge still finds it in the candidate set.

Everything here is level-synchronous vectorized numpy (the wspd_pairs
idiom): worklists are arrays, node statistics are reduceat/segment sweeps,
leaf-leaf interactions evaluate as batched (P, L, L) tiles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import wspd as wspd_mod

# leaf tile evaluation is chunked so the (P, L, L) scratch stays bounded
_TILE_BUDGET = 1 << 22


# ---------------------------------------------------------------------------
# Tree index: levels, parents, leaf partition, node statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeIndex:
    """A fair-split tree plus the traversal scaffolding both searches share."""

    tree: wspd_mod.FairSplitTree
    parent: np.ndarray            # (n_nodes,) parent id, -1 for root
    levels: list                  # node ids per depth, root first
    internal_rev: list            # internal node ids per depth, DEEPEST first
    leaf_order: np.ndarray        # leaf ids sorted by perm range start
    leaf_starts: np.ndarray       # (n_leaves,) — a partition of [0, n)
    leaf_max: int                 # max leaf size (tile width)
    size: np.ndarray              # (n_nodes,) point counts
    bbox_lo: np.ndarray           # (n_nodes, d) per-node coordinate minima
    bbox_hi: np.ndarray           # (n_nodes, d) per-node coordinate maxima


def build_index(
    x: np.ndarray, cd_kmax: np.ndarray, *, leaf_size: int
) -> TreeIndex:
    tree = wspd_mod.build_fair_split_tree(x, cd_kmax, leaf_size=leaf_size)
    left, right = tree.left, tree.right
    parent = np.full(tree.n_nodes, -1, np.int64)
    internal = np.nonzero(left != -1)[0]
    parent[left[internal]] = internal
    parent[right[internal]] = internal

    levels = []
    cur = np.array([0], np.int64)
    while len(cur):
        levels.append(cur)
        isn = cur[left[cur] != -1]
        if not len(isn):
            break
        cur = np.concatenate([left[isn], right[isn]])
    internal_rev = [
        lev[left[lev] != -1]
        for lev in reversed(levels)
        if (left[lev] != -1).any()
    ]

    leaves = np.nonzero(left == -1)[0]
    leaf_order = leaves[np.argsort(tree.start[leaves])]
    size = tree.end - tree.start
    ix = TreeIndex(
        tree=tree,
        parent=parent,
        levels=levels,
        internal_rev=internal_rev,
        leaf_order=leaf_order,
        leaf_starts=tree.start[leaf_order],
        leaf_max=int(size[leaves].max()),
        size=size,
        bbox_lo=np.empty(0),
        bbox_hi=np.empty(0),
    )
    # per-node bboxes: per-dim clamp bounds are far tighter than the
    # circumscribed balls in higher d (a ball bound degrades as sqrt(d))
    d = x.shape[1]
    ix.bbox_lo = np.stack(
        [node_agg(ix, x[:, j], np.minimum) for j in range(d)], axis=1
    )
    ix.bbox_hi = np.stack(
        [node_agg(ix, x[:, j], np.maximum) for j in range(d)], axis=1
    )
    return ix


def node_agg(ix: TreeIndex, vals: np.ndarray, op) -> np.ndarray:
    """Per-node aggregate of a per-POINT array (op = np.minimum/np.maximum).

    One reduceat over the leaf partition (leaves tile perm contiguously) and
    a bottom-up child sweep: O(n + n_nodes) per call, cheap enough to
    recompute every traversal wave as bounds tighten.
    """
    vp = vals[ix.tree.perm]
    agg = np.empty(ix.tree.n_nodes, vp.dtype)
    agg[ix.leaf_order] = op.reduceat(vp, ix.leaf_starts)
    for nodes in ix.internal_rev:
        agg[nodes] = op(agg[ix.tree.left[nodes]], agg[ix.tree.right[nodes]])
    return agg


def node_pair_lb2(ix: TreeIndex, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Squared lower bound on min pairwise distance between two nodes' points.

    Max of two sound bounds, which dominate in different regimes:

      * ball:  (max(0, ||c_U - c_V|| - r_U - r_V))^2 — wins on DIAGONAL
        separation, where shallow fair-split cells still overlap per-axis
        (the common case in moderate d, where depth/d < 2 and every bbox
        interval spans a large slice of the data range);
      * bbox:  sum of squared per-dimension interval gaps — wins on
        axis-aligned separation, where the circumscribed-ball radii grow
        like sqrt(d) times the side length and the ball bound collapses.
    """
    tree = ix.tree
    diff = tree.center[U] - tree.center[V]
    dc = np.sqrt(np.einsum("ij,ij->i", diff, diff))
    lb = np.maximum(0.0, dc - tree.radius[U] - tree.radius[V])
    gap = np.maximum(
        ix.bbox_lo[U] - ix.bbox_hi[V], ix.bbox_lo[V] - ix.bbox_hi[U]
    )
    gap = np.maximum(gap, 0.0)
    return np.maximum(lb * lb, np.einsum("ij,ij->i", gap, gap))


def node_pair_ub2(ix: TreeIndex, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Squared upper bound on min pairwise distance: min of the ball bound
    (center gap + both radii) and the per-dim bbox span — both bound the
    MAX pairwise distance, hence also the min."""
    tree = ix.tree
    diff = tree.center[U] - tree.center[V]
    dc = np.sqrt(np.einsum("ij,ij->i", diff, diff))
    ub = dc + tree.radius[U] + tree.radius[V]
    span = np.maximum(
        ix.bbox_hi[U] - ix.bbox_lo[V], ix.bbox_hi[V] - ix.bbox_lo[U]
    )
    return np.minimum(ub * ub, np.einsum("ij,ij->i", span, span))


def _pairs_below(
    ix: TreeIndex, U: np.ndarray, V: np.ndarray, thresh: np.ndarray
) -> np.ndarray:
    """Boolean keep-mask: pair i survives iff ``node_pair_lb2 <= thresh[i]``.

    Phased cheapest-first evaluation of the same combined bound as
    ``node_pair_lb2`` — the ball test runs sqrt-free on all pairs
    (``dc2 <= (sqrt(thresh) + r_U + r_V)^2``), the bbox gathers and gap
    einsum run only on ball survivors.  In the hot traversal waves the
    bound arithmetic itself is a top-two cost, so evaluating the second
    bound on the (much smaller) survivor set matters.
    """
    tree = ix.tree
    keep = np.zeros(len(U), bool)
    diff = tree.center[U] - tree.center[V]
    dc2 = np.einsum("ij,ij->i", diff, diff)
    lim = np.sqrt(thresh) + tree.radius[U] + tree.radius[V]
    s = np.nonzero(dc2 <= lim * lim)[0]
    if not len(s):
        return keep
    Us, Vs = U[s], V[s]
    gap = np.maximum(
        ix.bbox_lo[Us] - ix.bbox_hi[Vs], ix.bbox_lo[Vs] - ix.bbox_hi[Us]
    )
    np.maximum(gap, 0.0, out=gap)
    keep[s[np.einsum("ij,ij->i", gap, gap) <= thresh[s]]] = True
    return keep


# ---------------------------------------------------------------------------
# Shared vectorized helpers
# ---------------------------------------------------------------------------


def _run_rank(sorted_ids: np.ndarray) -> np.ndarray:
    """Rank within equal-value runs of an already-sorted id array."""
    idx = np.arange(len(sorted_ids))
    new = np.concatenate([[True], sorted_ids[1:] != sorted_ids[:-1]])
    return idx - np.maximum.accumulate(np.where(new, idx, 0))


def _merge_topk(
    bestd: np.ndarray, besti: np.ndarray, q: np.ndarray, r: np.ndarray, d2: np.ndarray
) -> None:
    """Merge (q, r, d2) contributions into running per-row top-k, in place.

    Deduplicates (q, r) pairs (traversal and priming windows can both visit
    a pair — a duplicate occupying two slots would shrink the row's kth
    bound below the true kth distance and over-prune).  Ties sort by (d2, r)
    so the kept set is deterministic.
    """
    if len(q) == 0:
        return
    k_eff = bestd.shape[1]
    uq, inv = np.unique(q, return_inverse=True)
    cur_r = besti[uq].ravel()
    cur_d = bestd[uq].ravel()
    cur_row = np.repeat(np.arange(len(uq)), k_eff)
    valid = cur_r >= 0
    row = np.concatenate([cur_row[valid], inv])
    rr = np.concatenate([cur_r[valid], r])
    dd = np.concatenate([cur_d[valid], d2])
    # dedup (row, r), keep min d2
    o = np.lexsort((dd, rr, row))
    row, rr, dd = row[o], rr[o], dd[o]
    first = np.concatenate(
        [[True], (row[1:] != row[:-1]) | (rr[1:] != rr[:-1])]
    )
    row, rr, dd = row[first], rr[first], dd[first]
    # per-row top-k by (d2, r)
    o2 = np.lexsort((rr, dd, row))
    row, rr, dd = row[o2], rr[o2], dd[o2]
    rank = _run_rank(row)
    keep = rank < k_eff
    row, rr, dd, rank = row[keep], rr[keep], dd[keep], rank[keep]
    bestd[uq] = np.inf
    besti[uq] = -1
    bestd[uq[row], rank] = dd
    besti[uq[row], rank] = rr


def _leaf_points(ix: TreeIndex, nodes: np.ndarray) -> np.ndarray:
    """(P, leaf_max) point ids of each leaf node, -1 padded."""
    tree = ix.tree
    s, e = tree.start[nodes], tree.end[nodes]
    pos = s[:, None] + np.arange(ix.leaf_max)[None, :]
    valid = pos < e[:, None]
    ids = tree.perm[np.where(valid, pos, 0)]
    return np.where(valid, ids, -1)


def _tile_d2(x: np.ndarray, qid: np.ndarray, rid: np.ndarray) -> np.ndarray:
    """(P, L, L) f64 squared distances; inf at padding and self pairs.

    Matmul form is fine here: these distances are advisory (bounds and
    candidate selection under a margin); every distance that reaches results
    is recomputed by the exact device programs.
    """
    xq = x[np.where(qid >= 0, qid, 0)]
    xr = x[np.where(rid >= 0, rid, 0)]
    qn = np.einsum("pld,pld->pl", xq, xq)
    rn = np.einsum("pld,pld->pl", xr, xr)
    d2 = qn[:, :, None] + rn[:, None, :] - 2.0 * np.einsum("pld,pmd->plm", xq, xr)
    np.maximum(d2, 0.0, out=d2)
    bad = (
        (qid[:, :, None] < 0)
        | (rid[:, None, :] < 0)
        | (qid[:, :, None] == rid[:, None, :])
    )
    d2[bad] = np.inf
    return d2


def _rows_d2(x: np.ndarray, q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """(R, C) f64 squared distances between x[q[i]] and x[r[i, j]]."""
    xq = x[q]
    xr = x[r]
    qn = np.einsum("rd,rd->r", xq, xq)
    rn = np.einsum("rcd,rcd->rc", xr, xr)
    d2 = qn[:, None] + rn - 2.0 * np.einsum("rd,rcd->rc", xq, xr)
    np.maximum(d2, 0.0, out=d2)
    return d2


def _split_pairs(ix: TreeIndex, U, V, sp):
    """One splitting step: self pairs expand to (l,l),(r,r),(l,r); non-self
    pairs split the larger-radius side (never a leaf).  Returns the next
    worklist.  Every unordered node pair is generated at most once."""
    tree = ix.tree
    left, right, radius = tree.left, tree.right, tree.radius
    si = U[sp]
    sl, sr = left[si], right[si]
    Un, Vn = U[~sp], V[~sp]
    can_u = left[Un] != -1
    can_v = left[Vn] != -1
    ru, rv = radius[Un], radius[Vn]
    su = (ru > rv) | ((ru == rv) & (ix.size[Un] >= ix.size[Vn]))
    su = np.where(can_u & can_v, su, can_u)
    Us, Vs = Un[su], Vn[su]
    Uo, Vo = Un[~su], Vn[~su]
    nU = np.concatenate([sl, sr, sl, left[Us], right[Us], Uo, Uo])
    nV = np.concatenate([sl, sr, sr, Vs, Vs, left[Vo], right[Vo]])
    return nU, nV


# ---------------------------------------------------------------------------
# Dual-tree kNN candidate search
# ---------------------------------------------------------------------------


def knn_candidates(
    x: np.ndarray,
    k_eff: int,
    *,
    leaf_size: int = 32,
    margin: float = 1e-5,
) -> np.ndarray:
    """Per-point candidate neighbour sets via dual-tree search.

    Returns (n, k_eff) int32 neighbour ids (no self, -1 padded only when
    n - 1 < k_eff), each row ordered by (f32-cast distance, id) so the
    device refine pass's top-k tie-breaks match the other backends'.

    The search maintains per-point kth-candidate bounds; a node pair (U, V)
    is pruned when its distance lower bound exceeds ``(1 + margin) * B``
    with B = max over the pair's points of their kth bound — pruned pairs
    provably contain no candidate-improving point (property-tested).
    """
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    n = x.shape[0]
    if n < 2:
        return np.full((n, k_eff), -1, np.int32)
    k_eff = min(k_eff, n - 1)
    ix = build_index(x, np.zeros(n), leaf_size=leaf_size)
    tree = ix.tree

    bestd = np.full((n, k_eff), np.inf)
    besti = np.full((n, k_eff), -1, np.int64)

    # ---- prime the bounds: perm-order sliding windows ---------------------
    # The tree permutation groups spatially-near points, so a width-W window
    # around each perm position yields finite (and usually tight) kth bounds
    # before the traversal starts — without it the first waves can't prune.
    W = min(n, 2 * k_eff + 2)
    starts = np.clip(np.arange(n) - W // 2, 0, n - W)
    perm = tree.perm
    chunk = max(1, _TILE_BUDGET // (W * x.shape[1]))
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        q = perm[c0:c1]
        r = perm[starts[c0:c1, None] + np.arange(W)[None, :]]
        d2 = _rows_d2(x, q, r)
        qf = np.repeat(q, W)
        rf = r.ravel()
        df = d2.ravel()
        ok = qf != rf
        _merge_topk(bestd, besti, qf[ok], rf[ok], df[ok])

    # ---- NN-descent passes: tighten bounds toward exact -------------------
    # The traversal's prune volume scales like (bound/true_kth)^d — in
    # moderate d a loose warm start inflates the visited node pairs by
    # orders of magnitude.  A couple of neighbours-of-neighbours passes
    # (NN-descent) drive the kth bounds near-exact for a few n*k^2 d2
    # evaluations, after which the traversal does little beyond proving
    # no candidate was missed.
    for _ in range(2):
        nb = np.where(besti >= 0, besti, 0)
        kk = nb.shape[1]
        cand2 = nb[nb.ravel()].reshape(n, kk * kk)
        chunk2 = max(1, _TILE_BUDGET // (kk * kk * x.shape[1]))
        improved = 0
        for c0 in range(0, n, chunk2):
            c1 = min(n, c0 + chunk2)
            q = np.arange(c0, c1)
            r = cand2[c0:c1]
            d2 = _rows_d2(x, q, r)
            qf = np.repeat(q, r.shape[1])
            rf = r.ravel()
            df = d2.ravel()
            ok = (qf != rf) & (df < bestd[qf, -1])
            improved += int(ok.sum())
            _merge_topk(bestd, besti, qf[ok], rf[ok], df[ok])
        if improved == 0:
            break

    # ---- level-synchronous dual-tree traversal ----------------------------
    U = np.array([0], np.int64)
    V = np.array([0], np.int64)
    left = tree.left
    tile_chunk = max(1, _TILE_BUDGET // max(1, ix.leaf_max**2))
    while len(U):
        B = node_agg(ix, bestd[:, -1], np.maximum)
        sp = U == V
        keep = sp.copy()
        ns = np.nonzero(~sp)[0]
        if len(ns):
            Un, Vn = U[ns], V[ns]
            thresh = np.maximum(B[Un], B[Vn]) * (1.0 + margin)
            keep[ns[_pairs_below(ix, Un, Vn, thresh)]] = True
        U, V, sp = U[keep], V[keep], sp[keep]
        if not len(U):
            break
        leaf = (left[U] == -1) & (left[V] == -1)
        lu, lv = U[leaf], V[leaf]
        for c0 in range(0, len(lu), tile_chunk):
            cu, cv = lu[c0 : c0 + tile_chunk], lv[c0 : c0 + tile_chunk]
            qid = _leaf_points(ix, cu)
            rid = _leaf_points(ix, cv)
            d2 = _tile_d2(x, qid, rid)
            P, L = qid.shape
            qf = np.broadcast_to(qid[:, :, None], (P, L, L)).ravel()
            rf = np.broadcast_to(rid[:, None, :], (P, L, L)).ravel()
            df = d2.ravel()
            # both directions; dedup in the merge handles self pairs
            qf2 = np.concatenate([qf, rf])
            rf2 = np.concatenate([rf, qf])
            df2 = np.concatenate([df, df])
            # drop entries that cannot enter the top-k (strictly worse than
            # the row's current kth bound; ties kept)
            ok = np.isfinite(df2)
            ok &= df2 <= bestd[np.where(ok, qf2, 0), -1] + np.where(ok, 0, np.inf)
            _merge_topk(bestd, besti, qf2[ok], rf2[ok], df2[ok])
        U, V, sp = U[~leaf], V[~leaf], sp[~leaf]
        if not len(U):
            break
        U, V = _split_pairs(ix, U, V, sp)

    # Order rows by (f32-cast distance, id): the device refine recomputes
    # exact f32 distances and takes a stable top-k, so candidate ORDER is
    # what breaks exact-tie ranks — ascending id matches the other backends.
    d32 = bestd.astype(np.float32)
    rows = np.repeat(np.arange(n), k_eff)
    o = np.lexsort((besti.ravel(), d32.ravel(), rows))
    return besti.ravel()[o].reshape(n, k_eff).astype(np.int32)


# ---------------------------------------------------------------------------
# Margin-collecting dual-tree Borůvka under mrd_kmax
# ---------------------------------------------------------------------------


def _merge_components(comp: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Union the components joined by (lo, hi) edges; labels are min point
    ids (hook to roots + pointer jumping, all vectorized)."""
    lab = comp.copy()
    if len(lo) == 0:
        return lab
    for _ in range(64):
        before = lab.copy()
        m = np.minimum(lab[lo], lab[hi])
        np.minimum.at(lab, before[lo], m)
        np.minimum.at(lab, before[hi], m)
        while True:
            nl = lab[lab]
            if np.array_equal(nl, lab):
                break
            lab = nl
        if np.array_equal(lab, before):
            return lab
    raise RuntimeError("dualtree: component merge did not converge")


def boruvka_tree_edges(
    ix: TreeIndex,
    x: np.ndarray,
    cd2k: np.ndarray,
    knn_d2: np.ndarray,
    knn_idx: np.ndarray,
    *,
    margin: float = 1e-5,
    max_rounds: int = 64,
) -> tuple[np.ndarray, dict]:
    """Candidate MST edges under mrd_kmax via dual-tree Borůvka.

    Returns ((m, 2) int64 lo<hi edges, stats).  Per round, per component,
    the edge set contains every point's best and runner-up outgoing edge
    whose f64 weight is within ``(1 + margin)`` of the component's minimum —
    so kNN ∪ result contains a minimum outgoing edge per component under
    the DEVICE f32 ordering too, which is what makes the downstream f32
    Borůvka over the candidate graph produce a true complete-graph MST.

    Contraction is stricter than emission: components merge only along
    their (w, lo, hi)-lexicographic-minimum outgoing edge, i.e. vanilla
    Borůvka under a distinct total order, so the union of contraction
    edges is itself a true MST under mrd_kmax and every cut the exact
    downstream pass needs has been examined by some round.
    """
    n = x.shape[0]
    tree = ix.tree
    left = tree.left
    kd = knn_d2.astype(np.float64)
    ki = knn_idx.astype(np.int64)
    rows_k = np.arange(n)[:, None]
    min_cd2 = node_agg(ix, cd2k, np.minimum)
    tile_chunk = max(1, _TILE_BUDGET // max(1, ix.leaf_max**2))

    comp = np.arange(n)
    out_lo: list[np.ndarray] = []
    out_hi: list[np.ndarray] = []
    stats = {"n_rounds": 0, "n_leaf_tiles": 0}
    for _round in range(max_rounds):
        n_comp = len(np.unique(comp))
        if n_comp == 1:
            break
        stats["n_rounds"] += 1

        # -- per-point best/runner-up init from the kNN lists --------------
        mr = np.maximum(kd, np.maximum(cd2k[:, None], cd2k[ki]))
        mr[comp[:, None] == comp[ki]] = np.inf
        bw = np.full((n, 2), np.inf)
        bi = np.full((n, 2), -1, np.int64)
        take = min(2, kd.shape[1])
        o = np.argsort(mr, axis=1, kind="stable")[:, :take]
        cand_w = np.take_along_axis(mr, o, axis=1)
        cand_i = np.take_along_axis(ki, o, axis=1)
        fin = np.isfinite(cand_w)
        bw[:, :take][fin] = cand_w[fin]
        bi[:, :take][fin] = cand_i[fin]

        # components are static within a round: uniform-component node ids
        umin = node_agg(ix, comp, np.minimum)
        umax = node_agg(ix, comp, np.maximum)
        ucomp = np.where(umin == umax, umin, -1)

        # -- traversal: improve per-point bests under mrd_kmax --------------
        U = np.array([0], np.int64)
        V = np.array([0], np.int64)
        while len(U):
            bwc = np.full(n, np.inf)
            np.minimum.at(bwc, comp, bw[:, 0])
            B = node_agg(ix, bwc[comp], np.maximum)
            sp = U == V
            same = (ucomp[U] >= 0) & (ucomp[U] == ucomp[V])
            thresh = np.maximum(B[U], B[V]) * (1.0 + margin)
            # self pairs have lb2 = 0 but still carry the core-distance
            # floor, so the bound check applies to them too
            alive = ~same & (np.maximum(min_cd2[U], min_cd2[V]) <= thresh)
            keep = alive & sp
            ns = np.nonzero(alive & ~sp)[0]
            if len(ns):
                keep[ns[_pairs_below(ix, U[ns], V[ns], thresh[ns])]] = True
            U, V, sp = U[keep], V[keep], sp[keep]
            if not len(U):
                break
            leaf = (left[U] == -1) & (left[V] == -1)
            lu, lv = U[leaf], V[leaf]
            for c0 in range(0, len(lu), tile_chunk):
                cu = lu[c0 : c0 + tile_chunk]
                cv = lv[c0 : c0 + tile_chunk]
                stats["n_leaf_tiles"] += len(cu)
                qid = _leaf_points(ix, cu)
                rid = _leaf_points(ix, cv)
                t = _tile_d2(x, qid, rid)
                qs = np.where(qid >= 0, qid, 0)
                rs = np.where(rid >= 0, rid, 0)
                np.maximum(t, cd2k[qs][:, :, None], out=t)
                np.maximum(t, cd2k[rs][:, None, :], out=t)
                t[comp[qs][:, :, None] == comp[rs][:, None, :]] = np.inf
                P, L = qid.shape
                qf = np.broadcast_to(qid[:, :, None], (P, L, L)).ravel()
                rf = np.broadcast_to(rid[:, None, :], (P, L, L)).ravel()
                tf = t.ravel()
                qf2 = np.concatenate([qf, rf])
                rf2 = np.concatenate([rf, qf])
                tf2 = np.concatenate([tf, tf])
                ok = np.isfinite(tf2)
                _merge_topk(bw, bi, qf2[ok], rf2[ok], tf2[ok])
            U, V, sp = U[~leaf], V[~leaf], sp[~leaf]
            if not len(U):
                break
            U, V = _split_pairs(ix, U, V, sp)

        # -- margin emission + contraction ----------------------------------
        bwc = np.full(n, np.inf)
        np.minimum.at(bwc, comp, bw[:, 0])
        thresh = bwc[comp] * (1.0 + margin)
        e_lo = []
        e_hi = []
        for col in (0, 1):
            sel = np.isfinite(bw[:, col]) & (bw[:, col] <= thresh)
            p = np.nonzero(sel)[0]
            q = bi[p, col]
            e_lo.append(np.minimum(p, q))
            e_hi.append(np.maximum(p, q))
        lo = np.concatenate(e_lo)
        hi = np.concatenate(e_hi)
        out_lo.append(lo)
        out_hi.append(hi)

        # -- contraction: ONE edge per component — its minimum outgoing edge
        # under the total order (w, lo, hi).  The margin/runner-up edges
        # above are candidates only: contracting along a non-minimum (or
        # inconsistently tie-broken) edge coarsens later rounds, and a cut
        # inside a coarsened component is never examined again — its true
        # minimum crossing edge would be silently dropped.  Distinct total
        # order keys make this vanilla Borůvka: the union of contraction
        # edges over rounds is exactly one true MST under mrd_kmax.
        # (Per-point slot 0 suffices: _merge_topk ranks ties by (d2, r), and
        # for a fixed point, minimizing the neighbour id also minimizes the
        # (lo, hi) edge key, so the component's lexicographic-minimum
        # outgoing edge is some member point's slot-0 edge.)
        pc = np.nonzero(np.isfinite(bw[:, 0]))[0]
        qc = bi[pc, 0]
        wc = bw[pc, 0]
        lo_c = np.minimum(pc, qc)
        hi_c = np.maximum(pc, qc)
        cpc = comp[pc]
        oc = np.lexsort((hi_c, lo_c, wc, cpc))
        first_c = np.concatenate([[True], cpc[oc][1:] != cpc[oc][:-1]])
        sel = oc[first_c]
        comp = _merge_components(comp, lo_c[sel], hi_c[sel])
        if len(np.unique(comp)) >= n_comp:
            raise RuntimeError(
                f"dualtree Borůvka made no progress at round {_round} "
                f"({n_comp} components) — traversal bound bug"
            )
    else:
        raise RuntimeError(
            f"dualtree Borůvka did not converge in {max_rounds} rounds"
        )

    lo = np.concatenate(out_lo) if out_lo else np.zeros(0, np.int64)
    hi = np.concatenate(out_hi) if out_hi else np.zeros(0, np.int64)
    keys = np.unique(lo * n + hi)
    edges = np.stack([keys // n, keys % n], axis=1)
    stats["m_tree_edges"] = int(len(edges))
    return edges, stats


def candidate_edges(
    x_host: np.ndarray,
    knn_d2_host: np.ndarray,
    knn_idx_host: np.ndarray,
    *,
    leaf_size: int = 32,
    margin: float = 1e-5,
) -> tuple[np.ndarray, dict]:
    """kNN-graph edges ∪ dual-tree Borůvka edges, sorted by (lo, hi).

    The host half of ``dualtree_graph`` (core.rng wires the device half:
    exact edge weights + the ledgered materialization).
    """
    x = np.ascontiguousarray(np.asarray(x_host, np.float64))
    n = x.shape[0]
    cd2k = knn_d2_host[:, -1].astype(np.float64)
    ix = build_index(x, np.sqrt(cd2k), leaf_size=leaf_size)
    tree_edges, stats = boruvka_tree_edges(
        ix, x, cd2k, knn_d2_host, knn_idx_host, margin=margin
    )
    p = np.repeat(np.arange(n), knn_idx_host.shape[1])
    q = knn_idx_host.astype(np.int64).ravel()
    knn_keys = np.minimum(p, q) * n + np.maximum(p, q)
    tree_keys = tree_edges[:, 0] * n + tree_edges[:, 1]
    keys = np.unique(np.concatenate([knn_keys, tree_keys]))
    edges = np.stack([keys // n, keys % n], axis=1)
    stats["m_knn_edges"] = int(len(np.unique(knn_keys)))
    stats["m_candidates"] = int(len(edges))
    return edges, stats
