"""Well-Separated Pair Decomposition with the paper's mrd-aware predicate.

A copy of ``repro/core/wspd.py`` (pure numpy host control plane).

Host-side control plane (numpy): the fair-split tree and the pair recursion
are pointer-chasing scalar work — O(n log n) node operations — which a real
accelerator deployment keeps on the host CPU.  All O(n^2)
distance work consumes the *output* of this module on device.

Well-separation (paper §IV-E, adapting Callahan-Kosaraju):

    D(A, B) >= s * max{ diam(B_A), diam(B_B), max_{p in A u B} c_kmax(p) }

where ``B_X`` is the ball circumscribing the bounding box of X and ``D`` is
the (lower-bounded) distance between the two balls.  ``s = 1``.

Termination note: with the core-distance term two *singleton* nodes can be
impossible to separate (d(a,b) < max core dist) and cannot be split further;
such pairs are emitted anyway — for singletons the pair IS its own SBCN edge,
so emitting it preserves the RNG-superset property (it only ever ADDS a
candidate edge).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FairSplitTree:
    """Array-encoded fair-split tree over a permutation of point indices."""

    perm: np.ndarray        # (n,)  point indices, contiguous per node
    start: np.ndarray       # (n_nodes,) range start into perm
    end: np.ndarray         # (n_nodes,) range end (exclusive)
    left: np.ndarray        # (n_nodes,) child id or -1
    right: np.ndarray       # (n_nodes,)
    center: np.ndarray      # (n_nodes, d) bbox center
    radius: np.ndarray      # (n_nodes,)  half bbox diagonal (ball radius)
    max_cd: np.ndarray      # (n_nodes,)  max core distance (NOT squared) in node

    @property
    def n_nodes(self) -> int:
        return self.start.shape[0]

    def points(self, u: int) -> np.ndarray:
        return self.perm[self.start[u] : self.end[u]]


def build_fair_split_tree(
    x: np.ndarray, cd_kmax: np.ndarray, *, leaf_size: int = 1
) -> FairSplitTree:
    """Midpoint-split fair-split tree; leaves hold <= ``leaf_size`` points.

    Level-synchronous build: every level processes ALL of its nodes with
    whole-array numpy (``reduceat`` over the contiguous perm ranges + one
    stable per-level partition sort), so the host control plane costs
    O(depth) vectorized passes instead of one Python iteration per node.

    ``leaf_size=1`` (the default) is the WSPD configuration (singleton
    leaves, required by the pair recursion's termination argument);
    ``core.dualtree`` builds with larger leaves so its traversals bottom out
    in batched tile evaluations instead of per-point node pairs.
    """
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be >= 1; got {leaf_size}")
    n, d = x.shape
    max_nodes = 2 * n - 1
    perm = np.arange(n)
    start = np.zeros(max_nodes, np.int64)
    end = np.zeros(max_nodes, np.int64)
    left = np.full(max_nodes, -1, np.int64)
    right = np.full(max_nodes, -1, np.int64)
    centers = np.zeros((max_nodes, d), np.float64)
    radii = np.zeros(max_nodes, np.float64)
    max_cd = np.zeros(max_nodes, np.float64)

    node_count = 1
    start[0], end[0] = 0, n
    level = np.array([0], np.int64)
    while len(level):
        s, e = start[level], end[level]                     # (L,) ranges
        xp = x[perm]                                        # level's point view
        cdp = cd_kmax[perm]
        # Segment min/max via reduceat over interleaved (start, end)
        # boundaries: level ranges are disjoint, so sorted by start the
        # boundary list is non-decreasing and the EVEN segments are exactly
        # the ranges (odd segments are inter-range gaps, discarded).
        o = np.argsort(s, kind="stable")
        so, eo = s[o], e[o]
        bounds = np.empty(2 * len(so), np.int64)
        bounds[0::2] = so
        bounds[1::2] = eo
        if bounds[-1] == n:  # reduceat boundaries must be < n; the last
            bounds = bounds[:-1]  # segment then runs to the array end anyway
        lo_o = np.minimum.reduceat(xp, bounds, axis=0)[0::2]
        hi_o = np.maximum.reduceat(xp, bounds, axis=0)[0::2]
        cd_o = np.maximum.reduceat(cdp, bounds)[0::2]
        inv = np.empty_like(o)
        inv[o] = np.arange(len(o))
        lo = lo_o[inv]
        hi = hi_o[inv]
        cdmax = cd_o[inv]

        centers[level] = (lo + hi) / 2.0
        radii[level] = 0.5 * np.sqrt(((hi - lo) ** 2).sum(axis=1))
        max_cd[level] = cdmax

        sz = e - s
        split = sz > leaf_size
        if not split.any():
            break
        sp = level[split]
        lo_s, hi_s = lo[split], hi[split]
        dim = np.argmax(hi_s - lo_s, axis=1)
        mid = 0.5 * (lo_s[np.arange(len(sp)), dim] + hi_s[np.arange(len(sp)), dim])

        # per-position node id + split params, for one vectorized partition
        L = len(sp)
        pos_node = np.full(n, -1, np.int64)          # index into sp, else -1
        reps = (e[split] - s[split]).astype(np.int64)
        pos_idx = np.repeat(s[split], reps) + _ranges_concat(reps)
        pos_node[pos_idx] = np.repeat(np.arange(L), reps)
        active = pos_node >= 0
        ai = np.nonzero(active)[0]
        anode = pos_node[ai]
        aval = x[perm[ai], dim[anode]]
        left_mask = aval <= mid[anode]
        # degenerate nodes (all/none on one side): median split by order
        n_left = np.bincount(anode, weights=left_mask, minlength=L).astype(np.int64)
        degenerate = (n_left == 0) | (n_left == reps)
        if degenerate.any():
            # stable rank of each position within its node, by (val, pos)
            order_in = np.lexsort((ai, aval, anode))
            rank = np.empty(len(ai), np.int64)
            rank[order_in] = _ranges_concat(reps)
            half = reps // 2
            med_mask = rank < half[anode]
            deg_pos = degenerate[anode]
            left_mask = np.where(deg_pos, med_mask, left_mask)
            n_left = np.bincount(anode, weights=left_mask, minlength=L).astype(np.int64)
        # stable partition: destination positions (ascending ai) group by
        # node RANGE order, so the source must sort by range start — not by
        # node index, which interleaves across the level
        new_order = np.lexsort((ai, ~left_mask, s[split][anode]))
        perm[ai] = perm[ai[new_order]]

        lid = node_count + 2 * np.arange(L)
        rid = lid + 1
        node_count += 2 * L
        left[sp], right[sp] = lid, rid
        start[lid], end[lid] = s[split], s[split] + n_left
        start[rid], end[rid] = s[split] + n_left, e[split]
        level = np.concatenate([lid, rid])

    sl = slice(0, node_count)
    return FairSplitTree(
        perm=perm,
        start=start[sl].copy(),
        end=end[sl].copy(),
        left=left[sl].copy(),
        right=right[sl].copy(),
        center=centers[sl].copy(),
        radius=radii[sl].copy(),
        max_cd=max_cd[sl].copy(),
    )


def _ranges_concat(lens: np.ndarray) -> np.ndarray:
    """concatenate([arange(l) for l in lens]) without the Python loop."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    offsets = np.repeat(np.cumsum(lens) - lens, lens)
    return out - offsets


def wspd_pairs(tree: FairSplitTree, s: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Enumerate well-separated pairs w.r.t. the mrd predicate.

    Level-synchronous vectorized search: the work list of candidate (u, v)
    node pairs is processed as whole numpy arrays per round (the recursion
    depth is O(log n + split chain), so ~tens of rounds regardless of the
    pair count).  Returns (U, V) arrays of node ids.
    """
    center, radius, max_cd = tree.center, tree.radius, tree.max_cd
    left, right = tree.left, tree.right
    size = tree.end - tree.start

    internal = np.nonzero(left != -1)[0]
    U = left[internal]
    V = right[internal]
    out_u: list[np.ndarray] = []
    out_v: list[np.ndarray] = []
    while len(U):
        # singleton-singleton pairs are emitted whether separated or not
        # (module docstring): short-circuit them before any separation math —
        # they dominate the worklist in dense regions
        ss = (size[U] == 1) & (size[V] == 1)
        if ss.any():
            out_u.append(U[ss])
            out_v.append(V[ss])
            U, V = U[~ss], V[~ss]
            if not len(U):
                break
        rU, rV = radius[U], radius[V]                       # gather once per round
        diff = center[U] - center[V]
        d_centers = np.sqrt(np.einsum("ij,ij->i", diff, diff))
        dist_lb = np.maximum(0.0, d_centers - rU - rV)
        rhs = s * np.maximum(
            2.0 * np.maximum(rU, rV), np.maximum(max_cd[U], max_cd[V])
        )
        emit = dist_lb >= rhs
        out_u.append(U[emit])
        out_v.append(V[emit])
        keep = ~emit
        U, V, rU, rV = U[keep], V[keep], rU[keep], rV[keep]
        if not len(U):
            break
        # split the "bigger" node (by ball radius, then size)
        su = (rU > rV) | ((rU == rV) & (size[U] >= size[V]))
        Us, Vs = U[su], V[su]
        Uo, Vo = U[~su], V[~su]
        U = np.concatenate([left[Us], right[Us], Uo, Uo])
        V = np.concatenate([Vs, Vs, left[Vo], right[Vo]])
    return np.concatenate(out_u), np.concatenate(out_v)
