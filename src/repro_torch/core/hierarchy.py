"""HDBSCAN* hierarchy extraction: dendrogram -> condensed tree -> clusters.

A copy of ``repro/core/hierarchy.py`` (pure numpy).  The port keeps its own
copy because the reference package imports JAX on import.

Host-side post-processing (numpy): consumes the (n-1)-edge MST produced on
device and is O(n alpha(n)) scalar work (DESIGN.md §3).  Implements the
standard HDBSCAN* machinery (Campello et al. 2013/2015):

  * ``single_linkage``  — scipy-style merge matrix Z via union-find over
    weight-sorted MST edges.
  * ``condense_tree``   — collapse the dendrogram w.r.t. ``min_cluster_size``:
    a node is a *true split* iff both children have >= mcs points; otherwise
    points "fall out" of the surviving cluster at that lambda = 1/distance.
  * ``compute_stability`` / ``extract_clusters`` — cluster selection from the
    condensed tree: excess-of-mass (FOSC, bottom-up) or condensed-tree leaves.
  * ``labels_for``      — final labels (-1 = noise) + per-point lambdas.

Two implementations coexist:

  * The *reference* path (``single_linkage`` + ``condense_tree`` +
    ``labels_for``) is the per-edge / per-row Python-loop transliteration of
    Campello et al.; it is the oracle that tests compare against.
  * The *vectorized* path (``condense_tree_fast`` + ``compute_stability_fast``
    + ``labels_for_fast``, composed by ``extract_condensed``) is pure
    numpy array work — pointer-doubling over the dendrogram instead of
    top-down recursion — and is what the production pipeline
    (``core.multi`` / ``repro_torch.api``) runs, downstream of the batched device
    linkage in ``core.linkage``.  ``tests/test_hierarchy.py`` pins the two
    paths against each other.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def single_linkage(ea: np.ndarray, eb: np.ndarray, w: np.ndarray, n: int) -> np.ndarray:
    """Union-find single linkage. Returns Z (n-1, 4): left, right, dist, size.

    Cluster ids: 0..n-1 are points; n+i is the cluster formed by row i.
    Edges must form a spanning tree; `w` are (non-squared) distances.
    """
    order = np.lexsort((np.arange(len(w)), w))
    parent = np.arange(2 * n - 1, dtype=np.int64)
    uf_label = np.arange(n, dtype=np.int64)  # current cluster label of each root
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(v):
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:  # path compression
            parent[v], v = root, parent[v]
        return root

    Z = np.zeros((n - 1, 4), np.float64)
    nxt = 0
    for ei in order:
        ra, rb = find(ea[ei]), find(eb[ei])
        if ra == rb:
            continue
        la, lb = uf_label[ra], uf_label[rb]
        new = n + nxt
        merged = size[la] + size[lb]
        Z[nxt] = (la, lb, w[ei], merged)
        size[new] = merged
        # merge union-find roots
        parent[ra] = rb
        uf_label[rb] = new
        nxt += 1
    if nxt != n - 1:
        raise ValueError(f"edge list does not span: {nxt + 1} components remain")
    return Z


@dataclasses.dataclass
class CondensedTree:
    parent: np.ndarray      # (k,) condensed parent cluster id (>= n)
    child: np.ndarray       # (k,) point id (< n) or child cluster id (>= n)
    lam: np.ndarray         # (k,) lambda = 1/dist at which child leaves parent
    child_size: np.ndarray  # (k,)
    n_points: int
    root: int               # root cluster id (== n_points)


def condense_tree(Z: np.ndarray, n: int, min_cluster_size: int) -> CondensedTree:
    """Condense a single-linkage dendrogram (hdbscan-style, iterative BFS)."""
    root = 2 * n - 2  # top merge (dendrogram id n + (n-2))
    next_label = n + 1
    relabel = {root: n}

    parents: list[int] = []
    children: list[int] = []
    lams: list[float] = []
    sizes: list[int] = []

    def node_info(node):
        """(left, right, dist, size) for dendrogram node id; points -> leaf."""
        row = Z[node - n]
        return int(row[0]), int(row[1]), float(row[2]), int(row[3])

    def node_size(node):
        return 1 if node < n else int(Z[node - n][3])

    def leaves_of(node):
        out = []
        stack = [node]
        while stack:
            v = stack.pop()
            if v < n:
                out.append(v)
            else:
                l, r, _, _ = node_info(v)
                stack.extend((l, r))
        return out

    ignore = set()
    # BFS top-down over dendrogram nodes that still carry a cluster label.
    stack = [root]
    while stack:
        node = stack.pop()
        if node in ignore or node < n:
            continue
        cur_label = relabel[node]
        left, right, dist, _ = node_info(node)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        ls, rs = node_size(left), node_size(right)

        if ls >= min_cluster_size and rs >= min_cluster_size:
            for ch, s in ((left, ls), (right, rs)):
                relabel[ch] = next_label
                parents.append(cur_label)
                children.append(next_label)
                lams.append(lam)
                sizes.append(s)
                next_label += 1
                stack.append(ch)
        else:
            for ch, s in ((left, ls), (right, rs)):
                if s >= min_cluster_size:
                    relabel[ch] = cur_label  # cluster continues under same label
                    stack.append(ch)
                else:
                    for p in leaves_of(ch):  # points fall out at this lambda
                        parents.append(cur_label)
                        children.append(p)
                        lams.append(lam)
                        sizes.append(1)
                    ignore.add(ch)

    return CondensedTree(
        parent=np.asarray(parents, np.int64),
        child=np.asarray(children, np.int64),
        lam=np.asarray(lams, np.float64),
        child_size=np.asarray(sizes, np.int64),
        n_points=n,
        root=n,
    )


def _pointer_double(ptr: np.ndarray, done: np.ndarray) -> np.ndarray:
    """Jump each pointer to its nearest ancestor with ``done[anc]`` True.

    ``ptr`` maps node -> an ancestor-or-self; entries with ``done[ptr]`` are
    fixed points.  O(log chain-length) rounds, each a vectorized gather.
    """
    for _ in range(70):  # 2^70 >> any chain length representable here
        nxt = np.where(done[ptr], ptr, ptr[ptr])
        if np.array_equal(nxt, ptr):
            return ptr
        ptr = nxt
    raise RuntimeError("pointer doubling failed to converge")


def condense_tree_fast(Z: np.ndarray, n: int, min_cluster_size: int) -> CondensedTree:
    """Vectorized ``condense_tree``: no per-node Python recursion.

    Same semantics as the reference (row order and condensed-label numbering
    may differ; both are free choices that no consumer depends on — labels
    are assigned top-down so every parent id < child id, the invariant
    ``extract_clusters`` relies on).
    """
    if min_cluster_size < 2:
        raise ValueError("condense_tree_fast requires min_cluster_size >= 2")
    n_merges = n - 1
    left = Z[:, 0].astype(np.int64)
    right = Z[:, 1].astype(np.int64)
    dist = Z[:, 2].astype(np.float64)
    n_nodes = 2 * n - 1
    root = 2 * n - 2
    merge_ids = n + np.arange(n_merges, dtype=np.int64)

    size = np.concatenate([np.ones(n, np.int64), Z[:, 3].astype(np.int64)])
    parent = np.arange(n_nodes, dtype=np.int64)  # root stays self-parented
    parent[left] = merge_ids
    parent[right] = merge_ids

    lam_m = np.full(n_merges, np.inf)
    nz = dist > 0.0
    lam_m[nz] = 1.0 / dist[nz]
    lam_node = np.concatenate([np.zeros(n), lam_m])

    # "big" nodes (>= mcs points) form a connected top subtree: sizes strictly
    # increase towards the root.  The root always carries label n even when
    # n < mcs (then every point just falls out of it).
    big = size >= min_cluster_size
    big[root] = True

    # A(p): each point's lowest big ancestor — where it falls out of the tree.
    self_ids = np.arange(n_nodes, dtype=np.int64)
    big_anc = _pointer_double(np.where(big, self_ids, parent), big)

    # True splits: both children keep >= mcs points.  Their two children are
    # the "cluster roots" — nodes where a fresh condensed label is born.
    split = big[left] & big[right]
    is_croot = np.zeros(n_nodes, bool)
    is_croot[left[split]] = True
    is_croot[right[split]] = True
    is_croot[root] = True
    croot_of = _pointer_double(np.where(is_croot, self_ids, parent), is_croot)

    # Fresh ids top-down (ancestors have strictly larger dendrogram node ids,
    # so descending node id is a topological order): root -> n, then n+1, ...
    roots_desc = np.flatnonzero(is_croot)[::-1]
    croot_label = np.full(n_nodes, -1, np.int64)
    croot_label[roots_desc] = n + np.arange(len(roots_desc))

    split_nodes = merge_ids[split]
    lc, rc = left[split], right[split]
    cl_parent = np.repeat(croot_label[croot_of[split_nodes]], 2)
    cl_child = np.stack([croot_label[lc], croot_label[rc]], axis=1).ravel()
    cl_lam = np.repeat(lam_node[split_nodes], 2)
    cl_size = np.stack([size[lc], size[rc]], axis=1).ravel()

    pts = np.arange(n, dtype=np.int64)
    fall = big_anc[pts]
    pt_parent = croot_label[croot_of[fall]]

    return CondensedTree(
        parent=np.concatenate([cl_parent, pt_parent]),
        child=np.concatenate([cl_child, pts]),
        lam=np.concatenate([cl_lam, lam_node[fall]]),
        child_size=np.concatenate([cl_size, np.ones(n, np.int64)]),
        n_points=n,
        root=n,
    )


def compute_stability(tree: CondensedTree) -> dict[int, float]:
    """Excess-of-mass stability: sum_p (lambda_p - lambda_birth(C))."""
    lam_birth: dict[int, float] = {tree.root: 0.0}
    cluster_rows = tree.child >= tree.n_points
    for p, c, l in zip(
        tree.parent[cluster_rows], tree.child[cluster_rows], tree.lam[cluster_rows]
    ):
        lam_birth[int(c)] = float(l)

    stability: dict[int, float] = {c: 0.0 for c in lam_birth}
    finite_cap = np.max(tree.lam[np.isfinite(tree.lam)], initial=1.0)
    for p, l, s in zip(tree.parent, tree.lam, tree.child_size):
        lv = float(l) if np.isfinite(l) else float(finite_cap)
        stability[int(p)] = stability.get(int(p), 0.0) + (lv - lam_birth[int(p)]) * int(s)
    return stability


def compute_stability_fast(tree: CondensedTree) -> dict[int, float]:
    """Vectorized ``compute_stability`` (identical values, no per-row loop)."""
    cluster_rows = tree.child >= tree.n_points
    cids = np.concatenate([[tree.root], tree.child[cluster_rows]]).astype(np.int64)
    births = np.concatenate([[0.0], tree.lam[cluster_rows]])
    sidx = np.argsort(cids)
    scids, sbirths = cids[sidx], births[sidx]

    finite = np.isfinite(tree.lam)
    cap = float(np.max(tree.lam[finite], initial=1.0))
    lam_eff = np.where(finite, tree.lam, cap)

    pos = np.searchsorted(scids, tree.parent)
    totals = np.zeros(len(scids))
    np.add.at(totals, pos, (lam_eff - sbirths[pos]) * tree.child_size)
    return {int(c): float(t) for c, t in zip(scids, totals)}


def _extract_leaves(tree: CondensedTree, allow_single_cluster: bool) -> list[int]:
    """Leaf selection: every condensed cluster with no child clusters."""
    cluster_rows = tree.child >= tree.n_points
    parents = set(int(p) for p in tree.parent[cluster_rows])
    clusters = {tree.root} | set(int(c) for c in tree.child[cluster_rows])
    leaves = sorted(
        c for c in clusters
        if c not in parents and (c != tree.root or allow_single_cluster)
    )
    if not leaves and allow_single_cluster:
        return [tree.root]
    return leaves


def _epsilon_merge(
    tree: CondensedTree,
    selected: list[int],
    epsilon: float,
    allow_single_cluster: bool,
) -> list[int]:
    """Malzer & Baum's epsilon threshold over an already-selected set.

    A selected cluster born at distance < epsilon (birth lambda >
    1/epsilon) is merged upward into its first ancestor born at a distance
    >= epsilon; clusters already epsilon-stable pass through.  Climbing
    stops below the root unless ``allow_single_cluster`` (then the root
    itself can absorb everything) — the hdbscan ``traverse_upwards``
    convention.  Descendants of a kept ancestor are dropped, so the result
    is again an antichain of the condensed tree.
    """
    if epsilon <= 0.0 or not selected:
        return selected
    cluster_rows = tree.child >= tree.n_points
    parent_of = {
        int(c): int(p)
        for p, c in zip(tree.parent[cluster_rows], tree.child[cluster_rows])
    }
    birth = {
        int(c): float(l)
        for c, l in zip(tree.child[cluster_rows], tree.lam[cluster_rows])
    }

    def eps_of(c: int) -> float:
        lam = birth.get(c, 0.0)  # the root is born at lambda 0 -> eps inf
        return np.inf if lam <= 0.0 else 1.0 / lam

    kept: set[int] = set()
    for c in selected:
        if eps_of(c) >= epsilon:
            kept.add(c)
            continue
        cur = c
        while True:
            par = parent_of.get(cur)
            if par is None:  # cur IS the root (only selectable w/ single ok)
                kept.add(cur)
                break
            if par == tree.root and not allow_single_cluster:
                kept.add(cur)  # closest-to-root node below the forbidden root
                break
            if eps_of(par) >= epsilon:
                kept.add(par)
                break
            cur = par
    # drop any kept cluster that has a kept strict ancestor
    out = []
    for c in sorted(kept):
        anc = parent_of.get(c)
        while anc is not None and anc not in kept:
            anc = parent_of.get(anc)
        if anc is None:
            out.append(c)
    return out


def extract_clusters(
    tree: CondensedTree,
    stability: dict[int, float],
    *,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
    cluster_selection_epsilon: float = 0.0,
) -> list[int]:
    """Cluster selection; returns selected condensed cluster ids.

    ``"eom"`` is FOSC bottom-up excess-of-mass (the HDBSCAN* default);
    ``"leaf"`` takes the leaves of the condensed tree — many small
    fine-grained clusters.  A positive ``cluster_selection_epsilon`` then
    applies Malzer & Baum's hybrid threshold on top of either method:
    selected clusters born at a distance below epsilon are merged upward
    into their first epsilon-stable ancestor (see ``_epsilon_merge``).
    """
    if cluster_selection_method == "leaf":
        return _epsilon_merge(
            tree,
            _extract_leaves(tree, allow_single_cluster),
            cluster_selection_epsilon,
            allow_single_cluster,
        )
    if cluster_selection_method != "eom":
        raise ValueError(
            f"cluster_selection_method must be 'eom' or 'leaf'; "
            f"got {cluster_selection_method!r}"
        )
    children_of: dict[int, list[int]] = {}
    cluster_rows = tree.child >= tree.n_points
    for p, c in zip(tree.parent[cluster_rows], tree.child[cluster_rows]):
        children_of.setdefault(int(p), []).append(int(c))

    clusters = sorted(stability.keys(), reverse=True)  # children have larger ids
    selected = {c: True for c in clusters}
    subtree_val = dict(stability)
    for c in clusters:
        kids = children_of.get(c, [])
        if not kids:
            continue
        kid_sum = sum(subtree_val[k] for k in kids)
        if kid_sum > stability[c] or (c == tree.root and not allow_single_cluster):
            selected[c] = False
            subtree_val[c] = kid_sum
        else:
            # select c; deselect entire subtree below
            stack = list(kids)
            while stack:
                k = stack.pop()
                selected[k] = False
                stack.extend(children_of.get(k, []))
    if not allow_single_cluster:
        selected[tree.root] = False
    return _epsilon_merge(
        tree,
        [c for c in clusters if selected[c]],
        cluster_selection_epsilon,
        allow_single_cluster,
    )


def labels_for(tree: CondensedTree, selected: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """Per-point labels (-1 noise) and the lambda at which each point departs."""
    n = tree.n_points
    labels = np.full(n, -1, np.int64)
    lam_pt = np.zeros(n, np.float64)

    sel = set(selected)
    # map each condensed cluster to its selected ancestor (or -1)
    parent_of: dict[int, int] = {}
    cluster_rows = tree.child >= n
    for p, c in zip(tree.parent[cluster_rows], tree.child[cluster_rows]):
        parent_of[int(c)] = int(p)

    def selected_ancestor(c: int) -> int:
        while True:
            if c in sel:
                return c
            if c not in parent_of:
                return -1
            c = parent_of[c]

    cache: dict[int, int] = {}
    point_rows = ~cluster_rows
    label_ids = {c: i for i, c in enumerate(sorted(sel))}
    for p, c, l in zip(
        tree.parent[point_rows], tree.child[point_rows], tree.lam[point_rows]
    ):
        p = int(p)
        if p not in cache:
            cache[p] = selected_ancestor(p)
        anc = cache[p]
        if anc != -1:
            labels[int(c)] = label_ids[anc]
            lam_pt[int(c)] = l
    return labels, lam_pt


def labels_for_fast(
    tree: CondensedTree, selected: list[int]
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``labels_for``: same labels, no per-point Python loop."""
    n = tree.n_points
    labels = np.full(n, -1, np.int64)
    lam_pt = np.zeros(n, np.float64)

    cluster_rows = tree.child >= n
    cids = np.concatenate([[tree.root], tree.child[cluster_rows]]).astype(np.int64)
    cpar = np.concatenate([[-1], tree.parent[cluster_rows]]).astype(np.int64)
    n_c = len(cids)
    sidx = np.argsort(cids)
    scids = cids[sidx]

    def to_idx(ids):
        return sidx[np.searchsorted(scids, ids)]

    # compact parent pointers, with index n_c as an absorbing "no ancestor"
    par_idx = np.full(n_c + 1, n_c, np.int64)
    has_par = cpar >= 0
    par_idx[:n_c][has_par] = to_idx(cpar[has_par])

    sel_mask = np.zeros(n_c + 1, bool)
    if selected:
        sel_mask[to_idx(np.asarray(selected, np.int64))] = True

    done = sel_mask.copy()
    done[n_c] = True  # the sentinel is a fixed point
    ptr = _pointer_double(
        np.where(done, np.arange(n_c + 1, dtype=np.int64), par_idx), done
    )

    # label numbering matches the reference: sorted selected ids -> 0..k-1
    anc_label = np.full(n_c + 1, -1, np.int64)
    for rank, c in enumerate(sorted(selected)):
        anc_label[to_idx(np.int64(c))] = rank

    point_rows = ~cluster_rows
    lab = anc_label[ptr[to_idx(tree.parent[point_rows])]]
    children = tree.child[point_rows]
    labels[children] = lab
    lam_pt[children] = np.where(lab >= 0, tree.lam[point_rows], 0.0)
    return labels, lam_pt


def extract_condensed(
    Z: np.ndarray,
    n: int,
    min_cluster_size: int,
    *,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
) -> tuple[np.ndarray, CondensedTree, dict[int, float]]:
    """Vectorized merge-matrix -> (labels, condensed tree, stability)."""
    tree = condense_tree_fast(Z, n, min_cluster_size)
    stability = compute_stability_fast(tree)
    selected = extract_clusters(
        tree,
        stability,
        allow_single_cluster=allow_single_cluster,
        cluster_selection_method=cluster_selection_method,
    )
    labels, _ = labels_for_fast(tree, selected)
    return labels, tree, stability


def hdbscan_labels(
    ea: np.ndarray,
    eb: np.ndarray,
    w: np.ndarray,
    n: int,
    min_cluster_size: int,
    *,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
) -> tuple[np.ndarray, CondensedTree, dict[int, float]]:
    """MST edges -> (labels, condensed tree, stability). `w` = real distances.

    This is the *reference* (per-edge Python loop) path, kept as the oracle;
    the production pipeline runs ``core.linkage.single_linkage_batch`` +
    ``extract_condensed`` instead.
    """
    Z = single_linkage(ea, eb, w, n)
    tree = condense_tree(Z, n, min_cluster_size)
    stability = compute_stability(tree)
    selected = extract_clusters(
        tree,
        stability,
        allow_single_cluster=allow_single_cluster,
        cluster_selection_method=cluster_selection_method,
    )
    labels, _ = labels_for(tree, selected)
    return labels, tree, stability
