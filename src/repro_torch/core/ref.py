"""Numpy/scipy oracles for the paper's constructions (a copy of
``repro/core/ref.py``; the pipeline never calls them, tests and
``chip_smoke.py`` do).

These implement the DEFINITIONS directly (O(n^2)/O(n^3)) and are the ground
truth for: core distances, mrd, the RNG (Def. 1), MSTs of G_mpts, and the
naive per-mpts HDBSCAN* baseline.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import minimum_spanning_tree


def pairwise_d(x: np.ndarray) -> np.ndarray:
    d2 = (
        np.sum(x**2, -1)[:, None]
        + np.sum(x**2, -1)[None, :]
        - 2.0 * x @ x.T
    )
    return np.sqrt(np.maximum(d2, 0.0))


def core_distances(x: np.ndarray, kmax: int) -> np.ndarray:
    """(n, kmax): column j-1 = c_j = distance to j-th NN *including self*."""
    d = pairwise_d(x)
    ds = np.sort(d, axis=1)  # column 0 is the self distance (0)
    return ds[:, :kmax]


def mrd_matrix(x: np.ndarray, mpts: int, cd: np.ndarray | None = None) -> np.ndarray:
    """Dense mutual-reachability matrix for one mpts (Eq. 1)."""
    d = pairwise_d(x)
    if cd is None:
        cd = core_distances(x, mpts)
    c = cd[:, mpts - 1]
    m = np.maximum(np.maximum(c[:, None], c[None, :]), d)
    np.fill_diagonal(m, 0.0)
    return m


def rng_naive(m: np.ndarray) -> np.ndarray:
    """Exact RNG adjacency for a dense distance matrix (Def. 1), O(n^3).

    Edge (a,b) iff  m[a,b] <= max(m[a,c], m[b,c]) for all c != a, b.
    """
    n = m.shape[0]
    mx = np.maximum(m[:, None, :], m[None, :, :])  # (a, b, c)
    # exclude c == a and c == b from the min
    eye = np.eye(n, dtype=bool)
    excl = eye[:, None, :] | eye[None, :, :]
    mx = np.where(excl, np.inf, mx)
    lune_min = mx.min(axis=2)
    adj = m <= lune_min
    np.fill_diagonal(adj, False)
    return adj


def mst_weights(m: np.ndarray) -> np.ndarray:
    """Sorted MST edge weights of a dense graph (unique multiset for any MST)."""
    t = minimum_spanning_tree(csr_matrix(m))
    return np.sort(t.data)


def mst_weights_edge_list(
    ea: np.ndarray, eb: np.ndarray, w: np.ndarray, n: int
) -> np.ndarray:
    """Sorted MST edge weights of an explicit edge-list graph (scipy).

    NB: scipy's csr_matrix SUMS duplicate entries; multigraph edges must be
    deduplicated to their minimum weight first.
    """
    lo = np.minimum(ea, eb).astype(np.int64)
    hi = np.maximum(ea, eb).astype(np.int64)
    key = lo * n + hi
    order = np.lexsort((w, key))
    key_s, w_s = key[order], w[order]
    first = np.concatenate([[True], np.diff(key_s) != 0])
    key_u, w_u = key_s[first], w_s[first]
    g = csr_matrix((w_u, (key_u // n, key_u % n)), shape=(n, n))
    t = minimum_spanning_tree(g)
    return np.sort(t.data)


def mst_edges_dense(m: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ea, eb, w) MST edges of a dense graph via scipy."""
    t = minimum_spanning_tree(csr_matrix(m)).tocoo()
    return t.row, t.col, t.data
