"""Batched single-linkage dendrograms (extraction, stage 1), the port of
``repro/core/linkage.py``.

The reference runs a union-find ``fori_loop`` over the n-1 weight-sorted
edges on the device, vmapped across the R hierarchies.  Here the same
union-find runs in numpy on the host, vectorised over the R rows: one
Python step per merge, each a handful of (R,)-wide array operations.  The
MST arrays are already on the host when extraction starts (the ``mst``
sync of ``core.multi.fit_msts``), so this costs no transfer; a device
version is later work.

Output follows the scipy linkage convention used by ``core.hierarchy``:
cluster ids 0..n-1 are points, ``n + i`` is the cluster born at merge row
``i``; rows are ordered by ascending merge height, stable in the input
edge order.  Union by size keeps every find at most ``log2 n`` steps, and
the winner/loser rule (``size(ra) >= size(rb)`` keeps ``ra``) is the
reference's, so the arrays are equal to its output.

Precondition: every row of ``(ea, eb)`` is a spanning tree of the n points;
``validate_spanning`` is a host check for external callers.
"""

from __future__ import annotations

import numpy as np


def _find(parent: np.ndarray, rows: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Union-find roots of ``v`` (one vertex per row), read-only walk."""
    r = v.copy()
    while True:
        p = parent[rows, r]
        moving = p != r
        if not moving.any():
            return r
        r = np.where(moving, p, r)


def single_linkage_batch(ea, eb, w, *, n: int):
    """Dendrograms for a batch of spanning trees.

    Args:
      ea, eb: (R, n-1) integer endpoints; each row a spanning tree over n points.
      w: (R, n-1) non-negative merge weights (real, not squared, distances).
      n: number of points.
    Returns:
      (left, right, height, size), each (R, n-1) (int32, int32, w's dtype,
      int32): scipy-convention merge rows sorted by ascending height.
    """
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    w = np.asarray(w)
    R, n_merges = w.shape
    order = np.argsort(w, axis=1, kind="stable")
    ea_s = np.take_along_axis(ea, order, axis=1).astype(np.int64)
    eb_s = np.take_along_axis(eb, order, axis=1).astype(np.int64)
    w_s = np.take_along_axis(w, order, axis=1)

    rows = np.arange(R)
    parent = np.tile(np.arange(n, dtype=np.int64), (R, 1))
    label = parent.copy()
    csize = np.ones((R, n), np.int64)
    left = np.zeros((R, n_merges), np.int32)
    right = np.zeros((R, n_merges), np.int32)
    size = np.zeros((R, n_merges), np.int32)
    for i in range(n_merges):
        ra = _find(parent, rows, ea_s[:, i])
        rb = _find(parent, rows, eb_s[:, i])
        sa, sb = csize[rows, ra], csize[rows, rb]
        left[:, i] = label[rows, ra]
        right[:, i] = label[rows, rb]
        size[:, i] = sa + sb
        a_wins = sa >= sb
        winner = np.where(a_wins, ra, rb)
        loser = np.where(a_wins, rb, ra)
        parent[rows, loser] = winner
        label[rows, winner] = n + i
        csize[rows, winner] = sa + sb
    return left, right, w_s, size


def linkage_to_Z(left, right, height, size) -> np.ndarray:
    """Pack one row's merge arrays into a scipy-style (n-1, 4) float64 Z."""
    return np.stack(
        [
            np.asarray(left, np.float64),
            np.asarray(right, np.float64),
            np.asarray(height, np.float64),
            np.asarray(size, np.float64),
        ],
        axis=-1,
    )


def validate_spanning(ea: np.ndarray, eb: np.ndarray, n: int) -> None:
    """Raise ValueError unless (ea, eb) is a spanning tree of n vertices."""
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    if ea.shape != (n - 1,) or eb.shape != (n - 1,):
        raise ValueError(f"expected {n - 1} edges, got {ea.shape} / {eb.shape}")
    parent = np.arange(n)

    def find(v):
        while parent[v] != v:
            parent[v] = parent[parent[v]]
            v = parent[v]
        return v

    merges = 0
    for a, b in zip(ea, eb):
        ra, rb = find(a), find(b)
        if ra == rb:
            raise ValueError("edge list contains a cycle")
        parent[ra] = rb
        merges += 1
    if merges != n - 1:
        raise ValueError("edge list does not span")
