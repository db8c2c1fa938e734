"""Batched single-linkage dendrograms (extraction, stage 1), the port of
``repro/core/linkage.py``.

The reference runs a union-find ``fori_loop`` over the n-1 weight-sorted
edges on the device, vmapped across the R hierarchies.  Here the same
loop runs on the device of the arrays it is given: a stable per-row sort
by (weight, edge id) in torch ops, then, on the card, the
``single_linkage`` kernel (one thread block per row) and, on the CPU, its
plain version (one Python step per merge, (R,)-wide torch ops).

Output follows the scipy linkage convention used by ``core.hierarchy``:
cluster ids 0..n-1 are points, ``n + i`` is the cluster born at merge row
``i``; rows are ordered by ascending merge height, stable in the input
edge order.  Union by size keeps every find at most ``log2 n`` steps, and
the winner/loser rule (``size(ra) >= size(rb)`` keeps ``ra``) is the
reference's, so the arrays are equal to its output.

Precondition: every row of ``(ea, eb)`` is a spanning tree of the n points;
``validate_spanning`` is a host check for external callers.
``same_single_linkage`` compares two MSTs of one graph up to their
tie-breaks, and ``random_spanning_trees`` makes seeded inputs for the
linkage kernel's checks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.single_linkage import single_linkage


def single_linkage_batch(ea, eb, w, *, n: int):
    """Dendrograms for a batch of spanning trees, on the device of the
    tensors given (numpy arrays run on the CPU).

    Args:
      ea, eb: (R, n-1) integer endpoints; each row a spanning tree over n points.
      w: (R, n-1) non-negative merge weights (real, not squared, distances).
      n: number of points.
    Returns:
      (left, right, height, size), each an (R, n-1) tensor on that device
      (int32, int32, w's dtype, int32): scipy-convention merge rows sorted
      by ascending height.
    """
    w = torch.as_tensor(w)
    ea = torch.as_tensor(ea, device=w.device)
    eb = torch.as_tensor(eb, device=w.device)
    # stable: equal weights keep their edge order, as the reference's
    # two-key (w, edge id) sort does
    height, order = torch.sort(w, dim=1, stable=True)
    left, right, size = single_linkage(ea.gather(1, order), eb.gather(1, order), n=n)
    return left, right, height, size


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


def same_single_linkage(tree_a, tree_b, n: int) -> bool:
    """Whether two spanning trees ``(ea, eb, w)`` of n points carry equal
    weight multisets and give the same single-linkage partition at every
    height.  Any two MSTs of one weighted graph do, whichever edges their
    tie-breaks picked.  After each group of equal weights, every edge of
    the group in one tree must join points the other tree has joined."""
    (a1, b1, w1), (a2, b2, w2) = tree_a, tree_b
    o1, o2 = np.argsort(w1, kind="stable"), np.argsort(w2, kind="stable")
    ws = np.asarray(w1)[o1]
    if not np.array_equal(ws, np.asarray(w2)[o2]):
        return False
    trees = ((np.asarray(a1)[o1], np.asarray(b1)[o1]), (np.asarray(a2)[o2], np.asarray(b2)[o2]))
    parents = (np.arange(n), np.arange(n))

    def find(p, v):
        while p[v] != v:
            p[v] = p[p[v]]
            v = p[v]
        return v

    starts = np.flatnonzero(np.r_[True, ws[1:] != ws[:-1]])
    for i, j in zip(starts, np.r_[starts[1:], len(ws)]):
        for (a, b), p in zip(trees, parents):
            for k in range(i, j):
                p[find(p, a[k])] = find(p, b[k])
        for (a, b), p in zip(trees, parents[::-1]):
            if any(find(p, a[k]) != find(p, b[k]) for k in range(i, j)):
                return False
    return True


def random_spanning_trees(n: int, rows: int, seed: int, ties: bool):
    """``rows`` random spanning trees over n points, (R, n-1) int32
    endpoints and float32 weights in a random edge order; with ``ties`` the
    weights come from {0, 0.5, 1} (a third of them zero)."""
    rng = np.random.default_rng(seed)
    ea, eb, w = [], [], []
    for _ in range(rows):
        perm = rng.permutation(n)
        a = perm[(rng.random(n - 1) * np.arange(1, n)).astype(np.int64)]
        b = perm[1:]
        order = rng.permutation(n - 1)
        ea.append(a[order])
        eb.append(b[order])
        w.append(rng.choice([0.0, 0.5, 1.0], n - 1) if ties else rng.uniform(0.1, 5.0, n - 1))
    return np.stack(ea).astype(np.int32), np.stack(eb).astype(np.int32), np.stack(w).astype(np.float32)
