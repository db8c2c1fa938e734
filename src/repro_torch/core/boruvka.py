"""Minimum spanning trees over an explicit edge list: batched Borůvka, the
port of ``repro/core/boruvka.py``.

``boruvka_mst_range`` computes the MST of every mpts row of a (R, m) weight
matrix at once.  Each row's edges are ranked once by the lexicographic
(w, edge id) key, so the chosen MST is unique even though mrd weights tie
often (every edge whose weight is a shared core distance ties), and every
round is one scatter-min of ranks per (row, component) over a flat
(R * n) buffer.  ``boruvka_mst`` is the single-row case.

The reference's ``lax.while_loop``s become Python loops whose conditions
are device->host syncs.  The pointer jumping needs none: a parent forest
over n vertices is flat after ``ceil(log2 n)`` jumps, so that many run
unconditionally.  The outer loop syncs once per round on its stop test
(``any row still has > 1 component and some row progressed``); Borůvka
halves the component count of every row each round, so there are at most
``ceil(log2 n) + 1`` such syncs, capped at 64 rounds as in the reference.
"""

from __future__ import annotations

import math

import torch

from ..kernels.prim_mst import prim_mst


def _rank_keys(w_range: torch.Tensor):
    """(R, m) weights -> (order, rank): each row's edge ids sorted by the
    (w, edge id) key, and the inverse permutation."""
    R, m = w_range.shape
    wf = w_range.float()
    # lint: allow[float-eq] -0.0 == 0.0 is True by IEEE-754, exactly the property used to fold both zeros to +0.0 before the bitcast sort keys
    wf = torch.where(wf == 0.0, torch.zeros_like(wf), wf)
    # non-negative f32 bit patterns order as their int32 views; the edge id
    # in the low 32 bits breaks ties, as the reference's two-key sort does
    key = (wf.view(torch.int32).long() << 32) | torch.arange(m, device=wf.device)
    order = torch.argsort(key, dim=1)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(m, device=wf.device).expand(R, m).contiguous())
    return order, rank


def boruvka_mst_range(ea: torch.Tensor, eb: torch.Tensor, w_range: torch.Tensor, *, n: int,
                      rounds: int | None = None):
    """MSTs for every row at once: w_range (R, m) -> in_mst (R, m) bool.

    ``ea``/``eb`` are (m,) endpoints shared by all rows.  A disconnected
    edge list stops when no row makes progress and returns fewer than
    ``n - 1`` edges in the rows it could not span.  ``rounds`` runs that
    many rounds with no stop test (no sync): the dry run traces one round
    on tensors that hold no values (``launch.cluster``).
    """
    R, m = w_range.shape
    dev = w_range.device
    ea, eb = ea.long(), eb.long()
    order, rank = _rank_keys(w_range)
    big = m
    iota_n = torch.arange(n, device=dev).expand(R, n)
    flat_off = (torch.arange(R, device=dev) * n)[:, None]
    jumps = max(1, math.ceil(math.log2(max(n, 2))))

    comp = iota_n.clone()
    in_mst = torch.zeros((R, m + 1), dtype=torch.bool, device=dev)
    for _ in range(64 if rounds is None else rounds):
        ca = comp[:, ea]                                            # (R, m)
        cb = comp[:, eb]
        rk = torch.where(ca != cb, rank, big)
        best = torch.full((R * n,), big, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, (flat_off + ca).reshape(-1), rk.reshape(-1), "amin")
        best.scatter_reduce_(0, (flat_off + cb).reshape(-1), rk.reshape(-1), "amin")
        best = best.view(R, n)
        has = best < big
        eidx = order.gather(1, torch.where(has, best, 0))
        pa = comp.gather(1, ea[eidx])
        pb = comp.gather(1, eb[eidx])
        parent = torch.where(has, torch.where(pa == iota_n, pb, pa), iota_n)
        # break mutual pairs: keep the smaller id as root
        pp = parent.gather(1, parent)
        parent = torch.where((pp == iota_n) & (iota_n < parent), iota_n, parent)
        for _ in range(jumps):
            parent = parent.gather(1, parent)
        in_mst.scatter_(1, torch.where(has, eidx, m), True)
        comp = parent.gather(1, comp)
        if rounds is not None:
            continue
        n_comp = (comp == iota_n).sum(dim=1)
        if not bool(((n_comp > 1).any() & has.any()).item()):
            break
    return in_mst[:, :m]


def boruvka_mst(ea: torch.Tensor, eb: torch.Tensor, w: torch.Tensor, *, n: int):
    """MST of one weighted edge list: (m,) bool mask of MST edges."""
    return boruvka_mst_range(ea, eb, w[None, :], n=n)[0]


def prim_dense_mst(x: torch.Tensor, cd2_col: torch.Tensor):
    """Prim's MST over the implicit complete mrd graph for ONE mpts: the
    paper's baseline unit of work, O(n^2) mrd evaluations, one row per step,
    nothing materialized.

    Returns (src (n,) int32, w2 (n,) float32): for each vertex v != 0 the
    MST edge (src[v], v) with squared mrd weight w2[v]; w2[0] = 0.  Runs
    the ``prim_mst`` kernel for tensors on the card and its plain version
    for tensors on the CPU.
    """
    return prim_mst(x, cd2_col)
