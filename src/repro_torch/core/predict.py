"""Batched out-of-sample prediction over the fitted multi-MST state, the
port of ``repro/core/predict.py``.

The fitted state answers queries about points it has never seen, for
every fitted mpts row at once (McInnes & Healy's ``approximate_predict``,
batched across the density range):

  fitted state (X, cd2, condensed trees)   +   query batch Q (q, d)
    │  plan.query_knn(Q, X, kmax-1)      one cross-set pass on the device:
    ▼                                    the (kmax-1)-NN list gives every
  qd2, qidx (q, kmax-1)                  query core distance c_m(Q)
    │  attach (torch ops)                per mpts row r: query core distance,
    ▼                                    mutual reachability to each fitted
  lambdas, neighbors (R, q)              neighbour, argmin attach   ⇣predict
    │  per-mpts condensed-tree walk     host, vectorized over queries: climb
    ▼                                   from the attachment point's departure
  labels, probabilities (R, q)          cluster to the first cluster alive at
                                        lambda_q, then to its selected ancestor

The prediction is approximate in the standard sense: the query is ranked
against the fitted tree without refitting.  The host walk is a copy of the
reference's numpy code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import engine
from .multi import HierarchyResult, MultiMSTResult


@dataclasses.dataclass
class PredictResult:
    """Per-mpts out-of-sample assignments for one query batch.

    Row ``i`` of each array corresponds to ``mpts_values[i]``; columns are
    query points.  ``labels`` match the fitted labelling of that mpts level
    (-1 = noise), ``probabilities`` are hdbscan-style cluster membership
    strengths in [0, 1], ``lambdas`` the density level at which each query
    attaches, and ``neighbors`` the fitted point it attaches through.
    """

    mpts_values: list[int]
    labels: np.ndarray         # (R, q) int64
    probabilities: np.ndarray  # (R, q) float64
    lambdas: np.ndarray        # (R, q) float64
    neighbors: np.ndarray      # (R, q) int64

    def row(self, mpts: int) -> tuple[np.ndarray, np.ndarray]:
        """(labels, probabilities) at one density level."""
        r = self.mpts_values.index(mpts)
        return self.labels[r], self.probabilities[r]


# ---------------------------------------------------------------------------
# Device stage: query kNN -> per-row attachment
# ---------------------------------------------------------------------------


def _attach(qd2, qidx, cd2, mcol):
    """Per-row attachment of a query batch: ``(lam, nbr)``, each (R, q).

    ``qd2``/``qidx`` (q, kq) are the queries' fitted neighbours, ``cd2``
    (n, kmax) the fitted squared core distances, ``mcol`` (R,) the mpts
    column of each row.  The reference compiles this body once per query
    bucket; the port runs it eagerly at the batch's own size.
    """
    q = qd2.shape[0]
    # query core distances: col m-1 = c_m(q)^2 (c_1 = 0, paper convention)
    qcd2 = torch.cat([torch.zeros((q, 1), dtype=qd2.dtype, device=qd2.device), qd2], dim=1)
    qc = qcd2[:, mcol]                                   # (q, R)
    nc = cd2[qidx.long()][:, :, mcol]                    # (q, kq, R)
    mrd2 = torch.maximum(torch.maximum(qd2[:, :, None], qc[:, None, :]), nc)
    # argmin takes the first occurrence and qd2 ascends, so mrd ties resolve
    # to the nearest fitted neighbour, as the reference's argmin does
    j = torch.argmin(mrd2, dim=1)                        # (q, R)
    best = mrd2.gather(1, j[:, None, :])[:, 0, :]
    nbr = qidx.gather(1, j)
    # 1/sqrt in float64, rounded once to float32: the same bits on every
    # device.  XLA compiles the reference's 1/sqrt on the CPU to the CPU's
    # approximate reciprocal square root plus two Newton steps, whose bits
    # depend on the CPU model; lambdas agree with it to one float32 ulp.
    lam = torch.where(best > 0.0, (1.0 / torch.sqrt(best.double())).float(), torch.inf)
    return lam.T, nbr.T


def attach_queries(
    xq,
    x,
    cd2,
    mpts_values: Sequence[int],
    *,
    plan: "engine.Plan",
) -> tuple[np.ndarray, np.ndarray]:
    """Query kNN + mutual-reachability attachment for every mpts row at once.

    Args:
      xq:  (q, d) query batch.
      x:   (n, d) fitted points.
      cd2: (n, kmax) squared core distances of the fitted points.
    Returns:
      (lambdas, neighbors), each (R, q): the density level at which each
      query joins the tree of mpts row r, and the fitted point it attaches
      through (its mutual-reachability argmin neighbour).  One sync, under
      the ``predict`` tag.
    """
    dev = torch.device(plan.device)
    xq_t, x_t, cd2_t = (torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in (xq, x, cd2))
    qd2, qidx = plan.query_knn(xq_t, x_t, cd2_t.shape[1] - 1)
    mcol = torch.as_tensor(np.asarray(mpts_values, np.int64) - 1).to(dev)
    return engine.to_host(_attach(qd2, qidx, cd2_t, mcol), "predict")


# ---------------------------------------------------------------------------
# Host stage: condensed-tree walk
# ---------------------------------------------------------------------------


def _label_max_lambda(
    labels: np.ndarray, point_lambda: np.ndarray, n_labels: int
) -> np.ndarray:
    """Deepest finite departure lambda per selected label (0 if none)."""
    max_lam = np.zeros(max(n_labels, 1))
    finite = (labels >= 0) & np.isfinite(point_lambda)
    np.maximum.at(max_lam, labels[finite], point_lambda[finite])
    return max_lam


def _strength(lam: np.ndarray, max_lam: np.ndarray) -> np.ndarray:
    """hdbscan-style membership strength: lambda relative to the cluster's
    deepest departure, clipped to [0, 1].  ``max_lam`` is finite by
    construction (zeros + finite maxima); a cluster with no finite contrast
    (all departures at lambda 0 or inf) gives full membership."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(max_lam > 0.0, np.clip(lam / max_lam, 0.0, 1.0), 1.0)


@dataclasses.dataclass
class WalkTable:
    """Per-mpts walk state, derived once from a HierarchyResult.

    Compact cluster indices (0..C-1, root first — the condensed labelling
    assigns every parent a smaller id than its children, so ascending id is
    a topological order).
    """

    pt_cluster: np.ndarray  # (n,) compact idx of the cluster each point departs
    parent: np.ndarray      # (C,) compact parent idx (root points to itself)
    birth: np.ndarray       # (C,) lambda at which the cluster was born
    sel_label: np.ndarray   # (C,) label of the nearest selected ancestor, or -1
    max_lam: np.ndarray     # (L,) finite-capped max departure lambda per label
    root: int               # compact idx of the root (== 0)


def build_walk_table(h: HierarchyResult) -> WalkTable:
    """Flatten one condensed tree into the arrays the query walk needs."""
    tree = h.condensed
    n = tree.n_points
    cluster_rows = tree.child >= n
    cids = np.concatenate([[tree.root], tree.child[cluster_rows]]).astype(np.int64)
    scids = cids[np.argsort(cids)]
    C = len(scids)

    def to_idx(ids):
        return np.searchsorted(scids, ids)

    parent = np.arange(C, dtype=np.int64)
    birth = np.zeros(C)
    ci = to_idx(tree.child[cluster_rows])
    parent[ci] = to_idx(tree.parent[cluster_rows])
    birth[ci] = tree.lam[cluster_rows]
    root = int(to_idx(np.int64(tree.root)))

    # nearest selected ancestor: ascending compact idx is top-down, so one
    # pass suffices (the root's parent is itself, resolved first)
    sel_rank = {c: i for i, c in enumerate(sorted(h.selected))}
    sel_label = np.full(C, -1, np.int64)
    for i in range(C):
        own = sel_rank.get(int(scids[i]), -1)
        sel_label[i] = own if own >= 0 else (sel_label[parent[i]] if i != root else -1)

    point_rows = ~cluster_rows
    pt_cluster = np.zeros(n, np.int64)
    pt_cluster[tree.child[point_rows]] = to_idx(tree.parent[point_rows])

    max_lam = _label_max_lambda(h.labels, np.asarray(h.point_lambda), len(sel_rank))
    return WalkTable(
        pt_cluster=pt_cluster,
        parent=parent,
        birth=birth,
        sel_label=sel_label,
        max_lam=max_lam,
        root=root,
    )


def walk_queries(
    table: WalkTable, neighbors: np.ndarray, lambdas: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Condensed-tree walk for one mpts row, vectorized over the query batch.

    Each query starts at the cluster its attachment point departs from and
    climbs while that cluster was born at a *higher* density than the query
    reaches (birth lambda > lambda_q).  The landing cluster's nearest
    selected ancestor is the label; membership probability compares
    lambda_q against the cluster's deepest departure (hdbscan-style).
    """
    c = table.pt_cluster[neighbors]
    while True:
        move = (table.birth[c] > lambdas) & (c != table.root)
        if not move.any():
            break
        c = np.where(move, table.parent[c], c)
    labels = table.sel_label[c]

    probs = np.zeros(len(labels))
    member = labels >= 0
    probs[member] = _strength(lambdas[member], table.max_lam[labels[member]])
    return labels, probs


def membership_probabilities(h: HierarchyResult) -> np.ndarray:
    """Per-fitted-point cluster membership strength in [0, 1] (0 = noise):
    a point's departure lambda relative to the deepest (finite) departure
    in its cluster."""
    lam_pt = np.asarray(h.point_lambda)
    probs = np.zeros(len(h.labels))
    member = h.labels >= 0
    if not member.any():
        return probs
    max_lam = _label_max_lambda(h.labels, lam_pt, int(h.labels.max()) + 1)
    probs[member] = _strength(lam_pt[member], max_lam[h.labels[member]])
    return probs


# ---------------------------------------------------------------------------
# Range driver
# ---------------------------------------------------------------------------


def validate_queries(xq: np.ndarray, n_features: int | None = None) -> None:
    """Reject malformed query batches with a usable message: a NaN
    coordinate never compares, so it would silently pick arbitrary
    neighbours."""
    if xq.ndim != 2:
        raise ValueError(f"Q must be 2-d (n_queries, n_features); got {xq.shape}")
    if n_features is not None and xq.shape[1] != n_features:
        raise ValueError(f"Q must be 2-d with {n_features} features; got {xq.shape}")
    if xq.size and not np.isfinite(xq).all():
        bad = ~np.isfinite(xq)
        rows = np.flatnonzero(bad.any(axis=1))
        raise ValueError(
            f"Q contains {int(bad.sum())} non-finite value(s) (NaN or inf) "
            f"in {len(rows)} row(s), first at row {int(rows[0])}"
        )


def predict_range(
    msts: MultiMSTResult,
    x,
    xq,
    hierarchy_for: Callable[[int], HierarchyResult],
    *,
    plan: "engine.Plan",
    mpts_values: Sequence[int] | None = None,
    table_cache: dict[int, WalkTable] | None = None,
) -> PredictResult:
    """Out-of-sample assignment of a query batch for every requested mpts.

    ``hierarchy_for`` supplies (typically cached) per-mpts extractions;
    ``table_cache`` (optional, mutated) reuses flattened walk tables across
    calls, one cache per selection policy.
    """
    xq = np.asarray(xq)
    validate_queries(xq)
    mpts_list = list(mpts_values) if mpts_values is not None else list(msts.mpts_values)
    for m in mpts_list:
        msts.row_of(m)  # raises KeyError on values outside the fitted range
    R = len(mpts_list)
    if xq.shape[0] == 0:  # empty batch: empty result, no device work
        return PredictResult(
            mpts_values=mpts_list,
            labels=np.full((R, 0), -1, np.int64),
            probabilities=np.zeros((R, 0)),
            lambdas=np.zeros((R, 0)),
            neighbors=np.zeros((R, 0), np.int64),
        )

    lam, nbr = attach_queries(xq, x, msts.cd2, mpts_list, plan=plan)

    q = xq.shape[0]
    labels = np.full((R, q), -1, np.int64)
    probs = np.zeros((R, q))
    for r, mpts in enumerate(mpts_list):
        if table_cache is not None and mpts in table_cache:
            table = table_cache[mpts]
        else:
            table = build_walk_table(hierarchy_for(mpts))
            if table_cache is not None:
                table_cache[mpts] = table
        labels[r], probs[r] = walk_queries(table, nbr[r], lam[r])
    return PredictResult(
        mpts_values=mpts_list,
        labels=labels,
        probabilities=probs,
        lambdas=lam.astype(np.float64),
        neighbors=nbr.astype(np.int64),
    )
