"""DBCV-style relative validity over an mrd MST (paper §I motivation).

A copy of ``repro/core/dbcv.py`` (pure numpy).  The port keeps its own
copy because the reference package imports JAX on import.

The paper motivates multiple hierarchies by using an internal validation
measure (DBCV, Moulavi et al. 2014) to pick promising density levels across
hierarchies from different mpts.  Full DBCV recomputes all-points-core
distances; we implement the standard fast approximation computed directly on
the per-mpts mutual-reachability MST (the same simplification as the
reference hdbscan library's ``relative_validity_``):

  density sparseness DSC(Ci) = max internal MST edge of Ci
  density separation DSPC(Ci) = min MST edge leaving Ci (to any other cluster)
  V(Ci) = (DSPC - DSC) / max(DSPC, DSC);   DBCV = sum |Ci|/n * V(Ci)

Noise points are excluded.  Returns a value in [-1, 1]; higher is better.
"""

from __future__ import annotations

import numpy as np


def dbcv_relative_validity(
    ea: np.ndarray,
    eb: np.ndarray,
    w: np.ndarray,
    labels: np.ndarray,
) -> float:
    """DBCV relative validity of a labelling over its mrd MST.

    Vectorized over clusters (scatter-max for DSC, scatter-min for DSPC; no
    per-cluster edge scans), with the degenerate regimes handled by explicit
    ``np.isinf`` cases rather than value comparisons — an earlier version
    guarded the missing-crossing-edge branch with ``dspc is np.inf``, a
    float *identity* check that is False for any computed inf (e.g. an inf
    edge weight flowing through ``min``), silently misrouting those clusters
    through the generic formula (inf/inf -> nan).

    Cases, per cluster ``Ci`` (V in [-1, 1], DBCV = sum |Ci|/n * V):
      * DSPC infinite (no crossing MST edge at all — e.g. every path to the
        other clusters runs through noise points — or only inf-weight
        crossing edges): the cluster is unboundedly separated, V = +1.
      * DSC infinite (an inf-weight internal edge) with finite DSPC:
        unboundedly sparse, V = -1.
      * both infinite: the two degeneracies cancel, V = 0.
      * DSPC == DSC == 0 (duplicate-point cluster touching a duplicate
        crossing edge): no density contrast either way, V = 0.
      * otherwise the standard (DSPC - DSC) / max(DSPC, DSC).
    """
    cl = np.unique(labels[labels >= 0])
    if len(cl) < 2:
        return -1.0
    K = len(cl)

    la, lb = labels[ea], labels[eb]
    internal = (la == lb) & (la >= 0)
    crossing = (la != lb) & (la >= 0) & (lb >= 0)

    dsc = np.zeros(K)
    np.maximum.at(dsc, np.searchsorted(cl, la[internal]), w[internal])
    dspc = np.full(K, np.inf)
    cw = w[crossing]
    np.minimum.at(dspc, np.searchsorted(cl, la[crossing]), cw)
    np.minimum.at(dspc, np.searchsorted(cl, lb[crossing]), cw)

    denom = np.maximum(dspc, dsc)
    with np.errstate(invalid="ignore"):
        v = np.where(
            np.isinf(dspc) & np.isinf(dsc), 0.0,
            np.where(
                np.isinf(dspc), 1.0,
                np.where(
                    np.isinf(dsc), -1.0,
                    np.divide(dspc - dsc, denom, out=np.zeros(K), where=denom > 0),
                ),
            ),
        )

    sizes = np.bincount(np.searchsorted(cl, labels[labels >= 0]), minlength=K)
    n_clustered = int(sizes.sum())
    return float(np.sum(sizes / max(n_clustered, 1) * v))
