"""Core distances and mutual-reachability distances (paper §III-B), the port
of ``repro/core/mrd.py``.

Everything is kept in squared space: ``max`` and all comparisons commute
with ``sqrt`` for non-negative values.  The ``mpts``-NN of ``p`` includes
``p`` itself, so ``c_1(p) = 0`` and one (kmax-1)-NN pass yields every core
distance ``c_j, j in [1, kmax]``.
"""

from __future__ import annotations

import torch

from ..kernels.ops import sum_order, sum_sq


def core_distances2(knn_d2: torch.Tensor) -> torch.Tensor:
    """(n, kmax-1) ascending squared kNN distances -> (n, kmax) squared core
    distances; column ``j-1`` holds ``c_j^2`` and column 0 is 0."""
    zero = torch.zeros((knn_d2.shape[0], 1), dtype=knn_d2.dtype, device=knn_d2.device)
    return torch.cat([zero, knn_d2], dim=1)


def mrd2_from_parts(d2, cd2_a, cd2_b):
    """Squared mutual reachability: max(d^2, c(a)^2, c(b)^2) (Eq. 1, squared)."""
    return torch.maximum(torch.maximum(cd2_a, cd2_b), d2)


def edge_d2(x: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance for an explicit edge list, summed in the
    order of the reference's slot path."""
    return sum_sq(x[ea.long()].float() - x[eb.long()].float(), sum_order(int(x.shape[1]), "slot"))


def edge_mrd2(x: torch.Tensor, cd2_col: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor) -> torch.Tensor:
    """Squared mrd for edges under ONE mpts value (cd2_col = cd2[:, mpts-1])."""
    ea, eb = ea.long(), eb.long()
    return mrd2_from_parts(edge_d2(x, ea, eb), cd2_col[ea], cd2_col[eb])


def reweight_all_mpts(d2_e, cd2, ea, eb):
    """(m,) squared edge lengths + (n, kmax) squared core distances ->
    (kmax, m) squared mrd weights; row j-1 corresponds to mpts=j."""
    ea, eb = ea.long(), eb.long()
    return torch.maximum(torch.maximum(cd2[ea].T, cd2[eb].T), d2_e[None, :])
