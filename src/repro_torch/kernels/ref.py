"""Plain-torch oracles, the port of ``repro/kernels/ref.py``.

``lune_filter_ref`` comes with the exact-variant slice.
"""

from __future__ import annotations

import torch


def pairwise_d2_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d) x (m, d) -> (n, m) squared Euclidean distances, fp32."""
    x = x.float()
    y = y.float()
    d2 = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def knn_ref(x: torch.Tensor, k_top: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN oracle: full matrix + stable sort.  (d2 ascending, idx),
    self excluded; among equal d2 the lower index comes first, as
    ``jax.lax.top_k`` orders them."""
    n = x.shape[0]
    d2 = pairwise_d2_ref(x, x)
    d2.fill_diagonal_(float("inf"))
    d2s, idx = torch.sort(d2, dim=1, stable=True)
    return d2s[:, :k_top], idx[:, :k_top].to(torch.int32)
