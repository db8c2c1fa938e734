"""Plain-torch oracles, the port of ``repro/kernels/ref.py``: full
matrices, no tiling, the ``ref`` backend's kernels."""

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


def lune_filter_ref(a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2) -> torch.Tensor:
    """Oracle for ``lune_filter``: (m,) bool, True = some point strictly
    inside the lune.  The same norm-scaled margin as the kernel: noise may
    only keep an edge, never drop it."""
    d2_ac = pairwise_d2_ref(a_xyz, points)          # (m, n)
    d2_bc = pairwise_d2_ref(b_xyz, points)
    mrd_ac = torch.maximum(torch.maximum(d2_ac, a_cd2[:, None]), cd2[None, :])
    mrd_bc = torch.maximum(torch.maximum(d2_bc, b_cd2[:, None]), cd2[None, :])
    eps = torch.tensor(64.0 * 1.1920929e-07, dtype=torch.float32, device=points.device)
    an = (a_xyz.float() ** 2).sum(-1)[:, None]
    bn = (b_xyz.float() ** 2).sum(-1)[:, None]
    cn = (points.float() ** 2).sum(-1)[None, :]
    col = torch.arange(points.shape[0], device=points.device)[None, :]
    is_ep = (col == a_idx[:, None]) | (col == b_idx[:, None])
    inside = (torch.maximum(mrd_ac + eps * (an + cn), mrd_bc + eps * (bn + cn)) < w2[:, None]) & ~is_ep
    return inside.any(dim=1)
