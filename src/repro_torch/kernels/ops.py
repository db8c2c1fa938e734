"""Public kNN wrapper with backend dispatch, the port of ``repro/kernels/ops.py``.

Backends: ``"cuda"`` and ``"torch"`` both call ``pairwise_topk``, which
launches the CUDA kernel for tensors on the card and runs its plain
version for tensors on the CPU; ``"ref"`` runs the full-matrix oracle.
Every backend over-selects candidates and runs the same diff-form
``_refine_knn``, so near-tie neighbour order is identical across backends.

Sums of squares come in two fixed orders, so that the port reproduces the
reference's float32 bits and agrees with itself across devices:

  * ``sum_sq_seq`` — index order, one rounding per product and per add.
  * ``sum_sq_fma`` — index order with each add fused into the product, as
    XLA compiles the reference's refine and canonical-weight programs.  The
    fused step is computed in float64 (the product of two float32 values is
    exact there) and rounded once to float32.
"""

from __future__ import annotations

import torch

from . import ref
from .pairwise_topk import pairwise_topk

BACKENDS = ("cuda", "torch", "ref")


def sum_sq_seq(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, in index order, unfused."""
    acc = v[..., 0] * v[..., 0]
    for j in range(1, v.shape[-1]):
        acc = acc + v[..., j] * v[..., j]
    return acc


def sum_sq_fma(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, in index order, each add fused."""
    acc = v[..., 0] * v[..., 0]
    v64 = v.double()
    for j in range(1, v.shape[-1]):
        acc = (acc.double() + v64[..., j] * v64[..., j]).float()
    return acc


def _refine_knn(xq: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, *, k_top: int):
    """Diff-form re-evaluation of over-selected candidates.

    The matmul form ``|q|^2 + |k|^2 - 2qk`` loses ~1e-3 relative accuracy to
    cancellation when norms dwarf pair distances, so every backend
    over-selects and this pass recomputes the candidates' distances exactly,
    re-sorts them (stable: candidate order breaks ties) and keeps ``k_top``.
    """
    rows = 4096
    xqf = xq.float()
    xf = x.float()
    d2_out, i_out = [], []
    for r0 in range(0, xq.shape[0], rows):
        ic = idx[r0 : r0 + rows]
        diff = xqf[r0 : r0 + rows, None, :] - xf[ic.clamp_min(0).long()]
        d2r = torch.where(ic < 0, float("inf"), sum_sq_fma(diff))
        d2s, order = torch.sort(d2r, dim=1, stable=True)
        d2_out.append(d2s[:, :k_top])
        i_out.append(ic.gather(1, order[:, :k_top]))
    return torch.cat(d2_out), torch.cat(i_out)


def knn(
    x: torch.Tensor,
    k_top: int,
    *,
    backend: str = "cuda",
    block_q: int = 1024,
    block_k: int = 2048,
    refine_slack: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each point: (d2 ascending, int32 idx)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    n = x.shape[0]
    k_eff = min(n - 1, k_top + refine_slack)
    if backend == "ref":
        _, idx = ref.knn_ref(x, k_eff)
    else:
        _, idx = pairwise_topk(x, k_eff, block_q=block_q, block_k=block_k)
    return _refine_knn(x, x, idx, k_top=k_top)
