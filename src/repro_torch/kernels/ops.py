"""Public kernel wrappers with backend dispatch, the port of
``repro/kernels/ops.py``: the fit's kNN (``knn``), out-of-sample kNN
(``query_knn``), the dual-tree tier's kNN from host candidates
(``knn_from_candidates``) and the exact lune scan (``lune_nonempty``).

Backends: ``"cuda"`` and ``"torch"`` both call the kernel wrappers
(``pairwise_topk``, ``lune_filter``), which launch the CUDA kernel for
tensors on the card and run the plain version for tensors on the CPU;
``"ref"`` runs the full-matrix oracles.  ``query_knn`` has no kernel: the
reference computes it outside any Pallas kernel, and so does the port, in
torch ops on either device.  Every kNN backend over-selects candidates and
runs the same diff-form ``_refine_knn``, so near-tie neighbour order is
identical across backends.

Sums of squares come in three fixed orders (``SUM_ORDERS``), so that the
port reproduces the reference's float32 bits and agrees with itself across
devices:

  * ``sum_sq_seq`` — index order, one rounding per product and per add.
  * ``sum_sq_fma`` — index order with each add fused into the product, as
    XLA compiles the reference's refine and canonical-weight programs at
    d <= 32, and as ``fmaf`` computes it on the card (``fma_f32``).
  * ``sum_sq_win32`` — windows of 32, as XLA's CPU pipeline rewrites every
    row sum longer than 32; it equals ``sum_sq_seq`` at d <= 32.

``sum_order`` says which one each reference program compiles to at width d.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ref
from .pairwise_topk import pairwise_topk

BACKENDS = ("cuda", "torch", "ref")
SUM_ORDERS = ("seq", "fma", "win32")
# the programs whose sums of squares the port reproduces (``sum_order``)
SUM_PROGRAMS = ("cascade", "slot", "refine", "weights", "prim", "topk")


def sum_sq_seq(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, in index order, unfused."""
    acc = v[..., 0] * v[..., 0]
    for j in range(1, v.shape[-1]):
        acc = acc + v[..., j] * v[..., j]
    return acc


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` over float32 tensors with one rounding, as ``fmaf``.

    The product of two float32 values is exact in float64.  The float64 sum
    is rounded to odd (a two-sum error term says whether it was inexact),
    and a value rounded to odd with 53 bits rounds to the nearest float32
    exactly as the unrounded sum would.
    """
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def sum_sq_fma(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, in index order, each add fused."""
    acc = v[..., 0] * v[..., 0]
    for j in range(1, v.shape[-1]):
        acc = fma_f32(v[..., j], v[..., j], acc)
    return acc


def _sum_win32(t: torch.Tensor) -> torch.Tensor:
    """Sum of the terms ``t`` over the last axis in XLA's CPU tree order:
    rows of at most 32 in index order, longer rows as windows of 32 whose
    sums are summed the same way in turn."""
    n = t.shape[-1]
    if n <= 32:
        acc = t[..., 0]
        for j in range(1, n):
            acc = acc + t[..., j]
        return acc
    n_win = -(-n // 32)
    pad_lo = (32 * n_win - n) // 2
    parts = []
    for w in range(n_win):
        s0, s1 = max(0, 32 * w - pad_lo), min(n, 32 * w + 32 - pad_lo)
        acc = t[..., s0]
        for j in range(s0 + 1, s1):
            acc = acc + t[..., j]
        parts.append(acc)
    return _sum_win32(torch.stack(parts, dim=-1))


def sum_sq_win32(v: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis in XLA's CPU order for rows longer
    than 32: ``reduce-window`` then ``reduce``.

    With W = ceil(d / 32) windows, the row is padded with zeros to 32 W
    elements, (32 W - d) // 2 of them in front and the rest behind.  Window
    w sums its real elements in index order, unfused, each square rounded
    (the squares are a separate fusion, so no add is fused into a product);
    the W window sums are then added in order where W <= 32, and where
    W > 32 (d > 1024) they are summed the same way in turn, in windows of
    32 padded by (32 ceil(W / 32) - W) // 2 in front.  At d <= 32 there is
    one window and this is ``sum_sq_seq``.
    """
    return _sum_win32(v * v)


_SUM_SQ = {"seq": sum_sq_seq, "fma": sum_sq_fma, "win32": sum_sq_win32}


def sum_sq(v: torch.Tensor, order: str) -> torch.Tensor:
    """Sum of squares over the last axis in ``order`` (one of ``SUM_ORDERS``)."""
    if order not in _SUM_SQ:
        raise ValueError(f"order must be one of {SUM_ORDERS}; got {order!r}")
    return _SUM_SQ[order](v)


def sum_order(d: int, program: str) -> str:
    """The order in which XLA on the CPU sums the squares of a reference
    program at width ``d``, read from its optimised HLO and LLVM IR:

      * ``"cascade"`` — the fused cascade programs (``stage1_packed``,
        ``_edge_cascade_jnp``, ``edge_cascade`` under ``pallas_interpret``),
        their d2, norms and cross d2: unfused for d <= 8, an FMA chain for
        9 <= d <= 32;
      * ``"slot"`` — the slot path's eager ``edge_d2`` and its kNN-lune
        check: unfused for d <= 32 (on edge counts that fill XLA's vector
        loops, as the reference's power-of-two buckets do);
      * ``"refine"`` and ``"weights"`` — ``_refine_knn`` and the canonical
        edge weights: an FMA chain for d <= 32;
      * ``"prim"`` — the row sum inside ``prim_dense_mst``'s loop body, a
        multiply-reduce fusion of its own: an FMA chain for d <= 32 (its
        LLVM IR is unfused, but the backend contracts every add into the
        product: ``vfmadd`` in the object code);
      * ``"topk"`` — the norms of the reference's top-K (``|q|^2`` and
        ``|k|^2`` of its Pallas kernel in interpret mode and of its jnp
        twin): unfused for 5 <= d <= 8, an FMA chain at the other widths
        up to 32 (at d = 1 a single product either way), read from the
        raw lists they produce (``tests/test_torch_topk_order.py``).

    Above 32 every one of them is ``"win32"``: the row sum becomes a
    ``reduce-window`` of 32 fed by a separate multiply fusion.
    """
    if program not in SUM_PROGRAMS:
        raise ValueError(f"program must be one of {SUM_PROGRAMS}; got {program!r}")
    if d > 32:
        return "win32"
    if program == "cascade":
        return "seq" if d <= 8 else "fma"
    if program == "topk":
        return "seq" if 5 <= d <= 8 else "fma"
    return "seq" if program == "slot" else "fma"


def _refine_knn(xq: torch.Tensor, x: torch.Tensor, idx: torch.Tensor, *, k_top: int):
    """Diff-form re-evaluation of over-selected candidates.

    The matmul form ``|q|^2 + |k|^2 - 2qk`` loses ~1e-3 relative accuracy to
    cancellation when norms dwarf pair distances, so every backend
    over-selects and this pass recomputes the candidates' distances exactly,
    re-sorts them (stable: candidate order breaks ties) and keeps ``k_top``.
    """
    rows = 4096
    sq_order = sum_order(int(x.shape[1]), "refine")
    xqf = xq.float()
    xf = x.float()
    d2_out, i_out = [], []
    for r0 in range(0, xq.shape[0], rows):
        ic = idx[r0 : r0 + rows]
        diff = xqf[r0 : r0 + rows, None, :] - xf[ic.clamp_min(0).long()]
        d2r = torch.where(ic < 0, float("inf"), sum_sq(diff, sq_order))
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


def knn_from_candidates(x: torch.Tensor, cand_idx, *, k_top: int) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN from a precomputed host candidate matrix (the dual-tree tier).

    ``cand_idx``: (n, k_eff) candidate neighbour ids per row (-1 pads),
    which its producer (``core.dualtree.knn_candidates``) guarantees to hold
    the true ``k_top`` nearest.  The matrix goes to ``x``'s device as int32
    and through the same ``_refine_knn`` as every other backend, so the
    (d2, idx) output is bit-identical to the top-K tier's.
    """
    idx = torch.as_tensor(np.asarray(cand_idx, np.int32)).to(x.device)
    if idx.shape[1] < k_top:
        raise ValueError(f"candidate matrix has {idx.shape[1]} columns < k_top={k_top}")
    return _refine_knn(x, x, idx, k_top=k_top)


def _query_knn_blocked(xq, x, *, k_top: int, block_q: int = 1024, block_k: int = 2048):
    """Blocked cross-set kNN: rows of ``xq`` against all rows of ``x``.

    A query-block loop with a streaming merge over key blocks, as the
    reference's ``_query_knn_blocked``: matmul-form d2 clamped at 0 and a
    stable sort over [running state, new tile], so among equal d2 the
    lower index comes first.  No self-exclusion: queries are not fitted
    points.  Returns (d2 ascending, int32 idx), each (q, k_top).
    """
    q, n = xq.shape[0], x.shape[0]
    dev = x.device
    xqf, xf = xq.float(), x.float()
    qn, kn = (xqf * xqf).sum(-1), (xf * xf).sum(-1)
    out_d, out_i = [], []
    for q0 in range(0, q, block_q):
        qb = xqf[q0 : q0 + block_q]
        bq = qb.shape[0]
        top_d = torch.full((bq, k_top), float("inf"), device=dev)
        top_i = torch.full((bq, k_top), -1, dtype=torch.int32, device=dev)
        for k0 in range(0, n, block_k):
            kb = xf[k0 : k0 + block_k]
            d2 = qn[q0 : q0 + bq, None] + kn[None, k0 : k0 + kb.shape[0]] - 2.0 * (qb @ kb.T)
            d2 = torch.clamp_min(d2, 0.0)
            col = torch.arange(k0, k0 + kb.shape[0], dtype=torch.int32, device=dev)
            sd, order = torch.sort(torch.cat([top_d, d2], dim=1), dim=1, stable=True)
            top_d = sd[:, :k_top]
            top_i = torch.cat([top_i, col[None, :].expand(bq, -1)], dim=1).gather(1, order[:, :k_top])
        out_d.append(top_d)
        out_i.append(top_i)
    return torch.cat(out_d), torch.cat(out_i)


def _query_knn_ref(xq, x, *, k_top: int):
    """Exact cross-set kNN oracle: full (q, n) matrix + stable sort."""
    d2s, idx = torch.sort(ref.pairwise_d2_ref(xq, x), dim=1, stable=True)
    return d2s[:, :k_top], idx[:, :k_top].to(torch.int32)


def query_knn(
    xq: torch.Tensor,
    x: torch.Tensor,
    k_top: int,
    *,
    backend: str = "cuda",
    block_q: int = 1024,
    block_k: int = 2048,
    refine_slack: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest *fitted* neighbours of each query row: (d2 ascending, idx).

    The out-of-sample twin of ``knn``: queries in ``xq`` are ranked
    against the fitted set ``x`` with no self-exclusion, and every backend
    routes its over-selected candidates through the same ``_refine_knn``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    n = x.shape[0]
    if k_top > n:
        raise ValueError(f"k_top={k_top} must be <= n={n} fitted points")
    if xq.shape[0] == 0:
        raise ValueError("query set is empty (callers handle q=0 upstream)")
    k_eff = min(n, k_top + refine_slack)
    if backend == "ref":
        _, idx = _query_knn_ref(xq, x, k_top=k_eff)
    else:
        _, idx = _query_knn_blocked(xq, x, k_top=k_eff, block_q=block_q, block_k=block_k)
    return _refine_knn(xq, x, idx, k_top=k_top)


def _lune_ref_chunked(a_xyz, b_xyz, a_cd2, b_cd2, ea, eb, w2, points, cd2):
    """The oracle over 4096 edges at a time, bounding the (m, n) matrices."""
    parts = [
        ref.lune_filter_ref(a_xyz[s], b_xyz[s], a_cd2[s], b_cd2[s], ea[s], eb[s], w2[s], points, cd2)
        for s in (slice(c0, c0 + 4096) for c0 in range(0, ea.shape[0], 4096))
    ]
    return torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.bool, device=points.device)


def lune_nonempty(
    ea: torch.Tensor,
    eb: torch.Tensor,
    w2: torch.Tensor,
    points: torch.Tensor,
    cd2: torch.Tensor,
    *,
    backend: str = "cuda",
    block_e: int = 8,
    block_c: int = 512,
) -> torch.Tensor:
    """(m,) bool: True where lune(a, b) holds a point strictly inside.

    Gathers the endpoints' coordinates and squared core distances from
    ``points`` (n, d) and ``cd2`` (n,) itself.  The reference pads the edge
    count to a power of two for XLA's program cache; the port compiles
    nothing per shape and passes the edges as they are.
    """
    from .lune_filter import lune_filter  # lune_filter imports this module

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    ea_l, eb_l = ea.long(), eb.long()
    args = (points[ea_l], points[eb_l], cd2[ea_l], cd2[eb_l], ea, eb, w2, points, cd2)
    if backend == "ref":
        return _lune_ref_chunked(*args)
    return lune_filter(*args, block_e=block_e, block_c=block_c)
