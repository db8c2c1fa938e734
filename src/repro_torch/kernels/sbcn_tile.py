"""The SBCN emission's tile products in the reference's float32 order, for
widths above ``EXACT_ORDER_D`` (the port of the dot and the norms inside
``repro/core/sbcn.py``'s tier programs, which XLA computes outside any
Pallas kernel).

The emission keeps every cell within a norm-scaled tolerance of its row's
and column's minimum mrd, so a cell's d2 = |a|^2 + |b|^2 - 2 a.b decides
which near-ties become candidates: to emit the reference's candidates the
port needs its d2 bits.  XLA on the CPU sums the norms in windows of 32
(``ops.sum_sq_win32``, ``csrc/xla_order.cuh``) and hands the tile's dot
to YNNPACK, whose kernel depends on the tile's (A, B) (``dot_order``, read
from XLA's output: ``tests/test_torch_sbcn_order.py``; ``order_known``
says where it was).  Up to ``EXACT_ORDER_D`` the SBCN keeps its torch
products, whose candidates equal the reference's on every fixture there.

``tile_dots`` launches the hand-written CUDA kernel (``csrc/sbcn_tile.cu``)
for tensors on the card and runs the plain version (``tile_dots_plain``:
the same order in torch ops, FMA through ``ops.fma_f32``) for tensors on
the CPU; any other device raises.  ``point_norms`` launches
``pairwise_topk``'s norms pre-pass (``csrc/pairwise_topk.cu``) on the card
and ``point_norms_plain`` (``ops.sum_sq_win32``) on the CPU.
``tile_dots.launches`` and ``point_norms.launches`` count the launches;
``tile_dots.largest`` keeps the ids of the call with the most cells under
each of the two kinds of order (``"panel"``, ``"lanes"``), so that a
caller can time the kernel on a path's own largest call.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import fma_f32, sum_sq_win32
from .pairwise_topk import PANEL

EXACT_ORDER_D = 256
WIDE_PANEL = 1024  # the slices of the (A >= 2, 32) tiles' 2-lane kernel


def dot_order(a: int, b: int) -> tuple[int, bool, int]:
    """(lanes, halve, panel) of XLA's float32 dot for an (a, b) tile of the
    SBCN (a <= b, the canonical pair order), as ``csrc/sbcn_tile.cu``
    describes them:

      * a = 1: 8 lanes, halved for b <= 4, pairwise from b = 8;
      * (2, 2): one FMA chain;
      * b <= 16 otherwise: 4 lanes, pairwise (every fused-path tier);
      * b = 32 otherwise (slot-path tiers): 2 lanes over 1024-deep slices;
      * wider tiles and the row path's products: FMA chains over
        ``PANEL``-deep slices.
    """
    if a == 1:
        return 8, b <= 4, 0
    if a == 2 and b == 2:
        return 1, False, 0
    if b <= 16:
        return 4, False, 0
    if b == 32:
        return 2, False, WIDE_PANEL
    return 1, False, PANEL


def order_known(a: int, b: int, d: int, batch: int) -> bool:
    """Whether ``dot_order(a, b)`` was read from XLA's output for a tile
    that the reference computes in batches of ``batch`` pairs: both sides
    powers of two, except single pairs with a = 1 (another kernel) and
    the (a >= 2, 32) tiles whose last slice past the first is odd and
    longer than one.  Elsewhere (the slot path's oversized pairs,
    ``sbcn._sbcn_large``, single-pair tiers with a = 1) the order is a
    guess, which ``sbcn`` reports."""
    pow2 = a & (a - 1) == 0 and b & (b - 1) == 0
    if not pow2 or (batch == 1 and a == 1 and b > 1):
        return False
    last = d % WIDE_PANEL
    return not (a >= 2 and b == 32 and d > WIDE_PANEL and last % 2 and last > 1)


def _reduce_lanes(acc: list, halve: bool):
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [acc[i] + acc[i + h] for i in range(h)] if halve else [acc[2 * i] + acc[2 * i + 1] for i in range(h)]
    return acc[0]


def _slice_sum(xa: torch.Tensor, xb: torch.Tensor, lanes: int, halve: bool) -> torch.Tensor:
    """One slice's (k, cells) products in ``lanes`` FMA chains, reduced,
    then its tail (an FMA chain under 8 lanes, unfused adds otherwise)."""
    k = xa.shape[0]
    main = k - k % lanes
    s = tail = None
    if main:
        # the lanes side by side: step t holds products t * lanes + r
        la = xa[:main].reshape(main // lanes, lanes, -1)
        lb = xb[:main].reshape(main // lanes, lanes, -1)
        acc = la[0] * lb[0]
        for t in range(1, main // lanes):
            acc = fma_f32(la[t], lb[t], acc)
        s = _reduce_lanes(list(acc.unbind(0)), halve)
    for j in range(main, k):
        if tail is None:
            tail = xa[j] * xb[j]
        else:
            tail = fma_f32(xa[j], xb[j], tail) if lanes == 8 else tail + xa[j] * xb[j]
    return tail if s is None else (s if tail is None else s + tail)


def tile_dots_plain(x: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor, order=None) -> torch.Tensor:
    """(P, A, B) dot products of the rows ``a_idx`` (P, A) and ``b_idx``
    (P, B) of ``x`` in ``order`` (default ``dot_order(A, B)``), one
    float32 rounding per product, fused add and add as XLA makes them; 0
    on padded cells (an id of -1), which the caller masks.  Only the real
    cells are computed, as (cells, d) rows."""
    lanes, halve, panel = order or dot_order(a_idx.shape[1], b_idx.shape[1])
    P, A, B = a_idx.shape[0], a_idx.shape[1], b_idx.shape[1]
    real = (a_idx >= 0)[:, :, None] & (b_idx >= 0)[:, None, :]
    pi, ii, jj = real.nonzero(as_tuple=True)
    xf = x.float()
    xa = xf[a_idx[pi, ii].long()].T.contiguous()  # (d, cells): one row a step
    xb = xf[b_idx[pi, jj].long()].T.contiguous()
    d = x.shape[1]
    out = torch.zeros((P, A, B), dtype=torch.float32, device=x.device)
    if pi.numel() == 0:
        return out
    step = panel or d
    total = None
    for p0 in range(0, d, step):
        s = _slice_sum(xa[p0 : p0 + step], xb[p0 : p0 + step], lanes, halve)
        total = s if total is None else total + s
    out[pi, ii, jj] = total
    return out


def point_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """(n,) sums of squares of the rows of ``x`` in XLA's windows of 32."""
    return sum_sq_win32(x.float())


def _lib():
    lib = _build.load("sbcn_tile")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_sbcn_tile_dots.argtypes = [p, i, p, p, i, i, i, i, i, i, p, p]
    lib.repro_sbcn_tile_dots.restype = ctypes.c_int
    return lib


def _check_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors; got {t.device}")
    return True


def tile_dots(x: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor) -> torch.Tensor:
    """(P, A, B) float32 dot products of gathered rows in XLA's order,
    ``dot_order(A, B)``: the kernel on the card, ``tile_dots_plain`` on
    the CPU."""
    if not _check_device(x, "tile_dots"):
        return tile_dots_plain(x, a_idx, b_idx)
    lanes, halve, panel = dot_order(a_idx.shape[1], b_idx.shape[1])
    xf = x.float().contiguous()
    a = a_idx.to(torch.int32).contiguous()
    b = b_idx.to(torch.int32).contiguous()
    P, A, B = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty((P, A, B), dtype=torch.float32, device=x.device)
    if P == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib().repro_sbcn_tile_dots(xf.data_ptr(), xf.shape[1], a.data_ptr(), b.data_ptr(), P, A, B,
                                             lanes, int(halve), panel, out.data_ptr(), stream)
    _build.check(status, "sbcn_tile dots")
    tile_dots.launches += 1
    kind = "panel" if panel else "lanes"
    held = tile_dots.largest.get(kind)
    if held is None or held[0].numel() * held[1].shape[1] < a.numel() * B:
        tile_dots.largest[kind] = (a, b)
    return out


tile_dots.launches = 0
tile_dots.largest = {}


def point_norms(x: torch.Tensor) -> torch.Tensor:
    """(n,) float32 |x_i|^2 in XLA's windows of 32: ``pairwise_topk``'s
    norms pre-pass on the card, ``point_norms_plain`` on the CPU."""
    if not _check_device(x, "point_norms"):
        return point_norms_plain(x)
    xf = x.float().contiguous()
    out = torch.empty((xf.shape[0],), dtype=torch.float32, device=x.device)
    if xf.shape[0] == 0:
        return out
    lib = _build.load("pairwise_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_pairwise_topk_norms.argtypes = [p, i, i, p, p]
    lib.repro_pairwise_topk_norms.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_pairwise_topk_norms(xf.data_ptr(), xf.shape[0], xf.shape[1], out.data_ptr(), stream)
    _build.check(status, "pairwise_topk norms")
    point_norms.launches += 1
    return out


point_norms.launches = 0
