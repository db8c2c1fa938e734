"""Prim's MST over the implicit complete mrd graph for one mpts: the unit of
work of the paper's re-run baseline, the port of the device loop of
``repro/core/boruvka.py::prim_dense_mst``.

``prim_mst`` launches the hand-written CUDA kernel (``csrc/prim_mst.cu``:
one thread block runs all n-1 steps) for tensors on the card and takes the
plain version ``prim_mst_plain`` for tensors on the CPU; any other device
raises.  Both sum each d2 in the reference's order for this program
(``ops.sum_order(d, "prim")``), update with a strict ``<`` and break argmin
ties by the lowest index, so ``src`` is equal and ``w2`` bit-equal to the
reference's.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import sum_order, sum_sq

# The plain version sums every d2 row up front while the (n, n) matrix
# stays within this many bytes, and one row a step above it.  The FMA
# orders are emulated with about 15 torch ops a column, so a row a step
# is the slow way: at n = 16000, d = 8 it took 28.6 s on an H100 against
# 3.7 s up front, and 15 calls at n = 4000 took 61.9 s against 16.0 s on
# that machine's host CPU (chip_smoke.py).
MATRIX_BYTES = 1 << 31


def _d2_matrix(xf: torch.Tensor, order: str):
    """Every row's d2 in ``order`` (row u, column v: the sum over x[v] - x[u]),
    or None when the (n, n) matrix would pass ``MATRIX_BYTES``."""
    n, d = xf.shape
    if n * n * 4 > MATRIX_BYTES:
        return None
    out = torch.empty((n, n), dtype=torch.float32, device=xf.device)
    rows = max(1, (1 << 22) // max(1, n * d))
    for r0 in range(0, n, rows):
        out[r0 : r0 + rows] = sum_sq(xf[None, :, :] - xf[r0 : r0 + rows, None, :], order)
    return out


def prim_mst_plain(x: torch.Tensor, cd2_col: torch.Tensor):
    """The reference's loop in torch ops, one Python step per vertex:
    (src (n,) int32, w2 (n,) float32), w2[0] = 0.  The d2 rows are summed
    up front, in the same order, while the (n, n) matrix stays within
    ``MATRIX_BYTES``, and one row per step above that."""
    n, d = x.shape
    dev = x.device
    xf, cd = x.float(), cd2_col.float()
    order = sum_order(int(d), "prim")
    d2 = _d2_matrix(xf, order)
    inf = torch.tensor(float("inf"), device=dev)
    in_tree = torch.zeros((n,), dtype=torch.bool, device=dev)
    in_tree[0] = True
    best_w2 = torch.full((n,), float("inf"), device=dev)
    best_w2[0] = 0.0
    best_src = torch.zeros((n,), dtype=torch.int32, device=dev)
    last = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n - 1):
        d2_row = d2[last] if d2 is not None else sum_sq(xf - xf[last], order)
        row = torch.maximum(torch.maximum(cd[last], cd), d2_row)
        better = (row < best_w2) & ~in_tree
        best_w2 = torch.where(better, row, best_w2)
        best_src = torch.where(better, last.to(torch.int32), best_src)
        # torch.argmin returns the first of equal minima, as jax.lax.argmin
        last = torch.argmin(torch.where(in_tree, inf, best_w2))
        in_tree[last] = True
    return best_src, torch.where(torch.arange(n, device=dev) == 0, 0.0, best_w2)


def _launch(x: torch.Tensor, cd2_col: torch.Tensor):
    n, d = x.shape
    dev = x.device
    if cd2_col.device != dev:
        raise ValueError(f"every operand must lie on {dev}; cd2_col is on {cd2_col.device}")
    xf = x.float().contiguous()
    if xf.data_ptr() % 16:  # the kernel reads point rows as float4
        xf = xf.clone()
    cd = cd2_col.float().contiguous()
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    w2 = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _build.load("prim_mst").repro_prim_mst
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(xf.data_ptr(), cd.data_ptr(), n, d, src.data_ptr(), w2.data_ptr(), stream)
    _build.check(status, "prim_mst")
    prim_mst.launches += 1
    return src, w2


def smem_max_n() -> int:
    """The largest n whose state the kernel keeps in shared memory."""
    fn = _build.load("prim_mst").repro_prim_mst_smem_max_n
    fn.restype = ctypes.c_int
    return int(fn())


def prim_mst(x: torch.Tensor, cd2_col: torch.Tensor):
    """Prim's MST of the complete mrd graph of ``x`` (n, d) under one mpts,
    ``cd2_col`` (n,) its squared core distances: (src (n,) int32,
    w2 (n,) float32).  For each vertex v != 0 the MST edge is
    (src[v], v) with squared mrd weight w2[v]; w2[0] = 0.

    CUDA tensors run the kernel (its state in shared memory up to
    ``smem_max_n()`` points, in device memory above); CPU tensors run the
    plain version.
    """
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (n, d) with n >= 1; got {tuple(x.shape)}")
    if cd2_col.shape != (x.shape[0],):
        raise ValueError(f"cd2_col must be ({x.shape[0]},); got {tuple(cd2_col.shape)}")
    if not (x.is_floating_point() and cd2_col.is_floating_point()):
        raise ValueError(f"x and cd2_col must be floating point; got {x.dtype}, {cd2_col.dtype}")
    if x.device.type == "cpu":
        return prim_mst_plain(x, cd2_col)
    if x.device.type != "cuda":
        raise ValueError(f"prim_mst runs on CUDA or CPU tensors; got {x.device}")
    return _launch(x, cd2_col)


prim_mst.launches = 0
