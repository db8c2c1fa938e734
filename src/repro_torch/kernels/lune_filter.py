"""Exact lune emptiness of an edge list against every point, the port of
``repro/kernels/lune_filter.py`` (paper §IV-E, Alg. 1 lines 22-26).

``lune_filter`` launches the hand-written CUDA kernel
(``csrc/lune_filter.cu``) for tensors on the card and takes the plain
version ``lune_filter_plain`` for tensors on the CPU; any other device
raises.  An edge ``(a, b)`` with squared weight ``w2`` has a point inside
its lune iff some ``c`` not in ``{a, b}`` (by index) has

    max(mrd(a, c) + eps * (|a|^2 + |c|^2), mrd(b, c) + eps * (|b|^2 + |c|^2)) < w2

with ``mrd(p, c) = max(|p|^2 + |c|^2 - 2 p.c (clamped at 0), cd2(p), cd2(c))``
in float32 matmul form, as the reference computes it, and ``eps = 64 * 2^-23``
on the inside side so that noise can only keep an edge.  Both versions sum
every norm and dot product in index order with no fused multiply-add, so
their verdicts agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import sum_sq_seq

_EPS = 64.0 * 1.1920929e-07


def _dot_seq(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(e, d) x (n, d) -> (e, n) dot products, index order, unfused."""
    acc = p[:, None, 0] * c[None, :, 0]
    for j in range(1, p.shape[1]):
        acc = acc + p[:, None, j] * c[None, :, j]
    return acc


def lune_filter_plain(
    a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2, *, chunk: int = 1024
) -> torch.Tensor:
    """Plain-torch lune scan, ``chunk`` edges at a time: (m,) bool, True
    where some point lies strictly inside the lune."""
    pts = points.float()
    cn = sum_sq_seq(pts)[None, :]
    pcd = cd2.float()[None, :]
    col = torch.arange(pts.shape[0], device=pts.device)[None, :]
    eps = torch.tensor(_EPS, dtype=torch.float32, device=pts.device)
    out = []
    for c0 in range(0, a_xyz.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        vals = []
        for p_xyz, p_cd2 in ((a_xyz[sl], a_cd2[sl]), (b_xyz[sl], b_cd2[sl])):
            p = p_xyz.float()
            t = sum_sq_seq(p)[:, None] + cn
            d2 = torch.clamp_min(t - 2.0 * _dot_seq(p, pts), 0.0)
            mrd = torch.maximum(torch.maximum(d2, p_cd2.float()[:, None]), pcd)
            vals.append(mrd + eps * t)
        ia, ib = a_idx[sl].long()[:, None], b_idx[sl].long()[:, None]
        inside = (torch.maximum(*vals) < w2[sl].float()[:, None]) & (col != ia) & (col != ib)
        out.append(inside.any(dim=1))
    if not out:
        return torch.zeros((0,), dtype=torch.bool, device=pts.device)
    return torch.cat(out)


def _launch(a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2, *, block_e: int, block_c: int):
    m, d = a_xyz.shape
    n = points.shape[0]
    dev = points.device
    if not 1 <= block_e <= 32 or block_c < 32:
        raise ValueError(
            f"the lune_filter kernel takes 1 <= block_e <= 32 edges (warps) per block and "
            f"block_c >= 32 points per tile; got block_e={block_e}, block_c={block_c}"
        )
    args = [a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2]
    for t in args:
        if t.device != dev:
            raise ValueError(f"every operand must lie on {dev}; one is on {t.device}")
    out = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out.bool()
    ax, bx, acd, bcd, w, pts, pcd = (
        t.float().contiguous() for t in (a_xyz, b_xyz, a_cd2, b_cd2, w2, points, cd2)
    )
    # the kernel reads point and endpoint rows in 16-byte pieces
    ax, bx, pts = (t.clone() if t.data_ptr() % 16 else t for t in (ax, bx, pts))
    ai, bi = (t.to(torch.int32).contiguous() for t in (a_idx, b_idx))
    lib = _build.load("lune_filter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_lune_filter.argtypes = [p, p, p, p, p, p, p, i, p, p, i, i, i, i, p, p, p]
    lib.repro_lune_filter.restype = ctypes.c_int
    lib.repro_lune_filter_workspace.argtypes = [i, i, i, p]
    lib.repro_lune_filter_workspace.restype = ctypes.c_int
    with torch.cuda.device(dev):
        nbytes = ctypes.c_size_t()  # the norms' pre-pass above d = 256
        _build.check(lib.repro_lune_filter_workspace(m, n, d, ctypes.addressof(nbytes)), "lune_filter workspace")
        work = torch.empty((nbytes.value,), dtype=torch.uint8, device=dev) if nbytes.value else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.repro_lune_filter(
            ax.data_ptr(), bx.data_ptr(), acd.data_ptr(), bcd.data_ptr(), ai.data_ptr(),
            bi.data_ptr(), w.data_ptr(), m, pts.data_ptr(), pcd.data_ptr(), n, d,
            block_e, block_c, out.data_ptr(), None if work is None else work.data_ptr(), stream,
        )
    _build.check(status, "lune_filter")
    lune_filter.launches += 1
    return out.bool()


def kernel_config(d: int, block_e: int, block_c: int) -> dict:
    """The kernel's launch configuration for (d, block_e, block_c) on the
    current card, without launching: resident blocks per SM, threads per
    block, dynamic shared memory bytes and points per shared-memory tile
    (above d = 256 those of the sliced instance's main kernel)."""
    occ = (ctypes.c_int * 4)()
    fn = _build.load("lune_filter").repro_lune_filter_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(d, block_e, block_c, ctypes.addressof(occ)), "lune_filter occupancy")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "point_tile"), occ))


def lune_filter(
    a_xyz: torch.Tensor,
    b_xyz: torch.Tensor,
    a_cd2: torch.Tensor,
    b_cd2: torch.Tensor,
    a_idx: torch.Tensor,
    b_idx: torch.Tensor,
    w2: torch.Tensor,
    points: torch.Tensor,
    cd2: torch.Tensor,
    *,
    block_e: int = 8,
    block_c: int = 512,
    chunk: int = 1024,
) -> torch.Tensor:
    """(m,) bool: True where the lune of edge ``(a, b)`` holds a point
    (remove the edge).

    ``a_xyz``/``b_xyz`` are the (m, d) endpoint coordinates, ``a_cd2``/
    ``b_cd2`` their squared core distances, ``a_idx``/``b_idx`` their
    indices into ``points`` (n, d) and ``cd2`` (n,).  An edge with
    ``w2 = -inf`` never has a point inside.  CUDA tensors run the kernel:
    up to d = 256 with ``block_e`` edges per block (one warp each, 1 to
    32) and at most ``block_c`` points per shared-memory tile (rounded
    down to a multiple of 32); above d = 256 the kernel streams d in
    slices over fixed items of 32 edges and 64 points, which persistent
    blocks claim in point-tile order, and ``block_e`` and ``block_c``
    only have to lie in their ranges.  ``launches`` counts calls, whatever
    passes a call makes on the card.  CPU tensors run the plain version
    (``chunk`` edges per step).  ``work`` counts a call's operations and
    bytes.
    """
    m = a_xyz.shape[0]
    if a_xyz.ndim != 2 or b_xyz.shape != a_xyz.shape or points.ndim != 2 or points.shape[1] != a_xyz.shape[1]:
        raise ValueError(
            f"a_xyz and b_xyz must be (m, d) and points (n, d); got {tuple(a_xyz.shape)}, "
            f"{tuple(b_xyz.shape)}, {tuple(points.shape)}"
        )
    for name, t in (("a_cd2", a_cd2), ("b_cd2", b_cd2), ("a_idx", a_idx), ("b_idx", b_idx), ("w2", w2)):
        if t.shape != (m,):
            raise ValueError(f"{name} must be ({m},); got {tuple(t.shape)}")
    if cd2.shape != (points.shape[0],):
        raise ValueError(f"cd2 must be ({points.shape[0]},); got {tuple(cd2.shape)}")
    if points.device.type == "cpu":
        return lune_filter_plain(a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2, chunk=chunk)
    if points.device.type != "cuda":
        raise ValueError(f"lune_filter runs on CUDA or CPU tensors; got {points.device}")
    return _launch(a_xyz, b_xyz, a_cd2, b_cd2, a_idx, b_idx, w2, points, cd2, block_e=block_e, block_c=block_c)


lune_filter.launches = 0


def work(n: int, d: int, m: int, m_removed: int) -> tuple[float, float]:
    """Operations and bytes of one ``lune_filter`` call over m edges and n
    points (the kernel's bound).

    A kept edge has to be checked against every point, a removed one
    against one point at the least (the first inside).  Per (edge, point)
    pair: two d-long dot products (4 d) and the norm sums, mrd maxima,
    margins and compares (16).  Every input is read once: the endpoint
    coordinates, core distances, indices and weights of the m edges, the
    n points and their core distances; the m verdicts are written once.
    """
    pairs = (m - m_removed) * n + m_removed
    return pairs * (4 * d + 16), 4 * (m * (2 * d + 5) + n * (d + 1) + m)
