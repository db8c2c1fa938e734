"""Batched single-linkage merges: R union-find loops, one per hierarchy row,
the port of the device loop of ``repro/core/linkage.py::_single_linkage_one``.

``single_linkage`` launches the hand-written CUDA kernel
(``csrc/single_linkage.cu``: one thread block per row, one thread walking
its merges) for tensors on the card and takes the plain version
``single_linkage_plain`` for tensors on the CPU; any other device raises.
Both take each row's MST endpoints already in merge order (the caller's
stable sort by weight, ``core.linkage.single_linkage_batch``) and return
the scipy-convention ``(left, right, size)`` rows as int32; both run the
reference's union-find (read-only finds, union by size, ``size(ra) >=
size(rb)`` keeps ``ra``), so their outputs are equal.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def single_linkage_plain(ea_s: torch.Tensor, eb_s: torch.Tensor, *, n: int):
    """The union-find in torch ops on any device, one Python step per
    merge, each a handful of (R,)-wide operations over flat (R * n,) state:
    (left, right, size), each (R, n-1) int32."""
    R, m = ea_s.shape
    dev = ea_s.device
    off = (torch.arange(R, device=dev) * n)[:, None]
    # row i holds merge i's endpoints of every row: the a-side, then the b-side
    ab = torch.cat([ea_s.long() + off, eb_s.long() + off]).T.contiguous()
    parent = torch.arange(R * n, device=dev)
    label = torch.arange(n, device=dev).repeat(R)
    csize = torch.ones((R * n,), dtype=torch.int64, device=dev)
    lr = torch.empty((m, 2 * R), dtype=torch.int64, device=dev)
    size = torch.empty((m, R), dtype=torch.int64, device=dev)
    for i in range(m):
        r = ab[i]
        while True:  # read-only walks; union by size bounds them by log2 n
            p = parent[r]
            if torch.equal(p, r):
                break
            r = p
        s = csize[r]
        lr[i] = label[r]
        sa, sb = s[:R], s[R:]
        tot = sa + sb
        size[i] = tot
        a_wins = sa >= sb
        winner = torch.where(a_wins, r[:R], r[R:])
        parent[torch.where(a_wins, r[R:], r[:R])] = winner
        label[winner] = n + i
        csize[winner] = tot
    lr = lr.T.to(torch.int32)
    return lr[:R].contiguous(), lr[R:].contiguous(), size.T.to(torch.int32).contiguous()


def smem_max_n() -> int:
    """The largest n whose state the kernel keeps in shared memory."""
    fn = _build.load("single_linkage").repro_single_linkage_smem_max_n
    fn.restype = ctypes.c_int
    return int(fn())


def _launch(ea_s: torch.Tensor, eb_s: torch.Tensor, n: int):
    R, m = ea_s.shape
    dev = ea_s.device
    if eb_s.device != dev:
        raise ValueError(f"every operand must lie on {dev}; eb_s is on {eb_s.device}")
    a, b = (t.to(torch.int32).contiguous() for t in (ea_s, eb_s))
    left, right, size = (torch.empty((R, m), dtype=torch.int32, device=dev) for _ in range(3))
    scratch = None
    if n > smem_max_n():
        scratch = torch.empty((R, 3, n), dtype=torch.int32, device=dev)
    fn = _build.load("single_linkage").repro_single_linkage
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(a.data_ptr(), b.data_ptr(), R, n, None if scratch is None else scratch.data_ptr(),
                    left.data_ptr(), right.data_ptr(), size.data_ptr(), stream)
    _build.check(status, "single_linkage")
    single_linkage.launches += 1
    return left, right, size


def single_linkage(ea_s: torch.Tensor, eb_s: torch.Tensor, *, n: int):
    """Merge rows of R spanning trees over n points whose (R, n-1) endpoint
    arrays are in merge order: (left, right, size), each (R, n-1) int32.

    CUDA tensors run the kernel (a row's state in shared memory up to
    ``smem_max_n()`` points, in device memory above); CPU tensors run the
    plain version.
    """
    if ea_s.ndim != 2 or eb_s.shape != ea_s.shape or ea_s.shape[1] != n - 1 or n < 2:
        raise ValueError(
            f"ea_s and eb_s must be (R, n-1) with n >= 2; got {tuple(ea_s.shape)}, "
            f"{tuple(eb_s.shape)}, n={n}"
        )
    if ea_s.is_floating_point() or eb_s.is_floating_point():
        raise ValueError(f"endpoints must be integers; got {ea_s.dtype}, {eb_s.dtype}")
    if ea_s.shape[0] == 0:
        empty = torch.zeros((0, n - 1), dtype=torch.int32, device=ea_s.device)
        return empty, empty.clone(), empty.clone()
    if ea_s.device.type == "cpu":
        return single_linkage_plain(ea_s, eb_s, n=n)
    if ea_s.device.type != "cuda":
        raise ValueError(f"single_linkage runs on CUDA or CPU tensors; got {ea_s.device}")
    return _launch(ea_s, eb_s, n)


single_linkage.launches = 0
