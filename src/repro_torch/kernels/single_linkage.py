"""Batched single-linkage merges: R union-find loops, one per hierarchy row,
the port of the device loop of ``repro/core/linkage.py::_single_linkage_one``.

``single_linkage`` launches the hand-written CUDA kernel
(``csrc/single_linkage.cu``: one thread block per row, one thread walking
its merges over shared memory while the other warps stage each merge's
roots and copy out its results; the state packed into 8 bytes a vertex,
in shared memory or, past ``SMEM_MAX_N`` or where ``set_layout`` forces
it, in device memory: ``layout_for``) for tensors on the card and takes
the plain version ``single_linkage_plain`` for tensors on the CPU; any
other device raises.  Both take each row's MST endpoints already in merge
order (the caller's stable sort by weight,
``core.linkage.single_linkage_batch``) and return the scipy-convention
``(left, right, size)`` rows as int32.  The plain version runs the
reference's union-find (read-only finds, union by size, ``size(ra) >=
size(rb)`` keeps ``ra``); the kernel's finds halve paths, which moves no
root (the source's header says why), so their outputs are equal.
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


# Mirrors csrc/single_linkage.cu: (227 KB - 1 KB - the staging buffers'
# 20480 bytes) over 8 bytes a vertex (chip_smoke.py checks it against the
# library's ``repro_single_linkage_smem_max_n``).
SMEM_MAX_N = (227 * 1024 - 1024 - 2 * 5 * 512 * 4) // 8

_forced_layout: str | None = None


def smem_max_n() -> int:
    """The largest n whose state the kernel keeps in shared memory."""
    return SMEM_MAX_N


def layout_for(n: int, layout: str | None = None) -> str:
    """Where a row's union-find state lives at n points: ``"shared"`` up to
    ``SMEM_MAX_N``, ``"device"`` above.  ``layout`` forces one; forcing
    ``"shared"`` above the limit raises ``ValueError``."""
    if n < 2:
        raise ValueError(f"single_linkage needs n >= 2; got {n}")
    if layout not in (None, "shared", "device"):
        raise ValueError(f"layout must be 'shared' or 'device'; got {layout!r}")
    if layout == "shared" and n > SMEM_MAX_N:
        raise ValueError(f"single_linkage state at n={n} does not fit shared memory (at most {SMEM_MAX_N})")
    return layout or ("shared" if n <= SMEM_MAX_N else "device")


def set_layout(layout: str | None) -> str | None:
    """Force the layout of later launches (``None`` restores
    ``layout_for``'s choice).  Returns the setting it replaces."""
    global _forced_layout
    if layout not in (None, "shared", "device"):
        raise ValueError(f"layout must be 'shared' or 'device' or None; got {layout!r}")
    before, _forced_layout = _forced_layout, layout
    return before


def _launch(ea_s: torch.Tensor, eb_s: torch.Tensor, n: int):
    R, m = ea_s.shape
    dev = ea_s.device
    if eb_s.device != dev:
        raise ValueError(f"every operand must lie on {dev}; eb_s is on {eb_s.device}")
    a, b = (t.to(torch.int32).contiguous() for t in (ea_s, eb_s))
    left, right, size = (torch.empty((R, m), dtype=torch.int32, device=dev) for _ in range(3))
    shared = layout_for(n, _forced_layout) == "shared"
    scratch = None if shared else torch.empty((R, n), dtype=torch.int64, device=dev)
    fn = _build.load("single_linkage").repro_single_linkage
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(a.data_ptr(), b.data_ptr(), R, n, shared, None if scratch is None else scratch.data_ptr(),
                    left.data_ptr(), right.data_ptr(), size.data_ptr(), stream)
    _build.check(status, "single_linkage")
    single_linkage.launches += 1
    return left, right, size


def single_linkage(ea_s: torch.Tensor, eb_s: torch.Tensor, *, n: int):
    """Merge rows of R spanning trees over n points whose (R, n-1) endpoint
    arrays are in merge order: (left, right, size), each (R, n-1) int32.

    CUDA tensors run the kernel (a row's state where ``layout_for`` puts
    it: shared memory up to ``SMEM_MAX_N`` points, device memory above);
    CPU tensors run the plain version.
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
