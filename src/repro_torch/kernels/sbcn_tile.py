"""The SBCN emission's tile products in the reference's float32 order, for
widths above ``EXACT_ORDER_D`` (the port of the dot and the norms inside
``repro/core/sbcn.py``'s tier programs, which XLA computes outside any
Pallas kernel).

The emission keeps every cell within a norm-scaled tolerance of its row's
and column's minimum mrd, so a cell's d2 = |a|^2 + |b|^2 - 2 a.b decides
which near-ties become candidates: to emit the reference's candidates the
port needs its d2 bits.  XLA on the CPU sums the norms in windows of 32
(``ops.sum_sq_win32``, ``csrc/xla_order.cuh``) and hands the tile's dot
to YNNPACK, whose kernel depends on the tile's columns, or, for a single
row, emits its own loop (``dot_order``, read from XLA's output for every
product the reference computes: ``tests/test_torch_sbcn_order.py``).  Up
to ``EXACT_ORDER_D`` the SBCN keeps its torch products, whose candidates
equal the reference's on every fixture there.

``tile_dots`` launches the hand-written CUDA kernel (``csrc/sbcn_tile.cu``)
for tensors on the card and runs the plain version (``tile_dots_plain``:
the same order in torch ops, FMA through ``ops.fma_f32``) for tensors on
the CPU; any other device raises.  ``point_norms`` launches
``pairwise_topk``'s norms pre-pass (``csrc/norms_win32.cuh``) on the card
and ``point_norms_plain`` (``ops.sum_sq_win32``) on the CPU.
``tile_dots.launches`` and ``point_norms.launches`` count the launches,
``tile_dots.path_launches`` those of each of the kernel's paths
(``kernel_path``).  While ``tile_dots.record`` is True, ``tile_dots.largest``
keeps the ids (and the product's kind) of the call with the most cells on
each path, so that a caller can time the kernel on a fit's own largest
calls; it holds nothing otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import fma_f32, sum_sq_win32

EXACT_ORDER_D = 256
LOOP = (0, False, 0)  # XLA's own loop over a [d] x [B, d] product (``_loop_sum``), not a library kernel
LOOP_MAX_D = 4096     # from this width XLA leaves a single row's product to its dot kernels
CACHE_FLOATS = 32768  # the library's blocking: slices of CACHE_FLOATS / (columns a tile) products


def _n_tile(b: int) -> int:
    """Columns a tile of the library's dot kernel for b >= 4 columns: b
    rounded up to a multiple of 4 up to 16, 8 from 17 to 24, else whichever
    of 64, 32 and 16 pads b the least (the larger on a tie)."""
    if b <= 16:
        return -(-b // 4) * 4
    if b <= 24:
        return 8
    best = None
    for t in (64, 32, 16):
        pad = -(-b // t) * t
        if best is None or pad < best[0]:
            best = (pad, t)
    return best[1]


def dot_order(a: int, b: int, d: int, kind: str = "batched") -> tuple[int, bool, int]:
    """(lanes, halve, panel) of XLA's float32 dot of an (a, b) tile of the
    SBCN (a <= b, the canonical pair order) at width ``d``, read from XLA's
    output (``tests/test_torch_sbcn_order.py``).  ``kind`` is what the
    reference computes: ``"batched"`` (a tier einsum of two or more pairs,
    or of one pair with a >= 2; the row path's products), ``"single"`` (a
    tier einsum of one pair with a = 1) or ``"2d"`` (``_sbcn_large``'s
    ``xa @ xb.T`` over a chunk of ``a`` rows).

      * a = 1, batched: 8 lanes, halved for b <= 4, pairwise from b = 8;
      * a = 1, single or 2-D, d < ``LOOP_MAX_D``: ``LOOP``, XLA's own loop
        (``_loop_sum``); from ``LOOP_MAX_D`` the batched order (single) or
        one FMA chain (2-D);
      * b < 4 otherwise: one FMA chain;
      * otherwise the library kernel for ``_n_tile(b)`` columns a tile:
        4 lanes pairwise (16 columns or fewer), 2 lanes (32) or one chain
        (64), each inside slices ``CACHE_FLOATS / columns`` deep (rounded
        down to a multiple of the lanes).

    Lanes run inside the slices of the first d - d % lanes products; the
    last d % lanes products (the tail) come after every slice.
    """
    if kind not in ("batched", "single", "2d"):
        raise ValueError(f"kind must be 'batched', 'single' or '2d'; got {kind!r}")
    if a == 1:
        if kind != "batched" and d < LOOP_MAX_D:
            return LOOP
        return (1, False, 0) if kind == "2d" else (8, b <= 4, 0)
    if b < 4:
        return 1, False, 0
    t = _n_tile(b)
    lanes = {64: 1, 32: 2}.get(t, 4)
    return lanes, False, CACHE_FLOATS // t // lanes * lanes


def _reduce_lanes(acc: list, halve: bool):
    while len(acc) > 1:
        h = len(acc) // 2
        acc = [acc[i] + acc[i + h] for i in range(h)] if halve else [acc[2 * i] + acc[2 * i + 1] for i in range(h)]
    return acc[0]


def _chains(xa: torch.Tensor, xb: torch.Tensor, lanes: int) -> list:
    """``lanes`` FMA chains over the (k, cells) products, k a multiple of
    lanes: chain r sums products r, r + lanes, ... in order."""
    k = xa.shape[0]
    la = xa.reshape(k // lanes, lanes, -1)
    lb = xb.reshape(k // lanes, lanes, -1)
    acc = la[0] * lb[0]
    for t in range(1, k // lanes):
        acc = fma_f32(la[t], lb[t], acc)
    return list(acc.unbind(0))


def _lanes_sum(xa: torch.Tensor, xb: torch.Tensor, lanes: int, halve: bool, panel: int) -> torch.Tensor:
    """The library kernels' order: lanes inside ``panel``-deep slices of the
    first d - d % lanes products, the slices added in order, then the tail
    (an FMA chain under 8 lanes, unfused adds otherwise) added last."""
    d = xa.shape[0]
    main = d - d % lanes
    step = panel or main
    total = tail = None
    for p0 in range(0, main, step):
        p1 = min(main, p0 + step)
        s = _reduce_lanes(_chains(xa[p0:p1], xb[p0:p1], lanes), halve)
        total = s if total is None else total + s
    for j in range(main, d):
        if tail is None:
            tail = xa[j] * xb[j]
        else:
            tail = fma_f32(xa[j], xb[j], tail) if lanes == 8 else tail + xa[j] * xb[j]
    if tail is None:
        return total
    return tail if total is None else total + tail


# XLA's loop: the d % 32 products past the main loop go through one vector
# stage of (width, steps), then one FMA each; read from XLA's output
LOOP_UNROLLED_STEPS = 17  # main loops of up to 17 steps of 32 are unrolled and reassociated
LOOP_EPILOGUE = {r: (2, 1) if r < 4 else (4, 1) if r < 6 else (2, 3) for r in range(2, 8)}
LOOP_EPILOGUE.update({r: (8, (r - r % 4) // 8) if (r - r % 4) % 8 == 0 else (4, (r - r % 4) // 4)
                      for r in range(8, 32)})


def _loop_sum(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """XLA's own loop over a [d] x [B, d] product (``LOOP``): 4 vectors of 8
    FMA lanes a step of 32 products.  Unrolled (up to
    ``LOOP_UNROLLED_STEPS`` steps) lane e is one chain: the first vector's
    products e + 32 t, then each later vector's in steps 1, 0, 2, 3, ...;
    looped, each vector's lane is a chain and the four are added in order.
    The 8 lane sums are halved ((e, e + 4), then (e, e + 2), (e, e + 1)),
    then the d % 32 products left take ``LOOP_EPILOGUE``'s vector stage
    (its lane 0 starting from the sum, halved the same way) and one FMA
    each after it."""
    d = xa.shape[0]
    steps, rest = divmod(d, 32)
    prod = lambda k: xa[k] * xb[k]  # noqa: E731
    sums = []
    for e in range(8):
        if steps <= LOOP_UNROLLED_STEPS:
            seq = [32 * t + e for t in range(steps)]
            later = [1, 0, *range(2, steps)] if steps >= 2 else list(range(steps))
            for u in (1, 2, 3):
                seq += [32 * t + 8 * u + e for t in later]
            acc = prod(seq[0])
            for k in seq[1:]:
                acc = fma_f32(xa[k], xb[k], acc)
            sums.append(acc)
        else:
            vecs = []
            for u in range(4):
                acc = prod(8 * u + e)
                for t in range(1, steps):
                    acc = fma_f32(xa[32 * t + 8 * u + e], xb[32 * t + 8 * u + e], acc)
                vecs.append(acc)
            sums.append(((vecs[0] + vecs[1]) + vecs[2]) + vecs[3])
    total = _reduce_lanes(sums, True)
    k0 = 32 * steps
    if rest in LOOP_EPILOGUE:
        width, n = LOOP_EPILOGUE[rest]
        lanes = []
        for j in range(width):
            acc = total if j == 0 else None
            for i in range(n):
                k = k0 + width * i + j
                acc = prod(k) if acc is None else fma_f32(xa[k], xb[k], acc)
            lanes.append(acc)
        total = _reduce_lanes(lanes, True)
        k0 += width * n
    for k in range(k0, d):
        total = fma_f32(xa[k], xb[k], total)
    return total


def tile_dots_plain(x: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor, order=None,
                    kind: str = "batched") -> torch.Tensor:
    """(P, A, B) dot products of the rows ``a_idx`` (P, A) and ``b_idx``
    (P, B) of ``x`` in ``order`` (default ``dot_order(A, B, d, kind)``), one
    float32 rounding per product, fused add and add as XLA makes them; 0
    on padded cells (an id of -1), which the caller masks.  Only the real
    cells are computed, as (cells, d) rows."""
    d = x.shape[1]
    P, A, B = a_idx.shape[0], a_idx.shape[1], b_idx.shape[1]
    lanes, halve, panel = order or dot_order(A, B, d, kind)
    real = (a_idx >= 0)[:, :, None] & (b_idx >= 0)[:, None, :]
    pi, ii, jj = real.nonzero(as_tuple=True)
    xf = x.float()
    xa = xf[a_idx[pi, ii].long()].T.contiguous()  # (d, cells): one row a step
    xb = xf[b_idx[pi, jj].long()].T.contiguous()
    out = torch.zeros((P, A, B), dtype=torch.float32, device=x.device)
    if pi.numel() == 0:
        return out
    out[pi, ii, jj] = _loop_sum(xa, xb) if lanes == 0 else _lanes_sum(xa, xb, lanes, halve, panel)
    return out


def point_norms_plain(x: torch.Tensor) -> torch.Tensor:
    """(n,) sums of squares of the rows of ``x`` in XLA's windows of 32."""
    return sum_sq_win32(x.float())


PATHS = ("loop", "dense", "bucketed", "direct")  # csrc/sbcn_tile.cu's paths, by their number there
BUCKET_ROWS = 128  # rows of a bucket's tile (T in csrc/sbcn_tile.cu)
MAX_TILES = 1024   # tiles a side of the bucket grid; past them the direct path (NT_MAX)


def kernel_path(order, a: int, b: int, n: int) -> str:
    """The path of ``csrc/sbcn_tile.cu`` that a call of (a, b) tiles over n
    points takes under ``order``: ``"loop"`` (XLA's loop, a thread a cell),
    ``"dense"`` (one lane over at least 32 x 64 cells a pair: 4 x 4 cells a
    thread), ``"bucketed"`` (the real cells bucketed by 128-row tiles of
    points, each bucket's rows staged once) or ``"direct"`` (a thread a
    cell, past ``MAX_TILES`` tiles of points)."""
    if order[0] == 0:
        return "loop"
    if order[0] == 1 and a >= 32 and b >= 64:
        return "dense"
    return "direct" if -(-n // BUCKET_ROWS) > MAX_TILES else "bucketed"


_LIBS = {}


def _lib(name: str):
    """The loaded library of ``csrc/sbcn_tile.cu`` or ``pairwise_topk.cu``
    (the norms' entry point), its argument types set once."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "sbcn_tile":
            lib.repro_sbcn_tile_dots.argtypes = [p, i, i, p, p, i, i, i, i, i, i, i, p, p, p]
            lib.repro_sbcn_tile_dots.restype = i
            lib.repro_sbcn_tile_scratch_ints.argtypes = [i, i, i, i, i]
            lib.repro_sbcn_tile_scratch_ints.restype = ctypes.c_longlong
        else:
            lib.repro_pairwise_topk_norms.argtypes = [p, i, i, p, p]
            lib.repro_pairwise_topk_norms.restype = i
        _LIBS[name] = lib
    return lib


def _check_device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors; got {t.device}")
    return True


def tile_dots(x: torch.Tensor, a_idx: torch.Tensor, b_idx: torch.Tensor, kind: str = "batched",
              path: str | None = None) -> torch.Tensor:
    """(P, A, B) float32 dot products of gathered rows in XLA's order,
    ``dot_order(A, B, d, kind)``: the kernel on the card (through
    ``kernel_path``, or ``path`` where the caller forces one: the kernel
    refuses a path the order has no instance of), ``tile_dots_plain`` on
    the CPU."""
    if not _check_device(x, "tile_dots"):
        return tile_dots_plain(x, a_idx, b_idx, kind=kind)
    n, d = x.shape
    P, A, B = a_idx.shape[0], a_idx.shape[1], b_idx.shape[1]
    lanes, halve, panel = order = dot_order(A, B, d, kind)
    path = path or kernel_path(order, A, B, n)
    xf = x.float().contiguous()
    a = a_idx.to(torch.int32).contiguous()
    b = b_idx.to(torch.int32).contiguous()
    out = torch.empty((P, A, B), dtype=torch.float32, device=x.device)
    if P == 0:
        return out
    lib = _lib("sbcn_tile")
    ints = lib.repro_sbcn_tile_scratch_ints(n, P, A, B, lanes) if path == "bucketed" else 1
    scratch = torch.empty((ints,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_sbcn_tile_dots(xf.data_ptr(), n, d, a.data_ptr(), b.data_ptr(), P, A, B, lanes,
                                          int(halve), panel, PATHS.index(path), out.data_ptr(), scratch.data_ptr(),
                                          stream)
    _build.check(status, "sbcn_tile dots")
    tile_dots.launches += 1
    tile_dots.path_launches[path] = tile_dots.path_launches.get(path, 0) + 1
    held = tile_dots.largest.get(path)
    if tile_dots.record and (held is None or held[0].numel() * held[1].shape[1] < a.numel() * B):
        tile_dots.largest[path] = (a, b, kind)
    return out


tile_dots.launches = 0
tile_dots.path_launches = {}
tile_dots.record = False
tile_dots.largest = {}


def point_norms(x: torch.Tensor) -> torch.Tensor:
    """(n,) float32 |x_i|^2 in XLA's windows of 32: the norms pre-pass
    (``csrc/norms_win32.cuh``, through ``pairwise_topk.cu``'s entry point)
    on the card, ``point_norms_plain`` on the CPU."""
    if not _check_device(x, "point_norms"):
        return point_norms_plain(x)
    xf = x.float().contiguous()
    out = torch.empty((xf.shape[0],), dtype=torch.float32, device=x.device)
    if xf.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib("pairwise_topk").repro_pairwise_topk_norms(xf.data_ptr(), xf.shape[0], xf.shape[1],
                                                                  out.data_ptr(), stream)
    _build.check(status, "pairwise_topk norms")
    point_norms.launches += 1
    return out


point_norms.launches = 0
