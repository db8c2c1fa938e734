"""Exact self-kNN: tiled squared distances + streaming top-k.

The port of ``repro/kernels/pairwise_topk.py``.  ``pairwise_topk`` launches
the hand-written CUDA kernel (``csrc/pairwise_topk.cu``) for tensors on the
card and takes the plain version ``pairwise_topk_plain`` for tensors on the
CPU; any other device raises.  The plain version is the counterpart of the
reference's blocked jnp twin (``repro/kernels/ops.py::_knn_jnp_blocked``):
a query-block loop with a streaming merge over key blocks, so the (n, n)
matrix is never materialized.

Both order candidates by (d2, index): ``torch.sort(..., stable=True)`` over
[running state, new tile] keeps the lower index first among equal d2, as
the reference's stable ``jax.lax.top_k`` merge does.  Both compute d2 with
the reference's float32 arithmetic, ``max((qn + kn) - 2 dot, 0)``: |x|^2
in the order XLA on the CPU sums the reference's top-K at width d
(``ops.sum_order(d, "topk")``), and q.k as fused multiply-add chains in
index order, one per ``PANEL`` floats of d, whose sums are added in order
(``ops.fma_f32`` here, ``fmaf`` in the kernel).  So the raw lists (d2 and
indices) equal the reference's Pallas kernel's and its jnp twin's at the
(1024, 2048) tiles, and each other's, bit for bit.  The refine re-sorts
the candidates in exact diff form and breaks its exact ties by candidate
order, so equal lists give equal neighbours on every device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KMAX = 256  # the list instances' longest: 8 register slots in each of a warp's 32 lanes
MAX_D_TILED = 256  # above this width the sliced instances run
KSTREAM = 1024  # the streamed select's longest list (at d <= MAX_D_TILED): its buffers' shared memory
# Depth of one FMA chain in the reference's dot products.  XLA on the CPU
# hands the reference's float32 dot_general to YNNPACK (turning its fusion
# off with --xla_cpu_experimental_ynn_fusion_type= changes the bits), whose
# dot blocks the depth by a cache size compiled into the library, not read
# from the host: ``make_dot_impl(...)::cache_sizes`` in jaxlib's
# libjax_common.so holds 131072 bytes, and the dot's bits then follow panels
# of 512 at the (128, 128), (256, 256) and (1024, 2048) tiles whatever the
# host's thread count or XLA's Eigen flags (tests/test_torch_topk_order.py
# reads both).
PANEL = 512


def _dot_panels(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(bq, d) x (bk, d) -> (bq, bk) dot products in the reference's order:
    one FMA chain in index order per ``PANEL``-deep panel, each starting
    from its first product, and the panel sums added in order, unfused."""
    from .ops import fma_f32  # ops imports this module

    acc = None
    for p0 in range(0, q.shape[1], PANEL):
        part = q[:, None, p0] * k[None, :, p0]
        for j in range(p0 + 1, min(q.shape[1], p0 + PANEL)):
            part = fma_f32(q[:, None, j], k[None, :, j], part)
        acc = part if acc is None else acc + part
    return acc


def pairwise_topk_plain(
    x: torch.Tensor, k_top: int, *, block_q: int = 1024, block_k: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked plain-torch self-kNN: (d2 ascending, int32 idx), self excluded."""
    from .ops import sum_order, sum_sq  # ops imports this module

    n, d = x.shape
    xf = x.float()
    xn = sum_sq(xf, sum_order(d, "topk"))
    out_d = torch.empty((n, k_top), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k_top), dtype=torch.int32, device=x.device)
    inf = torch.tensor(float("inf"), device=x.device)
    for q0 in range(0, n, block_q):
        q = xf[q0 : q0 + block_q]
        bq = q.shape[0]
        rows = torch.arange(q0, q0 + bq, device=x.device)[:, None]
        top_d = torch.full((bq, k_top), float("inf"), device=x.device)
        top_i = torch.full((bq, k_top), -1, dtype=torch.int32, device=x.device)
        for k0 in range(0, n, block_k):
            kk = xf[k0 : k0 + block_k]
            d2 = xn[q0 : q0 + bq, None] + xn[None, k0 : k0 + kk.shape[0]] - 2.0 * _dot_panels(q, kk)
            d2 = torch.clamp_min(d2, 0.0)
            col = torch.arange(k0, k0 + kk.shape[0], dtype=torch.int32, device=x.device)
            d2 = torch.where(col[None, :] == rows, inf, d2)
            cat_d = torch.cat([top_d, d2], dim=1)
            cat_i = torch.cat([top_i, col[None, :].expand(bq, -1)], dim=1)
            sd, order = torch.sort(cat_d, dim=1, stable=True)
            top_d = sd[:, :k_top]
            top_i = cat_i.gather(1, order[:, :k_top])
        out_d[q0 : q0 + bq] = top_d
        out_i[q0 : q0 + bq] = top_i
    return out_d, out_i


def instance(d: int, k_top: int) -> str:
    """The kernel instance a launch at width ``d`` and K = ``k_top`` takes,
    as ``csrc/pairwise_topk.cu``'s ``dispatch`` routes it.  Past ``KMAX``:
    ``"stream"`` up to ``KSTREAM`` at d <= ``MAX_D_TILED`` (one sweep over
    the distances, a buffer of candidates a row in shared memory, no d2 row
    stored), else ``"select"`` (the distances of a chunk of rows into the
    workspace, then a radix select and a sort a row).  Up to ``KMAX`` the
    list instances, ``"sliced"`` above ``MAX_D_TILED`` and ``"tiled"`` at or
    below it."""
    if k_top > KMAX:
        return "stream" if k_top <= KSTREAM and d <= MAX_D_TILED else "select"
    return "sliced" if d > MAX_D_TILED else "tiled"


def _launch(x: torch.Tensor, k_top: int) -> tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    xf = x.float().contiguous()
    if xf.data_ptr() % 16:  # the kernel reads rows as float4
        xf = xf.clone()
    out_d = torch.empty((n, k_top), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k_top), dtype=torch.int32, device=x.device)
    lib = _build.load("pairwise_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_pairwise_topk.argtypes = [p, i, i, i, p, p, p, p]
    lib.repro_pairwise_topk.restype = ctypes.c_int
    lib.repro_pairwise_topk_workspace.argtypes = [i, i, i, p]
    lib.repro_pairwise_topk_workspace.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        # the pre-pass's norms (d > 32), the sliced instance's partial lists
        # and the stored select's chunk of distance rows
        nbytes = ctypes.c_size_t()
        _build.check(lib.repro_pairwise_topk_workspace(n, d, k_top, ctypes.addressof(nbytes)),
                     "pairwise_topk workspace")
        work = torch.empty((nbytes.value,), dtype=torch.uint8, device=x.device) if nbytes.value else None
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.repro_pairwise_topk(xf.data_ptr(), n, d, k_top, out_d.data_ptr(), out_i.data_ptr(),
                                         None if work is None else work.data_ptr(), stream)
    _build.check(status, "pairwise_topk")
    pairwise_topk.launches += 1
    if k_top > KMAX:
        pairwise_topk.select_launches += 1
        if instance(d, k_top) == "stream":
            pairwise_topk.stream_launches += 1
    return out_d, out_i


def kernel_config(n: int, d: int, k_top: int) -> dict:
    """The kernel's launch configuration for (n, d, k_top) on the current
    card, without launching: resident blocks per SM, threads per block,
    dynamic shared memory bytes and keys per shared-memory tile (above
    d = 256 those of the sliced instance's main kernel; its pre-pass and
    merge pass are part of the one launch).  Past K = ``KMAX`` those of
    the streamed select's kernel (its key tile; ``smem_bytes`` holds its
    rows' candidate buffers) where ``instance`` says ``"stream"``, else of
    the stored select's selecting kernel, whose tile is the keys it sorts
    in shared memory at once (its distance pass takes the list instances'
    tiles)."""
    occ = (ctypes.c_int * 4)()
    fn = _build.load("pairwise_topk").repro_pairwise_topk_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(n, d, k_top, ctypes.addressof(occ)), "pairwise_topk occupancy")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "key_tile"), occ))


def pairwise_topk(
    x: torch.Tensor, k_top: int, *, block_q: int = 1024, block_k: int = 2048
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of every row of ``x`` against all other rows.

    Returns ``(d2, idx)`` of shape ``(n, k_top)``: squared distances in
    ascending order (self excluded) and int32 row indices.  ``x`` is
    (n, d) float32, bfloat16 or float16 (upcast to float32).  CUDA tensors
    run the kernel (``block_q``/``block_k`` tile only the plain version;
    ``launches`` counts calls, whatever passes a call makes on the card,
    ``select_launches`` those of them past the lists, K > ``KMAX``, and
    ``stream_launches`` those of these that take the streamed select); CPU
    tensors run the plain version.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d); got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"x must be float32, bfloat16 or float16; got {x.dtype}")
    n = x.shape[0]
    if not 1 <= k_top <= n - 1:
        raise ValueError(f"k_top={k_top} must lie in [1, n-1={n - 1}]")
    if x.device.type == "cpu":
        return pairwise_topk_plain(x, k_top, block_q=block_q, block_k=block_k)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_topk runs on CUDA or CPU tensors; got {x.device}")
    return _launch(x, k_top)


pairwise_topk.launches = 0
pairwise_topk.select_launches = 0
pairwise_topk.stream_launches = 0


def work(n: int, d: int, k_eff: int) -> tuple[float, float]:
    """The least operations and bytes of the top-K of (n, d) at K =
    ``k_eff`` (the kernel's bound): d2 is symmetric, so n (n - 1) / 2 dot
    products of 2 d operations and 3 more for d2, plus the n norms (2 d
    each); x read once, the lists written once."""
    return n * (n - 1) / 2 * (2 * d + 3) + n * 2 * d, 4 * n * d + 8 * n * k_eff
