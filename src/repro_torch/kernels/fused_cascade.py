"""Fused filter cascade: d2 + mrd weight + kNN-lune verdict + core-distance
certificate per edge, the port of ``repro/kernels/fused_cascade.py``.

``edge_cascade`` launches the hand-written CUDA kernels
(``csrc/edge_cascade.cu``: a per-point prologue, then the per-edge kernel)
for tensors on the card and takes the plain version ``edge_cascade_plain``
(the reference's ``_edge_cascade_jnp`` counterpart) for tensors on the CPU;
any other device raises.

Both split the reference's lune test the same way.  A check of neighbour c
of endpoint ``own`` (the other endpoint ``oth``) kills the edge when
``max(mrd_own, mrd_oth) < w2``.  ``mrd_own`` depends on the point and the
slot alone, so ``own_table`` computes it once per (point, slot); for finite
inputs the test is ``mrd_own < w2 and mrd_oth < w2``, and only a check that
passes the first half needs c's coordinates for the second.

Every sum of squares runs in the order the caller names
(``kernels.ops.SUM_ORDERS``, picked per program by ``ops.sum_order``):
``seq``, ``fma`` or ``win32``.  Kernel and plain version agree bit for bit
in each, and each is the order XLA compiles the reference's cascade to at
some width, so the certificate and the stage weights equal the reference's.

The RNG build runs the cascade staged (``core.rng._build_fused``): stage 1
checks each endpoint's ``stage1_k`` nearest neighbours, stage 2 the full
``kmax - 1`` list on the stage-1 survivors only.  Staging is exact: stage 1
evaluates the same formula on a prefix of the same lists.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import SUM_ORDERS, sum_sq

_EPS = 64.0 * 1.1920929e-07
_SENTINEL = 2**31 - 1  # int32 max: the packed-key pad value
LANES = (1, 2, 4, 8, 16, 32)  # the kernel's lanes per edge (template instances)


def pick_lanes(k_check: int) -> int:
    """Lanes per edge for ``k_check``: the least power of two of at least
    k_check / 8, at most a warp, so a lane runs up to 16 of the edge's
    checks in rounds.  More lanes end a killed edge's checks sooner but
    repeat the edge's own gathers and d2 in each lane; ``chip_smoke.py``
    prints the sweep over every lane count at the fit's stages."""
    lanes = 1
    while lanes * 8 < k_check and lanes < 32:
        lanes *= 2
    return lanes


def own_table(x, cd2k, knn_idx, knn_d2, *, k_check: int, order: str):
    """Per point p: ``|x_p|^2`` (n,) and, for slot j < k_check with
    c = knn_idx[p, j], ``mrd_own[p, j] = max(knn_d2[p, j], cd2k[p], cd2k[c])
    + eps * (|x_p|^2 + |x_c|^2)`` (n, k_check): the half of every lune
    check that does not depend on the edge."""
    eps = torch.tensor(_EPS, dtype=torch.float32, device=x.device)
    xn = sum_sq(x.float(), order)
    c = knn_idx[:, :k_check].long()
    kd2 = knn_d2[:, :k_check].float()
    mrd_own = torch.maximum(torch.maximum(kd2, cd2k[:, None]), cd2k[c]) + eps * (xn[:, None] + xn[c])
    return xn, mrd_own


def edge_cascade_plain(
    x, cd2k, knn_idx, knn_d2, ea, eb, valid, *, k_check: int, order: str = "seq", chunk: int = 65536
):
    """Plain-torch cascade over an edge list, chunked to bound the working set.

    Returns ``(killed, certified, d2_e, w2)``: bool verdicts masked by
    ``valid``, float32 d2 and w2 (invalid slots read point 0).
    """
    dev = x.device
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    xf = x.float()
    xn, mrd_own = own_table(x, cd2k, knn_idx, knn_d2, k_check=k_check, order=order)
    kidx = knn_idx[:, :k_check].long()
    ea_i = torch.where(valid, ea, 0).long()
    eb_i = torch.where(valid, eb, 0).long()
    outs = []
    for c0 in range(0, ea.shape[0], chunk):
        a, b = ea_i[c0 : c0 + chunk], eb_i[c0 : c0 + chunk]
        xa, xb = xf[a], xf[b]
        d2_e = sum_sq(xa - xb, order)
        cda, cdb = cd2k[a], cd2k[b]
        mcd = torch.maximum(cda, cdb)
        w2 = torch.maximum(mcd, d2_e)
        # lint: allow[float-eq] certificate is bit-exact by construction: w2 is max() of the compared value itself
        certified = w2 == mcd
        killed = torch.zeros_like(certified)
        for own, oth, oth_x, oth_cd in ((a, b, xb, cdb), (b, a, xa, cda)):
            cand = kidx[own]                                   # (c, k)
            own_ok = (mrd_own[own] < w2[:, None]) & (cand != a[:, None]) & (cand != b[:, None])
            d2_oth = sum_sq(oth_x[:, None, :] - xf[cand], order)
            mrd_oth = torch.maximum(torch.maximum(d2_oth, oth_cd[:, None]), cd2k[cand]) + eps * (
                xn[oth][:, None] + xn[cand]
            )
            killed |= (own_ok & (mrd_oth < w2[:, None])).any(dim=1)
        outs.append((killed, certified, d2_e, w2))
    if not outs:
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return valid.clone(), valid.clone(), z, z.clone()
    killed, certified, d2_e, w2 = (torch.cat(v) for v in zip(*outs))
    return killed & valid, certified & valid, d2_e, w2


def _check_operands(x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check: int, order: str):
    n, _ = x.shape
    m = ea.shape[0]
    k_full = knn_idx.shape[1]
    for name, t in (("cd2k", cd2k), ("knn_idx", knn_idx), ("knn_d2", knn_d2),
                    ("ea", ea), ("eb", eb), ("valid", valid)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if cd2k.shape != (n,) or knn_idx.shape != (n, k_full) or knn_d2.shape != (n, k_full):
        raise ValueError(
            f"shapes: cd2k {tuple(cd2k.shape)}, knn_idx {tuple(knn_idx.shape)}, "
            f"knn_d2 {tuple(knn_d2.shape)} do not fit x {tuple(x.shape)}"
        )
    if eb.shape != (m,) or valid.shape != (m,) or valid.dtype != torch.bool:
        raise ValueError("ea, eb and valid must be (m,) with valid of dtype bool")
    if not 0 <= k_check <= k_full:
        raise ValueError(f"k_check={k_check} must lie in [0, {k_full}]")
    if order not in SUM_ORDERS:
        raise ValueError(f"order must be one of {SUM_ORDERS}; got {order!r}")


def _launch(x, cd2k, knn_idx, knn_d2, ea, eb, valid, *, k_check: int, order: str, block_e: int, lanes: int):
    dev = x.device
    n, d = x.shape
    m = ea.shape[0]
    k_full = knn_idx.shape[1]
    lanes = lanes or pick_lanes(k_check)
    if lanes not in LANES or block_e % 32 or not 32 <= block_e <= 256:
        raise ValueError(
            f"the edge_cascade kernel takes lanes in {LANES} and a multiple of 32 threads per "
            f"block up to 256; got lanes={lanes}, block_e={block_e}"
        )
    killed = torch.empty((m,), dtype=torch.bool, device=dev)
    cert = torch.empty((m,), dtype=torch.bool, device=dev)
    d2_e = torch.empty((m,), dtype=torch.float32, device=dev)
    w2 = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return killed, cert, d2_e, w2
    xs = x.float().contiguous()
    if xs.data_ptr() % 16:  # the kernel reads point rows as float4 (float2 at d = 2)
        xs = xs.clone()
    cds, kds = cd2k.float().contiguous(), knn_d2.float().contiguous()
    kis, eas, ebs = (t.to(torch.int32).contiguous() for t in (knn_idx, ea, eb))
    vs = valid.contiguous()
    # the prologue's tables: (|x_p|^2, cd2k[p]) and (mrd_own, c) per (p, slot)
    pn = torch.empty((n, 2), dtype=torch.float32, device=dev)
    tab = torch.empty((n, max(k_check, 1), 2), dtype=torch.int32, device=dev)
    fn = _build.load("edge_cascade").repro_edge_cascade
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p, p, p, i, i, i, i, i, p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            xs.data_ptr(), cds.data_ptr(), kis.data_ptr(), kds.data_ptr(), n, d, k_full,
            eas.data_ptr(), ebs.data_ptr(), vs.data_ptr(), m, k_check, SUM_ORDERS.index(order),
            lanes, block_e, pn.data_ptr(), tab.data_ptr(),
            killed.data_ptr(), cert.data_ptr(), d2_e.data_ptr(), w2.data_ptr(), stream,
        )
    _build.check(status, "edge_cascade")
    edge_cascade.launches += 1
    return killed, cert, d2_e, w2


def kernel_config(d: int, lanes: int, block_e: int) -> dict:
    """The launch configuration for (d, lanes, block_e) on the current card,
    without launching: resident blocks per SM of the per-edge kernel and of
    the prologue, and the threads per block of each."""
    occ = (ctypes.c_int * 4)()
    fn = _build.load("edge_cascade").repro_edge_cascade_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(d, lanes, block_e, ctypes.addressof(occ)), "edge_cascade occupancy")
    return dict(zip(("blocks_per_sm", "threads", "prologue_blocks_per_sm", "prologue_threads"), occ))


def edge_cascade(
    x: torch.Tensor,
    cd2k: torch.Tensor,
    knn_idx: torch.Tensor,
    knn_d2: torch.Tensor,
    ea: torch.Tensor,
    eb: torch.Tensor,
    valid: torch.Tensor,
    *,
    k_check: int,
    order: str = "seq",
    chunk: int = 65536,
    block_e: int = 256,
    lanes: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused per-edge cascade: ``(killed, certified, d2_e, w2)``.

    CUDA tensors run the kernels (``block_e`` threads per block, ``lanes``
    of them per edge; 0 picks ``pick_lanes(k_check)``); CPU tensors run the
    plain version (``chunk`` edges per step).  ``order`` is the summation
    order (module docstring).  Invalid slots are False in the bool outputs
    and hold garbage floats.  Sorted edges make the kernel faster (their
    first endpoint's reads are shared by a warp), never more right.
    """
    _check_operands(x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check, order)
    if x.device.type == "cpu":
        return edge_cascade_plain(
            x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check=k_check, order=order, chunk=chunk
        )
    if x.device.type != "cuda":
        raise ValueError(f"edge_cascade runs on CUDA or CPU tensors; got {x.device}")
    return _launch(
        x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check=k_check, order=order, block_e=block_e, lanes=lanes
    )


edge_cascade.launches = 0


def unpack_keys(ks: torch.Tensor, n_pack: int):
    """Sorted packed keys -> (valid, first-occurrence, lo, hi)."""
    valid = ks != _SENTINEL
    first = torch.ones_like(valid)
    first[1:] = ks[1:] != ks[:-1]
    safe = torch.where(valid, ks, 0)
    return valid, first, torch.div(safe, n_pack, rounding_mode="floor"), safe % n_pack


def stage1_packed(
    x, cd2k, knn_idx, knn_d2, ks, n_pack: int, *, k_check: int, chunk: int, block_e: int, order: str = "seq"
):
    """Stage 1 of the fused build: unpack sorted keys, run ``edge_cascade``
    (the kernel on the card), split survivors on the certificate.

    Returns ``(lo, hi, d2, w2, surv_cert, surv_open, n_cert, n_open)`` with
    the two counts as 0-dim device tensors.
    """
    valid, first, lo, hi = unpack_keys(ks, n_pack)
    killed, cert, d2_e, w2 = edge_cascade(
        x, cd2k, knn_idx, knn_d2, lo, hi, valid,
        k_check=k_check, order=order, chunk=chunk, block_e=block_e,
    )
    surv = valid & first & ~killed
    surv_cert = surv & cert
    surv_open = surv & ~cert
    return lo, hi, d2_e, w2, surv_cert, surv_open, surv_cert.sum(), surv_open.sum()
