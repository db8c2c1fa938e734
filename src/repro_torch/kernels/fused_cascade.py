"""Fused filter cascade: d2 + mrd weight + kNN-lune verdict + core-distance
certificate per edge, the port of ``repro/kernels/fused_cascade.py``.

``edge_cascade`` launches the hand-written CUDA kernel
(``csrc/edge_cascade.cu``) for tensors on the card and takes the plain
version ``edge_cascade_plain`` (the reference's ``_edge_cascade_jnp``
counterpart) for tensors on the CPU; any other device raises.

Every sum of squares runs in index order, in one of two orders that the
caller picks with ``fma`` (``sum_order_fma``): unfused (``sum_sq_seq``;
``__fmul_rn``/``__fadd_rn`` in the kernel) or an FMA chain (``sum_sq_fma``;
``fmaf`` in the kernel).  Kernel and plain version agree bit for bit in
both, and the order XLA compiles the reference's cascade to on the CPU
decides which one the RNG build asks for, so the certificate and the
stage weights equal the reference's.

The RNG build runs the cascade staged (``core.rng._build_fused``): stage 1
checks each endpoint's ``stage1_k`` nearest neighbours, stage 2 the full
``kmax - 1`` list on the stage-1 survivors only.  Staging is exact: stage 1
evaluates the same formula on a prefix of the same lists.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ops import sum_sq_fma, sum_sq_seq

_EPS = 64.0 * 1.1920929e-07
_SENTINEL = 2**31 - 1  # int32 max: the packed-key pad value


def sum_order_fma(d: int, *, fused: bool) -> bool:
    """Whether the reference's cascade sums of squares are an FMA chain at
    width ``d``.

    XLA on the CPU compiles the fused cascade programs (``stage1_packed``,
    ``_edge_cascade_jnp`` and ``edge_cascade`` under ``pallas_interpret``)
    to an unfused index-order sum for d <= 8 and to an FMA chain for
    9 <= d <= 32; the slot path's eager ``edge_d2`` sums unfused for
    d <= 32 (on edge counts that fill XLA's vector loops, as the
    reference's power-of-two buckets do).  Above 32 neither index order
    is XLA's, and the port keeps the FMA chain: there stage weights may
    differ from the reference's by an ulp, and with them a certificate.
    """
    return d > (8 if fused else 32)


def edge_cascade_plain(
    x, cd2k, knn_idx, knn_d2, ea, eb, valid, *, k_check: int, fma: bool = False, chunk: int = 65536
):
    """Plain-torch cascade over an edge list, chunked to bound the working set.

    Returns ``(killed, certified, d2_e, w2)``: bool verdicts masked by
    ``valid``, float32 d2 and w2 (invalid slots read point 0).
    """
    sum_sq = sum_sq_fma if fma else sum_sq_seq
    dev = x.device
    eps = torch.tensor(_EPS, dtype=torch.float32, device=dev)
    xf = x.float()
    kidx = knn_idx[:, :k_check].long()
    kd2 = knn_d2[:, :k_check]
    ea_i = torch.where(valid, ea, 0).long()
    eb_i = torch.where(valid, eb, 0).long()
    outs = []
    for c0 in range(0, ea.shape[0], chunk):
        a, b = ea_i[c0 : c0 + chunk], eb_i[c0 : c0 + chunk]
        xa, xb = xf[a], xf[b]
        d2_e = sum_sq(xa - xb)
        cda, cdb = cd2k[a], cd2k[b]
        mcd = torch.maximum(cda, cdb)
        w2 = torch.maximum(mcd, d2_e)
        # lint: allow[float-eq] certificate is bit-exact by construction: w2 is max() of the compared value itself
        certified = w2 == mcd
        an, bn = sum_sq(xa), sum_sq(xb)
        killed = torch.zeros_like(certified)
        sides = ((a, xb, cda, cdb, an, bn), (b, xa, cdb, cda, bn, an))
        for own, oth_x, own_cd, oth_cd, own_n, oth_n in sides:
            cand = kidx[own]                                   # (c, k)
            xc = xf[cand]                                      # (c, k, d)
            cn = sum_sq(xc)
            cdc = cd2k[cand]
            d2_oth = sum_sq(oth_x[:, None, :] - xc)
            mrd_own = torch.maximum(torch.maximum(kd2[own], own_cd[:, None]), cdc) + eps * (own_n[:, None] + cn)
            mrd_oth = torch.maximum(torch.maximum(d2_oth, oth_cd[:, None]), cdc) + eps * (oth_n[:, None] + cn)
            not_ep = (cand != a[:, None]) & (cand != b[:, None])
            killed |= ((torch.maximum(mrd_own, mrd_oth) < w2[:, None]) & not_ep).any(dim=1)
        outs.append((killed, certified, d2_e, w2))
    if not outs:
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return valid.clone(), valid.clone(), z, z.clone()
    killed, certified, d2_e, w2 = (torch.cat(v) for v in zip(*outs))
    return killed & valid, certified & valid, d2_e, w2


def _launch(x, cd2k, knn_idx, knn_d2, ea, eb, valid, *, k_check: int, fma: bool, block_e: int):
    dev = x.device
    n, d = x.shape
    m = ea.shape[0]
    k_full = knn_idx.shape[1]
    for name, t in (("cd2k", cd2k), ("knn_idx", knn_idx), ("knn_d2", knn_d2),
                    ("ea", ea), ("eb", eb), ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if cd2k.shape != (n,) or knn_idx.shape != (n, k_full) or knn_d2.shape != (n, k_full):
        raise ValueError(
            f"shapes: cd2k {tuple(cd2k.shape)}, knn_idx {tuple(knn_idx.shape)}, "
            f"knn_d2 {tuple(knn_d2.shape)} do not fit x {tuple(x.shape)}"
        )
    if eb.shape != (m,) or valid.shape != (m,) or valid.dtype != torch.bool:
        raise ValueError("ea, eb and valid must be (m,) with valid of dtype bool")
    if not 0 <= k_check <= k_full:
        raise ValueError(f"k_check={k_check} must lie in [0, {k_full}]")
    killed = torch.empty((m,), dtype=torch.int32, device=dev)
    cert = torch.empty((m,), dtype=torch.int32, device=dev)
    d2_e = torch.empty((m,), dtype=torch.float32, device=dev)
    w2 = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:
        return killed.bool(), cert.bool(), d2_e, w2
    args = (
        x.float().contiguous(), cd2k.float().contiguous(),
        knn_idx.to(torch.int32).contiguous(), knn_d2.float().contiguous(),
        ea.to(torch.int32).contiguous(), eb.to(torch.int32).contiguous(),
        valid.contiguous(),
    )
    fn = _build.load("edge_cascade").repro_edge_cascade
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, p, p, p, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    xs, cds, kis, kds, eas, ebs, vs = args
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(
            xs.data_ptr(), cds.data_ptr(), kis.data_ptr(), kds.data_ptr(), d, k_full,
            eas.data_ptr(), ebs.data_ptr(), vs.data_ptr(), m, k_check, int(fma), block_e,
            killed.data_ptr(), cert.data_ptr(), d2_e.data_ptr(), w2.data_ptr(), stream,
        )
    _build.check(status, "edge_cascade")
    edge_cascade.launches += 1
    return killed.bool(), cert.bool(), d2_e, w2


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
    fma: bool = False,
    chunk: int = 65536,
    block_e: int = 256,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused per-edge cascade: ``(killed, certified, d2_e, w2)``.

    CUDA tensors run the kernel (``block_e`` threads per block); CPU
    tensors run the plain version (``chunk`` edges per step).  ``fma``
    picks the summation order (module docstring).  Invalid slots are False
    in the bool outputs and hold garbage floats.
    """
    if x.device.type == "cpu":
        return edge_cascade_plain(
            x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check=k_check, fma=fma, chunk=chunk
        )
    if x.device.type != "cuda":
        raise ValueError(f"edge_cascade runs on CUDA or CPU tensors; got {x.device}")
    return _launch(x, cd2k, knn_idx, knn_d2, ea, eb, valid, k_check=k_check, fma=fma, block_e=block_e)


edge_cascade.launches = 0


def unpack_keys(ks: torch.Tensor, n_pack: int):
    """Sorted packed keys -> (valid, first-occurrence, lo, hi)."""
    valid = ks != _SENTINEL
    first = torch.ones_like(valid)
    first[1:] = ks[1:] != ks[:-1]
    safe = torch.where(valid, ks, 0)
    return valid, first, torch.div(safe, n_pack, rounding_mode="floor"), safe % n_pack


def stage1_packed(
    x, cd2k, knn_idx, knn_d2, ks, n_pack: int, *, k_check: int, chunk: int, block_e: int, fma: bool = False
):
    """Stage 1 of the fused build: unpack sorted keys, run ``edge_cascade``
    (the kernel on the card), split survivors on the certificate.

    Returns ``(lo, hi, d2, w2, surv_cert, surv_open, n_cert, n_open)`` with
    the two counts as 0-dim device tensors.
    """
    valid, first, lo, hi = unpack_keys(ks, n_pack)
    killed, cert, d2_e, w2 = edge_cascade(
        x, cd2k, knn_idx, knn_d2, lo, hi, valid,
        k_check=k_check, fma=fma, chunk=chunk, block_e=block_e,
    )
    surv = valid & first & ~killed
    surv_cert = surv & cert
    surv_open = surv & ~cert
    return lo, hi, d2_e, w2, surv_cert, surv_open, surv_cert.sum(), surv_open.sum()
