"""Symmetric Bichromatic Closest Neighbors over WSPD pairs (paper §IV-E),
the port of ``repro/core/sbcn.py``.

For each well-separated pair (A, B), connect a in A and b in B iff b is a's
closest point in B and a is b's closest point in A, w.r.t. ``mrd_kmax``.
All tied minima within a norm-scaled tolerance are kept (a superset of the
single-argmin SBCN), which preserves the RNG-superset property.

Two emission paths, as in the reference:

  * ``cascade_candidates`` (fused path, default): at most ``tie_cap``
    packed int32 keys ``lo * n + hi`` per (pair, A-row), with the exact
    per-row tie-overflow count so the caller can fall back.
  * ``sbcn_candidates`` (slot path): every tied minimum of every tile cell,
    compacted and deduplicated; the fallback and the ``ref`` backend.

Pairs are grouped by padded size on the host (numpy) and each group runs
as batched tensor work on the plan's device.  The reference pads every
chunk to a fixed shape so XLA compiles few programs; eager PyTorch has
nothing to compile, so the port chunks without padding.  The key multiset
is the same, and the keys are sorted before anyone reads them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import sbcn_tile

_PAIR_ELEM_CAP = 1 << 18  # max padded |A|*|B| handled by the batched slot path
_TILE_ELEMS = 1 << 22     # elements per slot-path tier chunk
_ROW_CHUNK = 2048         # row chunk for oversized pairs
_SENTINEL = 2**31 - 1     # int32 max: invalid / duplicate slot marker
_EPS = 64.0 * 1.1920929e-07

_SMALL_AMAX = 4           # bucketed-tier path bounds (pow2-exact tiers)
_SMALL_BMAX = 8
_TIER_CHUNK_ELEMS = 1 << 17
_ROWPATH_PAIR_BLOCK = 32


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def compact_idx(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """Positions of the first ``cap`` True entries of a 1-D mask, in order.

    A cumsum-and-scatter (the counterpart of ``jnp.nonzero(size=cap)``):
    the caller already holds the count, so no host sync happens here.
    """
    dst = torch.where(mask, torch.cumsum(mask, 0) - 1, cap)
    out = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dst, torch.arange(mask.shape[0], device=mask.device))
    return out[:cap]


def point_norms(x):
    """Per-point |x|^2 for the tiles' exact order where the width needs it
    (d > ``sbcn_tile.EXACT_ORDER_D``), else None (the torch products)."""
    return sbcn_tile.point_norms(x) if x.shape[1] > sbcn_tile.EXACT_ORDER_D else None


def _mrd_tile(x, cd2k, a_idx, b_idx, xn=None, kind="batched"):
    """(P, A, B) squared mrd tile (inf on padded cells) + its tie tolerance.

    a_idx (P, A) / b_idx (P, B) point ids padded with -1.  Matmul-form d2,
    as the reference's ``_mutual_mask`` computes it.  With ``xn`` (the
    points' norms from ``point_norms``, d > 256) the norms and the dot
    carry the reference's float32 bits (``kernels.sbcn_tile``: the kernel
    on the card, its plain version on the CPU; ``kind`` names the product
    the reference computes, ``sbcn_tile.dot_order``); without, torch's own
    sums, whose candidates equal the reference's on every fixture up to
    d = 100.
    """
    eps = torch.tensor(_EPS, dtype=torch.float32, device=x.device)
    if xn is not None:
        an = xn[a_idx.clamp_min(0).long()]
        bn = xn[b_idx.clamp_min(0).long()]
        dot = sbcn_tile.tile_dots(x, a_idx, b_idx, kind)
    else:
        xa = x[a_idx.clamp_min(0).long()].float()
        xb = x[b_idx.clamp_min(0).long()].float()
        an = (xa * xa).sum(-1)
        bn = (xb * xb).sum(-1)
        dot = torch.bmm(xa, xb.transpose(1, 2))
    d2 = an[:, :, None] + bn[:, None, :] - 2.0 * dot
    d2 = torch.clamp_min(d2, 0.0)
    ca = cd2k[a_idx.clamp_min(0).long()]
    cb = cd2k[b_idx.clamp_min(0).long()]
    mrd2 = torch.maximum(torch.maximum(ca[:, :, None], cb[:, None, :]), d2)
    invalid = (a_idx < 0)[:, :, None] | (b_idx < 0)[:, None, :]
    mrd2 = torch.where(invalid, float("inf"), mrd2)
    tol = eps * (an[:, :, None] + bn[:, None, :])
    return mrd2, tol


def _mutual_mask(x, cd2k, a_idx, b_idx, xn=None, kind="batched"):
    """(P, A, B) bool SBCN mask for one batch of padded pairs."""
    mrd2, tol = _mrd_tile(x, cd2k, a_idx, b_idx, xn, kind)
    row_min = mrd2.amin(dim=2, keepdim=True)
    col_min = mrd2.amin(dim=1, keepdim=True)
    return (mrd2 <= row_min + tol) & (mrd2 <= col_min + tol) & torch.isfinite(mrd2)


def _pack_keys(lo, hi, n_pack: int, found):
    return torch.where(found, lo * n_pack + hi, _SENTINEL)


def _emit_from_mask(mask, a_idx, b_idx, n_pack: int, tie_cap: int):
    """Per-row first-``tie_cap`` emission from an SBCN mask.

    Returns (keys (P*A*w,) int32, counters (2,) int32): packed keys and
    [n_mutual_slots, n_rows_overflowing].
    """
    P, A, B = mask.shape
    if B <= max(tie_cap, 4):
        # narrow tiers: every cell is a slot, nothing is dropped
        lo = torch.minimum(a_idx[:, :, None], b_idx[:, None, :])
        hi = torch.maximum(a_idx[:, :, None], b_idx[:, None, :])
        keys = _pack_keys(lo, hi, n_pack, mask)
        zero = torch.zeros((), dtype=torch.int32, device=mask.device)
        counters = torch.stack([mask.sum(dtype=torch.int32), zero])
        return keys.reshape(-1), counters
    iota_b = torch.arange(B, device=mask.device)
    m = mask
    keys = []
    for _ in range(min(tie_cap, B)):  # a row has at most B set columns
        j = m.to(torch.int32).argmax(dim=2)                    # first set column
        found = m.gather(2, j[..., None])[..., 0]
        gb = b_idx.gather(1, j)
        keys.append(
            _pack_keys(torch.minimum(a_idx, gb), torch.maximum(a_idx, gb), n_pack, found)
        )
        m = m & (iota_b[None, None, :] != j[..., None])
    counts = mask.sum(dim=2, dtype=torch.int32)
    counters = torch.stack(
        [counts.sum(dtype=torch.int32), (counts > tie_cap).sum(dtype=torch.int32)]
    )
    return torch.stack(keys, dim=-1).reshape(-1), counters


def _tier_emit(x, cd2k, a_idx, b_idx, n_pack: int, *, tie_cap: int, xn=None):
    """One bucketed-tier chunk -> bounded packed keys + counters."""
    return _emit_from_mask(_mutual_mask(x, cd2k, a_idx, b_idx, xn), a_idx, b_idx, n_pack, tie_cap)


def _rowpath_emit(x, cd2k, a_chunks, b_idx, n_pack: int, *, tie_cap: int, xn=None):
    """Row-chunked SBCN emission for a block of same-shape oversized pairs.

    a_chunks (Pb, nc, rc) int32 padded -1; b_idx (Pb, nb) padded -1.  Pass 1
    reduces the column minima over the row chunks, pass 2 re-evaluates each
    chunk against them, so the working set is O(Pb * rc * nb).
    """
    nc = a_chunks.shape[1]
    if nc == 1:
        return _tier_emit(x, cd2k, a_chunks[:, 0], b_idx, n_pack, tie_cap=tie_cap, xn=xn)
    col_min = None
    for c in range(nc):
        mrd2, _ = _mrd_tile(x, cd2k, a_chunks[:, c], b_idx, xn)
        cm = mrd2.amin(dim=1, keepdim=True)
        col_min = cm if col_min is None else torch.minimum(col_min, cm)
    keys, counters = [], []
    for c in range(nc):
        ac = a_chunks[:, c]
        mrd2, tol = _mrd_tile(x, cd2k, ac, b_idx, xn)
        row_min = mrd2.amin(dim=2, keepdim=True)
        mask = (mrd2 <= row_min + tol) & (mrd2 <= col_min + tol) & torch.isfinite(mrd2)
        k, cnt = _emit_from_mask(mask, ac, b_idx, n_pack, tie_cap)
        keys.append(k)
        counters.append(cnt)
    return torch.cat(keys), torch.stack(counters).sum(dim=0, dtype=torch.int32)


def _sort_dedup_stats(keys):
    """Sort packed keys (sentinels last); return (sorted, n_real, n_unique)."""
    ks = torch.sort(keys).values
    valid = ks != _SENTINEL
    first = torch.ones_like(valid)
    first[1:] = ks[1:] != ks[:-1]
    return ks, valid.sum(dtype=torch.int32), (valid & first).sum(dtype=torch.int32)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def _pow2_ceil_np(v: np.ndarray) -> np.ndarray:
    """Vectorized pow2 round-up (exact: log2 of small ints is exact in f64)."""
    return np.left_shift(np.int64(1), np.ceil(np.log2(np.maximum(v, 1))).astype(np.int64))


def _padded_gather(perm, starts, lens, width: int, rows: int):
    """(rows, width) int32 point-id matrix from (start, len) perm ranges,
    padded with -1 (short ranges and missing rows)."""
    out = np.full((rows, width), -1, np.int32)
    k = len(starts)
    if k:
        r = starts[:, None] + np.arange(width)[None, :]
        v = np.arange(width)[None, :] < lens[:, None]
        out[:k] = np.where(v, perm[np.minimum(r, len(perm) - 1)], -1)
    return out


def _canonical_pairs(a_start, a_len, b_start, b_len):
    """Swap each pair so that |A| <= |B|."""
    swap = a_len > b_len
    return (
        np.where(swap, b_start, a_start), np.where(swap, b_len, a_len),
        np.where(swap, a_start, b_start), np.where(swap, a_len, b_len),
    )


def cascade_candidates(
    x: torch.Tensor,
    cd2_kmax: torch.Tensor,
    perm: np.ndarray,
    a_start: np.ndarray,
    a_len: np.ndarray,
    b_start: np.ndarray,
    b_len: np.ndarray,
    *,
    tie_cap: int = 2,
    tier_chunk_elems: int = _TIER_CHUNK_ELEMS,
):
    """Bounded-emission SBCN candidates as sorted packed int32 keys.

    Returns device tensors ``(keys_sorted, n_real, n_unique, n_mutual,
    n_overflow)``; the real keys come first, sentinels after them.
    ``n_overflow > 0`` means some (pair, row) had more than ``tie_cap``
    tied minima and the caller must fall back to ``sbcn_candidates``.  No
    host sync happens here.  Requires n <= 46340 (packed keys fit int32).
    """
    dev = x.device
    n = int(x.shape[0])
    xn = point_norms(x)
    perm = perm.astype(np.int32)
    a_start, a_len, b_start, b_len = _canonical_pairs(a_start, a_len, b_start, b_len)
    key_parts: list[torch.Tensor] = []
    counter_parts: list[torch.Tensor] = []

    # singleton-singleton pairs ARE their own SBCN edge: emitted on the host
    ss = (a_len == 1) & (b_len == 1)
    n_ss = int(ss.sum())
    if n_ss:
        pa, pb = perm[a_start[ss]], perm[b_start[ss]]
        ss_keys = np.minimum(pa, pb).astype(np.int64) * n + np.maximum(pa, pb)
        key_parts.append(_dev(ss_keys.astype(np.int32), dev))

    rest = np.nonzero(~ss)[0]
    if len(rest):
        al, bl = a_len[rest], b_len[rest]
        small = (al <= _SMALL_AMAX) & (bl <= _SMALL_BMAX)
        ka, kb = _pow2_ceil_np(al), _pow2_ceil_np(bl)
        for key in np.unique(ka[small] * 16 + kb[small]) if small.any() else []:
            kaa, kbb = int(key) // 16, int(key) % 16
            sel = rest[small & (ka == kaa) & (kb == kbb)]
            a_pad = _dev(_padded_gather(perm, a_start[sel], a_len[sel], kaa, len(sel)), dev)
            b_pad = _dev(_padded_gather(perm, b_start[sel], b_len[sel], kbb, len(sel)), dev)
            chunk = max(8, tier_chunk_elems // (kaa * kbb))
            for c0 in range(0, len(sel), chunk):
                keys_c, counters_c = _tier_emit(
                    x, cd2_kmax, a_pad[c0 : c0 + chunk], b_pad[c0 : c0 + chunk], n,
                    tie_cap=tie_cap, xn=xn,
                )
                key_parts.append(keys_c)
                counter_parts.append(counters_c)

        # row path: everything larger, grouped by padded shape
        rp = rest[~small]
        if len(rp):
            na, nb = a_len[rp], b_len[rp]
            rc = np.minimum(256, np.maximum(32, _pow2_ceil_np(na)))
            nc = _pow2_ceil_np(-(-na // rc))
            nbp = np.maximum(64, _pow2_ceil_np(nb))
            shape_key = rc * (1 << 40) + nc * (1 << 20) + nbp
            for skey in np.unique(shape_key):
                grp_all = rp[shape_key == skey]
                rcc = int(rc[shape_key == skey][0])
                ncc = int(nc[shape_key == skey][0])
                nbb = int(nbp[shape_key == skey][0])
                pb = int(min(_ROWPATH_PAIR_BLOCK, max(2, (1 << 21) // (ncc * rcc * nbb))))
                for g0 in range(0, len(grp_all), pb):
                    grp = grp_all[g0 : g0 + pb]
                    a_blk = _padded_gather(perm, a_start[grp], a_len[grp], ncc * rcc, len(grp))
                    b_blk = _padded_gather(perm, b_start[grp], b_len[grp], nbb, len(grp))
                    keys_c, counters_c = _rowpath_emit(
                        x, cd2_kmax,
                        _dev(a_blk.reshape(len(grp), ncc, rcc), dev), _dev(b_blk, dev), n,
                        tie_cap=tie_cap, xn=xn,
                    )
                    key_parts.append(keys_c)
                    counter_parts.append(counters_c)

    if not key_parts:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.full((8,), _SENTINEL, dtype=torch.int32, device=dev), zero, zero, zero, zero
    keys_sorted, n_real, n_unique = _sort_dedup_stats(torch.cat(key_parts))
    if counter_parts:
        counters = torch.stack(counter_parts).sum(dim=0, dtype=torch.int32)
    else:
        counters = torch.zeros((2,), dtype=torch.int32, device=dev)
    return keys_sorted, n_real, n_unique, counters[0] + n_ss, counters[1]


# ---------------------------------------------------------------------------
# Slot path: every tied minimum of every tile cell
# ---------------------------------------------------------------------------


def _sbcn_tier_chunk(x, cd2k, a_idx, b_idx, xn=None, kind="batched"):
    """One tier chunk -> flat (lo, hi) candidate slots, sentinel off-mask;
    ``kind`` is ``"single"`` where the reference's chunk is one pair."""
    mutual = _mutual_mask(x, cd2k, a_idx, b_idx, xn, kind)
    lo = torch.minimum(a_idx[:, :, None], b_idx[:, None, :])
    hi = torch.maximum(a_idx[:, :, None], b_idx[:, None, :])
    return (
        torch.where(mutual, lo, _SENTINEL).reshape(-1),
        torch.where(mutual, hi, _SENTINEL).reshape(-1),
    )


def _sbcn_large(x, cd2k, a_idx, b_idx, *, row_chunk: int = _ROW_CHUNK, xn=None):
    """Row-chunked SBCN mask (na, nb) for one oversized pair: pass 1 reduces
    the column minima, pass 2 re-evaluates each chunk against them.  The
    reference pads the rows to whole chunks of ``min(row_chunk, na)``, so
    its 2-D products have that many rows; a ragged last chunk here
    pads likewise.  Each chunk's product is the reference's 2-D
    ``xa @ xb.T`` (``sbcn_tile.dot_order``'s ``"2d"``)."""
    b2 = b_idx[None]
    rc = min(row_chunk, a_idx.shape[0])
    pad = -a_idx.shape[0] % rc
    a_pad = torch.cat([a_idx, torch.full((pad,), -1, dtype=a_idx.dtype, device=a_idx.device)])
    chunks = [a_pad[None, r0 : r0 + rc] for r0 in range(0, a_pad.shape[0], rc)]
    col_min = None
    for ac in chunks:
        cm = _mrd_tile(x, cd2k, ac, b2, xn, "2d")[0].amin(dim=1, keepdim=True)
        col_min = cm if col_min is None else torch.minimum(col_min, cm)
    masks = []
    for ac in chunks:
        m, tol = _mrd_tile(x, cd2k, ac, b2, xn, "2d")
        row_min = m.amin(dim=2, keepdim=True)
        masks.append(((m <= row_min + tol) & (m <= col_min + tol) & torch.isfinite(m))[0])
    return torch.cat(masks)[: a_idx.shape[0]]


def _dedup_sorted(lo, hi):
    """Sort (lo, hi) slots lexicographically; keep marks the first
    occurrence of each real edge."""
    order = torch.argsort((lo.long() << 32) | hi.long())
    lo, hi = lo[order], hi[order]
    first = torch.ones_like(lo, dtype=torch.bool)
    first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    return lo, hi, (lo != _SENTINEL) & first


def sbcn_candidates(
    x: torch.Tensor,
    cd2_kmax: torch.Tensor,
    perm: np.ndarray,
    a_start: np.ndarray,
    a_len: np.ndarray,
    b_start: np.ndarray,
    b_len: np.ndarray,
    *,
    tile_elems: int = _TILE_ELEMS,
    pair_cap: int = _PAIR_ELEM_CAP,
    row_chunk: int = _ROW_CHUNK,
):
    """All SBCN candidate edges across WSPD pairs, device-resident.

    Returns ``(lo, hi, keep)``: int32 endpoint slots sorted by (lo, hi) and
    a bool mask of the unique real edges.  One scalar sync
    (``candidate_slots``) sizes the compaction ahead of the dedup sort.
    """
    from .. import engine

    dev = x.device
    xn = point_norms(x)
    perm = perm.astype(np.int64)
    a_start, a_len, b_start, b_len = _canonical_pairs(a_start, a_len, b_start, b_len)
    los: list[torch.Tensor] = []
    his: list[torch.Tensor] = []

    ss = (a_len == 1) & (b_len == 1)
    if ss.any():
        pa = perm[a_start[ss]].astype(np.int32)
        pb = perm[b_start[ss]].astype(np.int32)
        los.append(_dev(np.minimum(pa, pb), dev))
        his.append(_dev(np.maximum(pa, pb), dev))

    rest = np.nonzero(~ss)[0]
    if len(rest):
        al, bl = a_len[rest], b_len[rest]
        tiers = np.array([1, 2, 4, 8, 16, 32, 64, 128, 256, 512], np.int64)

        def tier_of(v):
            return tiers[np.searchsorted(tiers, np.minimum(v, tiers[-1]))]

        ka, kb = tier_of(al), tier_of(bl)
        big = (al > tiers[-1]) | (bl > tiers[-1]) | (ka * kb > pair_cap)
        for key in np.unique(ka[~big] * (1 << 32) + kb[~big]):
            kaa, kbb = int(key >> 32), int(key & ((1 << 32) - 1))
            sel = rest[(ka == kaa) & (kb == kbb) & ~big]
            a_pad = _dev(_padded_gather(perm, a_start[sel], a_len[sel], kaa, len(sel)), dev)
            b_pad = _dev(_padded_gather(perm, b_start[sel], b_len[sel], kbb, len(sel)), dev)
            chunk = max(1, min(tile_elems // (kaa * kbb), _pow2_ceil(len(sel))))
            kind = "single" if chunk == 1 else "batched"
            for c0 in range(0, len(sel), chunk):
                lo_c, hi_c = _sbcn_tier_chunk(
                    x, cd2_kmax, a_pad[c0 : c0 + chunk], b_pad[c0 : c0 + chunk], xn, kind
                )
                los.append(lo_c)
                his.append(hi_c)
        for gi in np.nonzero(big)[0]:
            sel = rest[gi]
            a = _dev(perm[a_start[sel] : a_start[sel] + a_len[sel]].astype(np.int32), dev)
            b = _dev(perm[b_start[sel] : b_start[sel] + b_len[sel]].astype(np.int32), dev)
            mutual = _sbcn_large(x, cd2_kmax, a, b, row_chunk=row_chunk, xn=xn)
            lo = torch.minimum(a[:, None], b[None, :])
            hi = torch.maximum(a[:, None], b[None, :])
            los.append(torch.where(mutual, lo, _SENTINEL).reshape(-1))
            his.append(torch.where(mutual, hi, _SENTINEL).reshape(-1))

    empty = (
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev),
        torch.zeros((0,), dtype=torch.bool, device=dev),
    )
    if not los:
        return empty
    lo_all, hi_all = torch.cat(los), torch.cat(his)
    real = lo_all != _SENTINEL
    n_real = int(engine.to_host(real.sum(), "candidate_slots"))
    if n_real == 0:
        return empty
    pos = compact_idx(real, n_real)
    return _dedup_sorted(lo_all[pos], hi_all[pos])
