"""The SBCN emission's tile products above d = 256 in XLA's float32 order
(``repro_torch.kernels.sbcn_tile``), against XLA on the CPU.

XLA hands the reference's tier einsum ``"pad,pbd->pab"`` and the row
path's 2-D products to YNNPACK, whose kernel depends on the tile: the bits
of ``tile_dots_plain`` under ``dot_order(A, B, d)`` are held to XLA's own
output for every tier of the fused path, for the slot path's wider tiles,
on ragged widths (tails of one to seven products) and across 512- and
1024-deep slices; the slot path's products too: ``_sbcn_large``'s 2-D
chunks, single pairs at a = 1 (XLA's own loop, ``sbcn_tile.LOOP``, at
every remainder of d % 32) and odd last slices; ``point_norms_plain`` to
``jnp.sum(x * x, -1)`` under ``jit``.  The slot path's candidates equal
the reference's.  The reference's own ``_tier_emit`` and
``_rowpath_emit`` then give the port's keys and counters on
embedding-like inputs, where the torch products miss by a candidate.
The CUDA sources run on the CPU in ``test_torch_sbcn_kernels.py``.
"""

from __future__ import annotations

import importlib
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sbcn as j_sbcn  # noqa: E402
from repro.train.data import embedding_stream  # noqa: E402

from repro_torch.core import sbcn as t_sbcn  # noqa: E402

st = importlib.import_module("repro_torch.kernels.sbcn_tile")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_EINSUM = jax.jit(lambda a, b: jnp.einsum("pad,pbd->pab", a, b))
_DOT2D = jax.jit(lambda a, b: a @ b.T)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


_TILES = [(1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (2, 8), (4, 4), (4, 8), (8, 16), (16, 16), (4, 64)]


_WIDE_TILES = [(2, 32), (4, 32), (32, 32)]


@pytest.mark.parametrize("tile,d", [(t, d) for d in (320, 1536) for t in _TILES + _WIDE_TILES]
                         + [(t, 323) for t in _TILES if t[0] > 1] + [((1, 2), 321), ((1, 8), 1537)]
                         + [(t, d) for d in (1100, 1099, 326) for t in ((1, 2), (1, 8))]
                         + [(t, d) for d in (1100, 321, 1025) for t in _WIDE_TILES])
def test_tile_dots_match_xla_batched_dot(tile, d):
    """Every fused-path tier (A <= 4, B <= 8) and the slot path's wider
    tiles, at d = 320, 1536 and ragged widths: the 4-lane tail unfused,
    the 8-lane one (d = 1100, 1099, 326 at A = 1) an FMA chain, and the
    (A >= 2, 32) tiles' 2 lanes over 1024-deep slices."""
    a, b = tile
    rng = np.random.default_rng(d + 7 * a + b)
    n, P = 64, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    ai = rng.integers(0, n, (P, a)).astype(np.int32)
    bi = rng.integers(0, n, (P, b)).astype(np.int32)
    want = _EINSUM(x[ai], x[bi])
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _cells(rng, rc: int, nb: int, m: int = 1500):
    """Sampled (row, column) cells of an (rc, nb) product: random ones and
    the last rows and columns, where a tiling's edge tiles fall."""
    ci = np.concatenate([rng.integers(0, rc, m), np.full(64, rc - 1), np.arange(64) % rc])
    cj = np.concatenate([rng.integers(0, nb, m), np.arange(nb - 64, nb), np.full(64, nb - 1)])
    return ci.astype(np.int32), cj.astype(np.int32)


@pytest.mark.parametrize("rc,nb,d", [(3, 600, 320), (512, 600, 1536), (100, 700, 320), (2048, 2100, 320),
                                     (2048, 2080, 1536), (2, 1000, 1536), (17, 513, 1101), (5, 4000, 777),
                                     (1, 600, 320), (1, 1000, 1536), (1, 513, 1101), (3, 544, 4097),
                                     (1, 600, 4097)])
def test_sbcn_large_chunks_match_xla_2d_dot(rc, nb, d):
    """``_sbcn_large``'s products (the reference's 2-D ``xa @ xb.T`` over
    a chunk of rc = min(2048, na) rows): the library's lanes follow the
    columns (2 lanes at nb = 600, 2080 and 4000, one chain at 700 and
    2100, 4 lanes at 513 and 1000, each in its slices, the tail after
    them); a single row takes XLA's own loop below d = 4096 and one FMA
    chain from there."""
    rng = np.random.default_rng(rc + nb + d)
    x = rng.normal(size=(rc + nb, d)).astype(np.float32)
    want = _DOT2D(x[:rc], x[rc:])
    order = st.dot_order(rc, nb, d, "2d")
    assert (order == st.LOOP) == (rc == 1 and d < st.LOOP_MAX_D)
    ci, cj = _cells(rng, rc, nb)
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ci)[:, None], torch.from_numpy(rc + cj)[:, None],
                             order)
    np.testing.assert_array_equal(_bits(got[:, 0, 0]), _bits(np.asarray(want)[ci, cj]))


@pytest.mark.parametrize("tile,d", [((1, 8), 320), ((1, 2), 1536), ((1, 512), 777), ((1, 64), 1101),
                                    ((1, 4), 4097), ((2, 8), 1536)])
def test_single_pairs_match_xla_einsum(tile, d):
    """A tier of one pair (the reference's chunk of 1): at a = 1 XLA's own
    loop (``LOOP``) below d = 4096, the batched kernel's 8 lanes from
    there; at a >= 2 the batched order."""
    a, b = tile
    rng = np.random.default_rng(d + a + b)
    x = rng.normal(size=(b + 64, d)).astype(np.float32)
    ai = rng.integers(0, b + 64, (1, a)).astype(np.int32)
    bi = rng.integers(0, b + 64, (1, b)).astype(np.int32)
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi), kind="single")
    np.testing.assert_array_equal(_bits(got), _bits(_EINSUM(x[ai], x[bi])))


@pytest.mark.parametrize("tile,batch,d", [((2, 32), 8, 1101), ((4, 32), 8, 1101), ((2, 32), 2, 1027),
                                          ((8, 32), 4, 1537), ((4, 8), 4, 5000), ((2, 4), 2, 8200)])
def test_odd_last_slices_match_xla_einsum(tile, batch, d):
    """The (a >= 2, 32) tiers past one 1024-deep slice with an odd last
    slice: the 2 lanes run over d - 1 products in slices, the last product
    after them; and the 4-lane tiers in slices of 32768 / b past 4096."""
    a, b = tile
    rng = np.random.default_rng(d + batch + a)
    x = rng.normal(size=(96, d)).astype(np.float32)
    ai = rng.integers(0, 96, (batch, a)).astype(np.int32)
    bi = rng.integers(0, 96, (batch, b)).astype(np.int32)
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi))
    np.testing.assert_array_equal(_bits(got), _bits(_EINSUM(x[ai], x[bi])))


@pytest.mark.parametrize("d", [32 * t + r for t in (9, 24) for r in range(32)])
def test_xla_loop_matches_every_remainder(d):
    """XLA's own loop (``LOOP``), unrolled (9 steps of 32) and looped (24),
    at each of the 32 remainders d % 32 (``LOOP_EPILOGUE``)."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(9, d)).astype(np.float32)
    got = st.tile_dots_plain(torch.from_numpy(x), torch.zeros((1, 1), dtype=torch.int32),
                             torch.arange(1, 9, dtype=torch.int32)[None], st.LOOP)
    np.testing.assert_array_equal(_bits(got), _bits(_EINSUM(x[None, :1], x[None, 1:])))


@pytest.mark.parametrize("d,pair_cap", [(320, 1), (1536, 1), (320, None), (1536, None)])
def test_the_slot_path_matches_the_reference(d, pair_cap):
    """``sbcn_candidates`` on ``embedding_stream`` points with
    near-duplicates: every pair oversized (``pair_cap=1``: 2-D chunks, the
    one-row ones in XLA's loop) or in its tier (single pairs at a = 1 and
    batched tiers): no warning, and ``(lo, hi, keep)`` equal to the
    reference's."""
    n = 400
    x = embedding_stream(5, n, d)
    x[-30:] = x[:30] + np.random.default_rng(d).normal(0, 1e-3, x[:30].shape).astype(np.float32)
    cd = np.zeros(n, np.float32)
    perm = np.random.default_rng(1).permutation(n)
    # one (1, 8) tier pair, one (1, 2), two (2, 32), and 3 x 600-ish pairs past the tiers
    a_start = np.array([0, 1, 2, 4, 6, 10, 100])
    a_len = np.array([1, 1, 2, 2, 1, 3, 90])
    b_start = np.array([200, 210, 220, 260, 20, 120, 210])
    b_len = np.array([7, 2, 30, 32, 190, 100, 190])
    kw = {} if pair_cap is None else {"pair_cap": pair_cap}
    want = j_sbcn.sbcn_candidates(jnp.asarray(x), jnp.asarray(cd), perm, a_start, a_len, b_start, b_len, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = t_sbcn.sbcn_candidates(torch.from_numpy(x), torch.from_numpy(cd), perm, a_start, a_len, b_start,
                                     b_len, **kw)
    keep_j, keep_t = np.asarray(want[2]), got[2].numpy()
    assert keep_t.sum() == keep_j.sum() > 0
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy()[keep_t], np.asarray(w)[keep_j])


@pytest.mark.parametrize("shape", [(32, 64), (64, 128), (256, 64)])
def test_tile_dots_match_xla_2d_dot(shape):
    """The row path's (rc, d) x (nb, d)^T products: FMA chains over 512-deep
    panels (three at d = 1536), as ``dot_order`` gives for those tiles."""
    rc, nb = shape
    rng = np.random.default_rng(rc + nb)
    x = rng.normal(size=(rc + nb, 1536)).astype(np.float32)
    want = _DOT2D(x[:rc], x[rc:])
    ai = np.arange(rc, dtype=np.int32)[None]
    bi = np.arange(rc, rc + nb, dtype=np.int32)[None]
    assert st.dot_order(rc, nb, 1536) == (1, False, 512)
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi))[0]
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d", [320, 1536])
def test_point_norms_match_xla(d):
    x = (np.random.default_rng(d).normal(size=(300, d)) * 3).astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a * a, -1))(x)
    np.testing.assert_array_equal(_bits(st.point_norms_plain(torch.from_numpy(x))), _bits(want))


@pytest.mark.parametrize("d,seed", [(320, 0), (1536, 1), (1536, 4)])
def test_emission_matches_the_reference(d, seed):
    """``_tier_emit`` over 1024 random (4, 8) tiles of ``embedding_stream``
    points (20 near-duplicates, core distances 0) and ``_rowpath_emit`` over
    a block of (2 chunks of 32 rows) x 64 pairs: keys and counters equal
    the reference's.  At d = 1536 under seeds 1 and 4 the torch products
    (``xn=None``) emit one candidate more than the reference: the case the
    exact order repairs."""
    n = 600
    x = embedding_stream(seed, n, d)
    x[-20:] = x[:20] + np.random.default_rng(seed).normal(0, 1e-3, x[:20].shape).astype(np.float32)
    rng = np.random.default_rng(seed + 11)
    cd = np.zeros(n, np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cd)
    xn = t_sbcn.point_norms(xt)
    assert xn is not None
    a = rng.integers(0, n, (1024, 4)).astype(np.int32)
    b = rng.integers(0, n, (1024, 8)).astype(np.int32)
    keys_j, cnt_j = j_sbcn._tier_emit(jnp.asarray(x), jnp.asarray(cd), jnp.asarray(a), jnp.asarray(b),
                                      jnp.int32(n), tie_cap=2)
    keys_t, cnt_t = t_sbcn._tier_emit(xt, ct, torch.from_numpy(a), torch.from_numpy(b), n, tie_cap=2, xn=xn)
    np.testing.assert_array_equal(np.sort(keys_t.numpy()), np.sort(np.asarray(keys_j)))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    if d == 1536:
        _, cnt_bmm = t_sbcn._tier_emit(xt, ct, torch.from_numpy(a), torch.from_numpy(b), n, tie_cap=2)
        assert int(cnt_bmm[0]) == int(cnt_j[0]) + 1
    a = rng.integers(0, n, (2, 2, 32)).astype(np.int32)
    b = rng.integers(0, n, (2, 64)).astype(np.int32)
    a[1, 1, 20:] = -1
    b[1, 50:] = -1
    keys_j, cnt_j = j_sbcn._rowpath_emit(jnp.asarray(x), jnp.asarray(cd), jnp.asarray(a), jnp.asarray(b),
                                         jnp.int32(n), tie_cap=2)
    keys_t, cnt_t = t_sbcn._rowpath_emit(xt, ct, torch.from_numpy(a), torch.from_numpy(b), n, tie_cap=2, xn=xn)
    np.testing.assert_array_equal(np.sort(keys_t.numpy()), np.sort(np.asarray(keys_j)))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def test_the_torch_products_stay_up_to_256():
    assert t_sbcn.point_norms(torch.zeros((4, st.EXACT_ORDER_D))) is None
    assert t_sbcn.point_norms(torch.zeros((4, st.EXACT_ORDER_D + 1))) is not None
    with pytest.raises(ValueError, match="CUDA or CPU"):
        st.tile_dots(torch.zeros((2, 4), device="meta"), torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros((1, 1), dtype=torch.int32))
