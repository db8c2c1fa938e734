"""The SBCN emission's tile products above d = 256 in XLA's float32 order
(``repro_torch.kernels.sbcn_tile``), against XLA on the CPU.

XLA hands the reference's tier einsum ``"pad,pbd->pab"`` and the row
path's 2-D products to YNNPACK, whose kernel depends on the tile: the bits
of ``tile_dots_plain`` under ``dot_order(A, B)`` are held to XLA's own
output for every tier of the fused path, for the slot path's wider tiles,
on ragged widths (tails of one to seven products) and across 512- and
1024-deep slices; ``point_norms_plain`` to ``jnp.sum(x * x, -1)`` under
``jit``.  Where ``order_known`` says the order is a guess, XLA's bits do
differ and the slot path warns.  The reference's own ``_tier_emit`` and
``_rowpath_emit`` then give the port's keys and counters on
embedding-like inputs, where the torch products miss by a candidate.
Last, the CUDA source (``csrc/sbcn_tile.cu``) runs on the CPU through
``tools/cuda_emulate`` and equals the plain version bit for bit, padded
cells included.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import cuda_emulate  # noqa: E402

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
    assert st.order_known(a, b, d, 24)
    rng = np.random.default_rng(d + 7 * a + b)
    n, P = 64, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    ai = rng.integers(0, n, (P, a)).astype(np.int32)
    bi = rng.integers(0, n, (P, b)).astype(np.int32)
    want = _EINSUM(x[ai], x[bi])
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("batch,tile,d", [(1, (1, 8), 320), (1, (1, 2), 1536), (8, (2, 32), 1101),
                                          (1, (3, 600), 320), (1, (512, 600), 1536)])
def test_guessed_orders_differ_from_xla_and_are_flagged(batch, tile, d):
    """Where ``order_known`` is False, XLA's bits differ from
    ``dot_order``'s: single pairs at A = 1, the (A >= 2, 32) tiles at odd
    d past one slice, and the slot path's oversized pairs (P = 1, sides
    not powers of two)."""
    a, b = tile
    assert not st.order_known(a, b, d, batch)
    rng = np.random.default_rng(d + a + b)
    n = b + 64
    x = rng.normal(size=(n, d)).astype(np.float32)
    ai = rng.integers(0, n, (batch, a)).astype(np.int32)
    bi = rng.integers(0, n, (batch, b)).astype(np.int32)
    want = _EINSUM(x[ai], x[bi])
    got = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(ai), torch.from_numpy(bi))
    assert (_bits(got) != _bits(want)).any()


def test_the_slot_path_warns_on_guessed_orders():
    """Every pair oversized (``pair_cap=1``) at d = 320: the slot path
    warns; at a pair cap that keeps the pairs in known tiers it does not."""
    rng = np.random.default_rng(3)
    n, d = 40, 320
    xt = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    cd = torch.zeros(n)
    perm = np.arange(n)
    a_start, a_len = np.array([0, 10]), np.array([3, 2])
    b_start, b_len = np.array([20, 30]), np.array([7, 8])
    with pytest.warns(RuntimeWarning, match="not read from XLA"):
        t_sbcn.sbcn_candidates(xt, cd, perm, a_start, a_len, b_start, b_len, pair_cap=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t_sbcn.sbcn_candidates(xt, cd, perm, a_start, a_len, b_start, b_len)


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
    assert st.dot_order(rc, nb) == (1, False, 512)
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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if cuda_emulate.compiler() is None:
        pytest.skip("no g++ to build the emulated kernel")
    lib = ctypes.CDLL(str(cuda_emulate.build("sbcn_tile", tmp_path_factory.mktemp("cuda_emulate"))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_sbcn_tile_dots.argtypes = [p, i, p, p, i, i, i, i, i, i, p, p]
    lib.repro_sbcn_tile_dots.restype = i
    return lib


@pytest.mark.parametrize("d", [9, 323, 1100])
def test_cuda_source_equals_the_plain_version(emulated, d):
    """Every template instance (8, 4, 2 and 1 lanes, halved and pairwise,
    with and without slices, ragged tails in the last slice), tiles packed
    several to a block and tiles split into 16 x 16 blocks, padded ids:
    bit-equal."""
    rng = np.random.default_rng(d)
    n = 50
    x = rng.normal(size=(n, d)).astype(np.float32)
    for a_w, b_w, order in ((1, 2, None), (1, 8, None), (2, 2, None), (4, 8, None), (4, 4, (4, True, 0)),
                            (20, 40, None), (3, 17, (1, False, 32)), (2, 32, None), (2, 3, (2, False, 32)),
                            (1, 5, (8, False, 64))):
        order = order or st.dot_order(a_w, b_w)
        P = 5
        a = rng.integers(-1, n, (P, a_w)).astype(np.int32)
        b = rng.integers(-1, n, (P, b_w)).astype(np.int32)
        out = np.full((P, a_w, b_w), np.nan, np.float32)
        status = emulated.repro_sbcn_tile_dots(x.ctypes.data, d, a.ctypes.data, b.ctypes.data, P, a_w, b_w,
                                               order[0], int(order[1]), order[2], out.ctypes.data, None)
        assert status == 0
        want = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), order)
        np.testing.assert_array_equal(_bits(out), _bits(want), err_msg=f"{(a_w, b_w)} {order}")
    out = np.zeros(1, np.float32)
    for lanes, panel in ((3, 0), (2, 48)):  # no such instance; a slice that is not a multiple of 32
        bad = emulated.repro_sbcn_tile_dots(x.ctypes.data, d, x.ctypes.data, x.ctypes.data, 1, 1, 1, lanes, 0, panel,
                                            out.ctypes.data, None)
        assert bad != 0
