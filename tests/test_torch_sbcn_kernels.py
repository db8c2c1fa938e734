"""The SBCN tiles' CUDA sources on the CPU: ``csrc/sbcn_tile.cu`` on each
of its paths (bucketed, dense, XLA's loop, direct) under every template
instance, and the windows-of-32 norms pre-pass ``csrc/norms_win32.cuh``,
compiled with g++ through ``tools/cuda_emulate`` (every CUDA thread a
``std::thread``), equal their plain versions
(``repro_torch.kernels.sbcn_tile``) bit for bit, padded cells included.
The plain versions are held to XLA in ``test_torch_sbcn_order.py``.
"""

from __future__ import annotations

import ctypes
import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import cuda_emulate  # noqa: E402

st = importlib.import_module("repro_torch.kernels.sbcn_tile")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if cuda_emulate.compiler() is None:
        pytest.skip("no g++ to build the emulated kernel")
    lib = ctypes.CDLL(str(cuda_emulate.build("sbcn_tile", tmp_path_factory.mktemp("cuda_emulate"))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_sbcn_tile_dots.argtypes = [p, i, i, p, p, i, i, i, i, i, i, i, p, p, p]
    lib.repro_sbcn_tile_dots.restype = i
    lib.repro_sbcn_tile_scratch_ints.argtypes = [i, i, i, i, i]
    lib.repro_sbcn_tile_scratch_ints.restype = ctypes.c_longlong
    return lib


def _emulated_dots(lib, x, a, b, order, path):
    n, d = x.shape
    P, A, B = a.shape[0], a.shape[1], b.shape[1]
    scratch = np.zeros(max(1, lib.repro_sbcn_tile_scratch_ints(n, P, A, B, order[0])), np.int32)
    out = np.full((P, A, B), np.nan, np.float32)
    status = lib.repro_sbcn_tile_dots(x.ctypes.data, n, d, a.ctypes.data, b.ctypes.data, P, A, B, order[0],
                                      int(order[1]), order[2], st.PATHS.index(path), out.ctypes.data,
                                      scratch.ctypes.data, None)
    assert status == 0
    return out


def _ids(rng, n, shape, pad=0.1, lo=0):
    v = rng.integers(lo, n, shape)
    v[rng.random(shape) < pad] = -1
    return v.astype(np.int32)


_INSTANCES = [(8, False, 0), (8, True, 0), (4, False, 0), (4, True, 0), (2, False, 1024), (2, False, 64),
              (1, False, 512), (1, False, 64), (4, False, 36), (8, False, 40)]


@pytest.mark.parametrize("order,d", [(o, d) for o in _INSTANCES for d in (100, 323)]
                         + [((8, True, 0), 1100), ((2, False, 1024), 1100), ((4, False, 36), 1100)])
def test_cuda_source_equals_the_plain_version(emulated, order, d):
    """The bucketed path under every template instance (8, 4, 2 and 1
    lanes, halved and pairwise, with and without slices, slices that end
    inside a 32-column stage, ragged tails, 16- and 4-byte copies): on 300
    points (buckets of 128 rows on a 3 x 3 grid), cells on the tiles'
    edges, repeated cells, padded ids, a bucket of one cell and one of more
    cells than a block holds; and the direct path: bit-equal."""
    rng = np.random.default_rng(d + order[0] + order[2])
    n = 300
    x = rng.normal(size=(n, d)).astype(np.float32)
    edges = np.array([0, 127, 128, 255, 256, 299], np.int32)
    cases = [
        (_ids(rng, n, (40, 2)), _ids(rng, n, (40, 8))),                               # every bucket
        (np.repeat(edges[None, :3], 6, 0), np.repeat(edges[None, 3:], 6, 0)),          # tile edges, repeated cells
        (np.array([[5, -1]], np.int32), np.array([[299, 7, -1]], np.int32)),            # one cell in bucket (0, 2)
        (_ids(rng, 100, (300, 1), 0.0), _ids(rng, 100, (300, 8), 0.0)),                 # 2400 cells in bucket (0, 0)
    ]
    for a, b in cases:
        want = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), order)
        for path in ("bucketed", "direct"):
            got = _emulated_dots(emulated, x, a, b, order, path)
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"{path} {a.shape} x {b.shape}")


@pytest.mark.parametrize("n", [700, 11600])
def test_cuda_bucketed_path_past_the_shared_histogram(emulated, n):
    """More keys than a block counts in shared memory (6 x 6 buckets by
    a-row at n = 700; 91 x 91 buckets at n = 11600, past which a bucket
    is one key): the cells go to their keys through global atomics;
    bit-equal."""
    rng = np.random.default_rng(n)
    d = 100
    x = rng.normal(size=(n, d)).astype(np.float32)
    a, b = _ids(rng, n, (40, 1)), _ids(rng, n, (40, 4))
    for order in ((8, True, 0), (4, False, 0)):
        want = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), order)
        np.testing.assert_array_equal(_bits(_emulated_dots(emulated, x, a, b, order, "bucketed")), _bits(want))


@pytest.mark.parametrize("d,shape", [(100, (2, 40, 64)), (1100, (1, 64, 128)), (323, (3, 33, 64)),
                                     (1537, (1, 100, 192))])
def test_cuda_dense_path_equals_the_plain_version(emulated, d, shape):
    """The dense path (one lane, 4 x 4 cells a thread) on the row path's
    and ``_sbcn_large``'s chunks: blocks past A and B's ends, padded rows
    and columns, 512-deep slices: bit-equal."""
    P, A, B = shape
    rng = np.random.default_rng(d + A)
    n = 200
    x = rng.normal(size=(n, d)).astype(np.float32)
    a, b = _ids(rng, n, (P, A), 0.05), _ids(rng, n, (P, B), 0.05)
    order = st.dot_order(A, B, d)
    assert order[0] == 1 and st.kernel_path(order, A, B, n) == "dense"
    want = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), order)
    np.testing.assert_array_equal(_bits(_emulated_dots(emulated, x, a, b, order, "dense")), _bits(want))


@pytest.mark.parametrize("d", [32 * 9 + r for r in (0, 3, 5, 7, 12, 16, 26, 31)] + [32 * 18 + 9, 1537])
def test_cuda_loop_path_equals_the_plain_version(emulated, d):
    """XLA's loop (``LOOP``), unrolled and looped, its epilogue's vector
    stages, padded ids: bit-equal."""
    rng = np.random.default_rng(d)
    n = 40
    x = rng.normal(size=(n, d)).astype(np.float32)
    a, b = _ids(rng, n, (3, 1)), _ids(rng, n, (3, 17))
    want = st.tile_dots_plain(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), st.LOOP)
    np.testing.assert_array_equal(_bits(_emulated_dots(emulated, x, a, b, st.LOOP, "loop")), _bits(want))


def test_cuda_source_refuses_what_it_has_no_instance_of(emulated):
    x = np.ones((4, 8), np.float32)
    ids = np.zeros((1, 1), np.int32)
    out = np.zeros(1, np.float32)
    scratch = np.zeros(64, np.int32)
    for lanes, halve, panel, path in ((3, 0, 0, 2), (2, 1, 0, 2), (4, 0, 6, 2), (2, 0, 0, 1), (0, 0, 0, 2),
                                      (1, 0, 0, 7)):
        bad = emulated.repro_sbcn_tile_dots(x.ctypes.data, 4, 8, ids.ctypes.data, ids.ctypes.data, 1, 1, 1, lanes,
                                            halve, panel, path, out.ctypes.data, scratch.ctypes.data, None)
        assert bad != 0, (lanes, halve, panel, path)


def test_kernel_paths_match_the_source(emulated):
    """``kernel_path``'s limits are the source's."""
    lib = ctypes.CDLL(emulated._name)
    lib.repro_sbcn_tile_max_tiles.restype = ctypes.c_int
    assert lib.repro_sbcn_tile_max_tiles() == st.MAX_TILES
    assert st.kernel_path(st.LOOP, 1, 600, 10) == "loop"
    assert st.kernel_path((1, False, 512), 32, 64, 10) == "dense"
    assert st.kernel_path((1, False, 512), 16, 64, 10) == "bucketed"
    assert st.kernel_path((8, True, 0), 1, 2, st.BUCKET_ROWS * st.MAX_TILES) == "bucketed"
    assert st.kernel_path((8, True, 0), 1, 2, st.BUCKET_ROWS * st.MAX_TILES + 1) == "direct"


@pytest.fixture(scope="module")
def emulated_norms(tmp_path_factory):
    if cuda_emulate.compiler() is None:
        pytest.skip("no g++ to build the emulated kernel")
    lib = ctypes.CDLL(str(cuda_emulate.build("norms_win32", tmp_path_factory.mktemp("cuda_emulate_norms"))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_norms_win32.argtypes = [p, i, i, p]
    lib.repro_norms_win32.restype = i
    return lib


@pytest.mark.parametrize("n,d", [(100, 33), (100, 320), (25, 1100), (30, 1536), (9, 4097)])
def test_cuda_norms_equal_the_plain_version(emulated_norms, n, d):
    """The windows-of-32 norms pre-pass (``csrc/norms_win32.cuh``): rows
    staged a block at a time (n not a multiple of a block's rows), 16- and
    4-byte loads, windows of windows past d = 1024: bit-equal to
    ``point_norms_plain``."""
    x = (np.random.default_rng(d).normal(size=(n, d)) * 3).astype(np.float32)
    out = np.full(n, np.nan, np.float32)
    assert emulated_norms.repro_norms_win32(x.ctypes.data, n, d, out.ctypes.data) == 0
    np.testing.assert_array_equal(_bits(out), _bits(st.point_norms_plain(torch.from_numpy(x))))
