"""The port past K = 256 (fits at kmax >= 250), against the JAX package, on
the CPU.

``ops.knn`` asks the top-K for kmax - 1 + 8 candidates, so a fit at
kmax >= 250 takes lists longer than the list instances' 256: on the card
the select instance of ``csrc/pairwise_topk.cu`` runs them.  Held here:

* the plain version's raw lists at K = 257, 307 and n - 1 (d = 8 and the
  sliced width 320) against the reference's Pallas kernel in interpret
  mode at the 128-row tiles ``tests/test_torch_topk_order.py`` uses: bit
  for bit, and to ``tests/test_torch_wide.py``'s standard (d2 within the
  matmul form's error scale, differing indices only on near-ties, refined
  lists equal); and a K = 257 list's first 256 entries are the K = 256 list;
* a whole fit at kmax = 260 (n = 400, d = 8, four Gaussian blobs: K = 267)
  against the JAX package (kNN, graph edges, MST edge ids and labels
  equal, ``mst_w`` bit-equal), and prediction from it (labels and
  attachment neighbours equal, lambdas within one float32 ulp, as
  ``tests/test_torch_predict.py`` explains);
* the CUDA source itself, through ``tools/cuda_emulate`` (every CUDA thread
  a ``std::thread``): the stored select bit-equal to the plain version at
  every width class (registers, shared-memory rows with and without the
  windows-of-32 norms, the sliced product), on exact duplicates, at
  K = n - 1 and with its sort tile and row chunks set small, so that a
  row takes several sort tiles and the call several chunks (the streamed
  select turned off for these); the streamed select (K <= 1024 at
  d <= 256) bit-equal at the same width classes, on duplicates, at
  K = n - 1 and K = 1024, with its buffers' compaction trigger set small
  and at short lists, so that rows compact many times, and its K = 257
  lists starting with the list instance's K = 256 lists; the routing
  boundary at K = 1024 / 1025; and the list instances, whose distance code
  both share, at K <= 256.
"""

import ctypes
import functools
import importlib
import os
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro.kernels import ops as j_ops
from repro.kernels.pairwise_topk import pairwise_topk as j_pairwise_topk
from repro.train.data import embedding_stream

from repro_torch import api as t_api
from repro_torch.kernels import ops as t_ops

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools import cuda_emulate  # noqa: E402

t_pt = importlib.import_module("repro_torch.kernels.pairwise_topk")

RTOL = 1e-5
N = 600
KMAX_FIT = 260    # K = 267
N_FIT = 400
LAMBDA_ULPS = 1   # tests/test_torch_predict.py: XLA's approximate rsqrt on the CPU
N_EMU = 300       # the emulated grids: a block a row in the select kernel
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embeddings(d: int, seed: int) -> np.ndarray:
    """``embedding_stream`` with 20 near-duplicates, as the curation
    example injects them."""
    x = embedding_stream(seed, N, d)
    x[-20:] = x[:20] + np.random.default_rng(seed).normal(0, 1e-3, x[:20].shape).astype(np.float32)
    return x


@functools.lru_cache(maxsize=None)
def _lists(d: int, k: int):
    """(x, the reference's raw lists, the plain version's) at width d, K = k."""
    x = _embeddings(d, seed=d + 7)
    d_j, i_j = j_pairwise_topk(jnp.asarray(x), k, block_q=128, block_k=128, interpret=True)
    d_t, i_t = t_pt.pairwise_topk(torch.from_numpy(x), k)
    return x, (np.asarray(d_j), np.asarray(i_j)), (d_t.numpy(), i_t.numpy())


LIST_CASES = [(d, k) for d in (8, 320) for k in (257, 307, N - 1)]


@pytest.mark.parametrize("d,k", LIST_CASES)
def test_raw_lists_past_256_equal_the_pallas_kernel(d, k):
    """Bit for bit: the same d2 bits and indices in the same order."""
    _, (d_j, i_j), (d_t, i_t) = _lists(d, k)
    np.testing.assert_array_equal(d_t.view(np.int32), d_j.view(np.int32), err_msg=f"raw d2 bits, d={d}, K={k}")
    np.testing.assert_array_equal(i_t, i_j, err_msg=f"raw indices, d={d}, K={k}")


def _raw_d2_tol(x, idx):
    xn = (x.astype(np.float64) ** 2).sum(1)
    return RTOL * (xn[:, None] + xn[idx])


@pytest.mark.parametrize("d,k", LIST_CASES)
def test_raw_lists_past_256_meet_the_wide_standard(d, k):
    """``tests/test_torch_wide.py``'s standard: d2 within the matmul form's
    error scale, self excluded, indices that differ only on near-ties
    within that scale, and the refined lists (K - 8) equal."""
    x, (d_j, i_j), (d_t, i_t) = _lists(d, k)
    assert d_t.shape == i_t.shape == (N, k)
    assert (np.abs(d_t - d_j) <= _raw_d2_tol(x, i_t)).all()
    assert ((i_t >= 0) & (i_t != np.arange(N)[:, None])).all()
    if k == N - 1:  # every other point, once
        others = np.array([np.delete(np.arange(N), r) for r in range(N)])
        np.testing.assert_array_equal(np.sort(i_t, 1), others)
    rows, cols = np.nonzero(i_t != i_j)
    x64 = x.astype(np.float64)
    exact = lambda i: ((x64[rows] - x64[i[rows, cols]]) ** 2).sum(-1)  # noqa: E731
    near = _raw_d2_tol(x, i_t)[rows, cols] + _raw_d2_tol(x, i_j)[rows, cols]
    assert (np.abs(exact(i_t) - exact(i_j)) <= near).all()
    r_j = j_ops._refine_knn(jnp.asarray(x), jnp.asarray(x), jnp.asarray(i_j), k_top=k - 8)
    r_t = t_ops._refine_knn(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(i_t), k_top=k - 8)
    np.testing.assert_array_equal(r_t[1].numpy(), np.asarray(r_j[1]))
    np.testing.assert_array_equal(r_t[0].numpy(), np.asarray(r_j[0]))


@pytest.mark.parametrize("case", ["d8", "d320", "ties"])
def test_k257_list_starts_with_the_k256_list(case):
    """The lists are the smallest keys in the strict (d2, index) order, so
    the first 256 entries of the K = 257 list are the K = 256 list (on
    exact duplicates too, where the index decides)."""
    rng = np.random.default_rng(11)
    x = {"d8": lambda: _embeddings(8, seed=1), "d320": lambda: _embeddings(320, seed=2),
         "ties": lambda: np.repeat(rng.normal(size=(40, 3)), 8, axis=0).astype(np.float32)}[case]()
    d256, i256 = t_pt.pairwise_topk(torch.from_numpy(x), 256)
    d257, i257 = t_pt.pairwise_topk(torch.from_numpy(x), 257)
    np.testing.assert_array_equal(d257[:, :256].numpy().view(np.int32), d256.numpy().view(np.int32))
    np.testing.assert_array_equal(i257[:, :256].numpy(), i256.numpy())


def test_routing_by_k():
    """K <= 256 stays on the list instances (tiled at d <= 256, sliced
    above); K > 256 takes the streamed select up to KSTREAM at d <= 256 and
    the stored select past it, and at every K above d = 256."""
    assert [t_pt.instance(d, k) for d in (8, 24, 320, 1536) for k in (256, 257)] == [
        "tiled", "stream", "tiled", "stream", "sliced", "select", "sliced", "select"]
    ks = t_pt.KSTREAM
    assert [t_pt.instance(d, k) for d in (8, 256, 257) for k in (ks, ks + 1)] == [
        "stream", "select", "stream", "select", "select", "select"]


def _blobs(n: int, d: int, seed: int) -> np.ndarray:
    """Four Gaussian blobs in [-10, 10]^d, sigma 0.8, and 5% uniform noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(4, d))
    n_noise = n // 20
    x = np.concatenate([centers[rng.integers(0, 4, n - n_noise)] + rng.normal(0.0, 0.8, size=(n - n_noise, d)),
                        rng.uniform(-12.0, 12.0, size=(n_noise, d))])
    return x[rng.permutation(n)].astype(np.float32)


@pytest.fixture(scope="module")
def fits():
    """(x, the reference's model, the port's) at kmax = 260, each package's own fit."""
    x = _blobs(N_FIT, 8, seed=26)
    return x, j_api.FittedModel.fit(x, kmax=KMAX_FIT, backend="jnp"), t_api.FittedModel.fit(
        x, kmax=KMAX_FIT, device="cpu")


def test_kmax260_fit_equals_the_reference(fits):
    _, model_j, model_t = fits
    m_j, m_t = model_j.msts, model_t.msts
    assert m_t.mpts_values == m_j.mpts_values == list(range(2, KMAX_FIT + 1))
    np.testing.assert_array_equal(m_t.knn_idx, np.asarray(m_j.knn_idx))
    np.testing.assert_array_equal(m_t.knn_d2, np.asarray(m_j.knn_d2))
    np.testing.assert_array_equal(m_t.graph.edges, m_j.graph.edges)
    np.testing.assert_array_equal(m_t.mst_ea, m_j.mst_ea)
    np.testing.assert_array_equal(m_t.mst_eb, m_j.mst_eb)
    np.testing.assert_array_equal(m_t.mst_w.view(np.int32), np.asarray(m_j.mst_w).view(np.int32))
    for c_j, c_t in zip(model_j.select_all(), model_t.select_all()):
        np.testing.assert_array_equal(c_t.labels, c_j.labels)


def test_kmax260_prediction_equals_the_reference(fits):
    x, model_j, model_t = fits
    rng = np.random.default_rng(5)
    q = np.concatenate([x[rng.integers(0, len(x), 100)] + rng.normal(0, 0.2, size=(100, x.shape[1])),
                        rng.uniform(-12.0, 12.0, size=(40, x.shape[1])), x[:5]]).astype(np.float32)
    res_j, res_t = model_j.approximate_predict(q), model_t.approximate_predict(q)
    assert res_t.mpts_values == res_j.mpts_values
    np.testing.assert_array_equal(res_t.labels, res_j.labels)
    np.testing.assert_array_equal(res_t.neighbors, res_j.neighbors)
    lam_t, lam_j = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (res_t.lambdas, res_j.lambdas))
    assert int(np.abs(lam_t - lam_j).max()) <= LAMBDA_ULPS
    assert (res_t.labels >= 0).any() and (res_t.labels == -1).any()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/pairwise_topk.cu`` built for the CPU; a function running its C
    entry point on numpy arrays, with the select plan (sort tile, d2 chunk
    bytes) set for the call."""
    if cuda_emulate.compiler() is None:
        pytest.skip("no g++ to build the emulated kernels")
    lib = ctypes.CDLL(str(cuda_emulate.build("pairwise_topk", tmp_path_factory.mktemp("cuda_emulate"))))
    lib.repro_pairwise_topk.argtypes = [P, I, I, I, P, P, P, P]
    lib.repro_pairwise_topk.restype = I
    lib.repro_pairwise_topk_workspace.argtypes = [I, I, I, P]
    lib.repro_pairwise_topk_workspace.restype = I
    lib.repro_pairwise_topk_set_select_plan.argtypes = [I, ctypes.c_size_t, P, P]
    lib.repro_pairwise_topk_set_select_plan.restype = None
    lib.repro_pairwise_topk_set_stream_plan.argtypes = [I, I, P, P]
    lib.repro_pairwise_topk_set_stream_plan.restype = None

    def set_plan(sort_tile: int, chunk_bytes: int) -> tuple[int, int]:
        before = ctypes.c_int(), ctypes.c_size_t()
        lib.repro_pairwise_topk_set_select_plan(sort_tile, chunk_bytes, ctypes.addressof(before[0]),
                                                ctypes.addressof(before[1]))
        return before[0].value, before[1].value

    def set_stream(cap: int, from_k: int) -> tuple[int, int]:
        before = ctypes.c_int(), ctypes.c_int()
        lib.repro_pairwise_topk_set_stream_plan(cap, from_k, ctypes.addressof(before[0]),
                                                ctypes.addressof(before[1]))
        return before[0].value, before[1].value

    def workspace(n: int, d: int, k: int) -> int:
        nbytes = ctypes.c_size_t()
        assert lib.repro_pairwise_topk_workspace(n, d, k, ctypes.addressof(nbytes)) == 0
        return nbytes.value

    def run(x: np.ndarray, k: int, sort_tile: int = 0, chunk_bytes: int = 0, cap: int = -1, from_k: int = 0):
        """The lists of x at K = k; the select plan (sort tile, d2 chunk
        bytes) and the stream plan (compaction trigger, the K above which
        the streamed select runs) set for the call, 0 / -1 leaving them."""
        n, d = x.shape
        before, before_stream = set_plan(sort_tile, chunk_bytes), set_stream(cap, from_k)
        try:
            work = np.zeros(workspace(n, d, k) // 4 + 64, np.float32)
            out_d, out_i = np.zeros((n, k), np.float32), np.zeros((n, k), np.int32)
            assert lib.repro_pairwise_topk(x.ctypes.data, n, d, k, out_d.ctypes.data, out_i.ctypes.data,
                                           work.ctypes.data, None) == 0
        finally:
            set_plan(*before)
            set_stream(*before_stream)
        return out_d, out_i

    run.workspace = workspace
    return run


def _emu_points(case: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "ties":  # each point 8 times, 38 rows apart: ties in every bin
        return np.tile(rng.normal(size=(N_EMU // 8, 2)), (8, 1)).astype(np.float32)
    if case == "line":  # points in order along a line: a row's earlier keys come nearer and nearer
        return (np.sort(rng.normal(size=(N_EMU, 1)), 0) * np.linspace(1.0, 2.0, 8)).astype(np.float32)
    d = int(case[1:])
    return (rng.normal(size=(N_EMU, d)) + rng.integers(0, 3, size=(N_EMU, 1)) * 2.0).astype(np.float32)


def _assert_lists_equal(out, want, case, k):
    np.testing.assert_array_equal(out[0].view(np.int32), want[0].view(np.int32), err_msg=f"d2 bits, {case}, K={k}")
    np.testing.assert_array_equal(out[1], want[1], err_msg=f"indices, {case}, K={k}")


def _plain(x: np.ndarray, k: int):
    return tuple(v.numpy() for v in t_pt.pairwise_topk_plain(torch.from_numpy(x), k))


# (points, K, sort tile, chunk bytes): d = 8 in registers, 24 in shared
# memory with fmaf-chain norms, 64 with the windows-of-32 pre-pass, 320 the
# sliced product; duplicates; K = n - 1; several sort tiles of 64 or 128
# keys and chunks of 128 rows (chunk bytes 1: the least, one tile of rows)
EMU_SELECT = [("d8", 257, 0, 0), ("d8", N_EMU - 1, 128, 1), ("d24", 257, 0, 0), ("d64", 270, 64, 1),
              ("d320", N_EMU - 1, 128, 1), ("ties", 290, 128, 1)]


@pytest.mark.parametrize("case,k,sort_tile,chunk", EMU_SELECT)
def test_emulated_select_instance_equals_the_plain_version(emulated, case, k, sort_tile, chunk):
    """The stored select, the streamed select turned off (it would take
    every case at d <= 256)."""
    x = _emu_points(case)
    _assert_lists_equal(emulated(x, k, sort_tile, chunk, from_k=t_pt.KSTREAM), _plain(x, k), case, k)


# (points, K, compaction trigger (-1: the whole buffer), the K above which
# the instance runs (0: past the lists)): d = 8 and 24 (rows in registers,
# two a warp; in shared memory), 64 with the windows-of-32 norms, duplicates
# and K = n - 1 past the lists (K = 257 once with the trigger at K + 32:
# one compaction in the sweep); then short lists with the trigger at
# K + 32, where a row compacts about (K / 32) ln(n / (K + 32)) times on
# clustered points and every round once its nearer keys come in order
# ("line")
EMU_STREAM = [("d8", 257, -1, 0), ("d8", 257, 289, 0), ("d24", 263, -1, 0), ("d64", 270, -1, 0),
              ("ties", 290, -1, 0), ("d8", N_EMU - 1, -1, 0), ("d8", 40, 72, 16), ("d24", 40, 72, 16),
              ("d64", 48, 80, 16), ("line", 40, 72, 16), ("ties", 100, 132, 16)]


@pytest.mark.parametrize("case,k,cap,from_k", EMU_STREAM)
def test_emulated_stream_instance_equals_the_plain_version(emulated, case, k, cap, from_k):
    x = _emu_points(case)
    if from_k == 0:
        assert t_pt.instance(x.shape[1], k) == "stream"
    _assert_lists_equal(emulated(x, k, cap=cap, from_k=from_k), _plain(x, k), case, k)


@pytest.mark.parametrize("case", ["d8", "ties"])
def test_emulated_stream_k257_starts_with_the_k256_list(emulated, case):
    """The streamed select's K = 257 lists start with the list instance's
    K = 256 lists, bit for bit, and compacting often changes nothing."""
    x = _emu_points(case)
    d256, i256 = emulated(x, 256)
    for cap in (-1, 257 + 32):
        d257, i257 = emulated(x, 257, cap=cap)
        _assert_lists_equal((d257[:, :256].copy(), i257[:, :256].copy()), (d256, i256), case, 257)


def test_emulated_stream_at_kstream_and_the_routing_boundary(emulated):
    """K = KSTREAM runs the streamed select (four rows a block, buffers of
    2048 keys) bit-equal to the plain version; ``dispatch`` routes
    K = KSTREAM + 1 to the stored select, which asks for a chunk of d2 rows
    in the workspace where the streamed select asks for none (or the norms
    alone, d > 32)."""
    ks = t_pt.KSTREAM
    x = (np.random.default_rng(27).normal(size=(ks + 2, 2)) * 3.0).astype(np.float32)
    _assert_lists_equal(emulated(x, ks), _plain(x, ks), "d2", ks)
    n = ks + 100
    assert [t_pt.instance(d, k) for d in (8, 64) for k in (ks, ks + 1)] == ["stream", "select"] * 2
    assert emulated.workspace(n, 8, ks) == 0 < emulated.workspace(n, 8, ks + 1)
    assert emulated.workspace(n, 64, ks) == 4 * n < emulated.workspace(n, 64, ks + 1)
    assert emulated.workspace(n, 320, 300) > 4 * n  # past d = 256 the stored select at every K


@pytest.mark.parametrize("case,k", [("d8", 23), ("d8", 256), ("d24", 135), ("d320", 31)])
def test_emulated_list_instances_equal_the_plain_version(emulated, case, k):
    """The list instances after their distance code moved into the shared
    device functions (``load_rows``, ``row_d2``, ``sliced_d2_tile``)."""
    x = _emu_points(case)
    out_d, out_i = emulated(x, k)
    want_d, want_i = (v.numpy() for v in t_pt.pairwise_topk_plain(torch.from_numpy(x), k))
    np.testing.assert_array_equal(out_d.view(np.int32), want_d.view(np.int32), err_msg=f"d2 bits, {case}, K={k}")
    np.testing.assert_array_equal(out_i, want_i, err_msg=f"indices, {case}, K={k}")
