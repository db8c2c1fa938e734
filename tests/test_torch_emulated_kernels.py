"""The CUDA sources of the port's two chain kernels, run on the CPU.

``tools.cuda_emulate`` compiles ``csrc/prim_mst.cu`` and
``csrc/single_linkage.cu`` with g++, every CUDA thread a ``std::thread``,
so the thread-block cluster's pushes and waits, the block and warp
reductions and the staged union-find run as written.  Their C entry points
are held here to the plain PyTorch versions, which ``tests/test_torch_baseline.py``
and ``tests/test_torch_core.py`` hold to the JAX package: ``prim_mst``'s src
equal and w2 bit-equal under every plan (clusters of 3 and 4 at these
sizes, so blocks own several vertices a thread and the last block a
ragged share), on ties within and across cluster ranks; ``single_linkage``'s
left, right and size equal under both layouts.
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

from repro_torch.core import linkage as t_linkage  # noqa: E402

pm = importlib.import_module("repro_torch.kernels.prim_mst")
sl = importlib.import_module("repro_torch.kernels.single_linkage")
pt = importlib.import_module("repro_torch.kernels.pairwise_topk")

P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if cuda_emulate.compiler() is None:
        pytest.skip("no g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emulate")
    prim = ctypes.CDLL(str(cuda_emulate.build("prim_mst", out)))
    prim.repro_prim_mst.argtypes = [P, P, I, I, I, I, I, I, P, P, P]
    prim.repro_prim_mst.restype = I
    prim.repro_prim_mst_floor.argtypes = [I, I, I, P, P]
    prim.repro_prim_mst_floor.restype = I
    link = ctypes.CDLL(str(cuda_emulate.build("single_linkage", out)))
    link.repro_single_linkage.argtypes = [P, P, I, I, I, P, P, P, P, P]
    link.repro_single_linkage.restype = I
    return prim, link


def _prim_case(n, d, ties, seed):
    """Gaussian blobs and squared core distances (7th neighbour); with
    ``ties`` every point 8 times, ``"near"`` (copies side by side) or
    ``"apart"`` (n / 8 rows apart), and core distances rounded to a decimal."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) + rng.integers(0, 4, size=(n, 1)) * 3.0).astype(np.float32)
    if ties == "near":
        x = np.ascontiguousarray(np.repeat(x[: -(-n // 8)], 8, axis=0)[:n])
    elif ties == "apart":
        x = np.ascontiguousarray(np.tile(x[: -(-n // 8)], (8, 1))[:n])
    cd2 = pt.pairwise_topk_plain(torch.from_numpy(x), 10 if ties else 7)[0][:, -1]
    if ties:
        cd2 = torch.round(cd2, decimals=1)
    return x, np.ascontiguousarray(cd2.numpy(), dtype=np.float32)


def _aligned(a):
    """A 16-byte aligned float32 copy of ``a`` (the kernel reads rows as float4)."""
    buf = np.zeros(a.size + 4, np.float32)
    off = (-buf.ctypes.data % 16) // 4
    out = buf[off:off + a.size]
    out[:] = a.ravel()
    return out


@pytest.mark.parametrize("n, d, ties, forced, cluster", [
    (150, 2, None, {}, 4),
    (150, 8, "near", {}, 4),
    (150, 8, "apart", {}, 4),
    (97, 3, None, {}, 3),
    (120, 40, None, {}, 4),
    (130, 8, None, dict(points="device"), 3),
    (130, 8, "apart", dict(state="device"), 4),
    (90, 33, "near", dict(points="device"), 3),
    (70, 32, None, {}, 4),
    (9, 3, None, {}, 16),
    (1, 2, None, {}, 4),
])
def test_prim_mst_source_matches_the_plain_version(libs, n, d, ties, forced, cluster):
    x, cd2 = _prim_case(n, d, ties, seed=n + d)
    plan = pm.plan_for(n, d, cluster, **forced)
    # the fewest threads, so that threads own several vertices
    src, w2 = np.zeros(n, np.int32), np.zeros(n, np.float32)
    xa = _aligned(x)
    status = libs[0].repro_prim_mst(xa.ctypes.data, cd2.ctypes.data, n, d, plan.cluster, 32,
                                    plan.points == "shared", plan.state == "shared", src.ctypes.data,
                                    w2.ctypes.data, None)
    assert status == 0
    s_p, w_p = pm.prim_mst_plain(torch.from_numpy(x), torch.from_numpy(cd2))
    np.testing.assert_array_equal(src, s_p.numpy())
    np.testing.assert_array_equal(w2.view(np.int32), w_p.numpy().view(np.int32))
    if ties:
        assert len(np.unique(w2)) < n // 4


def test_prim_mst_source_refuses_plans_that_do_not_fit(libs):
    x, cd2 = _prim_case(64, 8, None, seed=1)
    xa = _aligned(x)
    src, w2 = np.zeros(64, np.int32), np.zeros(64, np.float32)
    args = (xa.ctypes.data, cd2.ctypes.data, 64, 8)
    outs = (src.ctypes.data, w2.ctypes.data, None)
    # the points without the state, 17 blocks, 48 threads (not whole warps)
    for cluster, threads, points, state in ((4, 32, 1, 0), (17, 32, 1, 1), (4, 48, 1, 1)):
        assert libs[0].repro_prim_mst(*args, cluster, threads, points, state, *outs) != 0
    big = 300000  # 12 bytes of state a vertex on a cluster of 1: past the budget
    assert libs[0].repro_prim_mst(xa.ctypes.data, cd2.ctypes.data, big, 8, 1, 32, 0, 1, *outs) != 0
    assert libs[0].repro_prim_mst_floor(20, 4, 64, np.zeros(4, np.uint32).ctypes.data, None) == 0


@pytest.mark.parametrize("n, rows, layout", [
    (1500, 2, "shared"), (1500, 2, "device"), (513, 3, "shared"), (513, 3, "device"),
    (2, 1, "shared"), (1025, 2, "device"),
])
def test_single_linkage_source_matches_the_plain_version(libs, n, rows, layout):
    ea, eb, w = t_linkage.random_spanning_trees(n, rows, seed=3 + n, ties=True)
    order = np.argsort(w, axis=1, kind="stable")
    ea_s, eb_s = (np.ascontiguousarray(np.take_along_axis(e, order, 1).astype(np.int32)) for e in (ea, eb))
    outs = [np.zeros((rows, n - 1), np.int32) for _ in range(3)]
    scratch = np.zeros((rows, n), np.int64)
    status = libs[1].repro_single_linkage(ea_s.ctypes.data, eb_s.ctypes.data, rows, n, layout == "shared",
                                          scratch.ctypes.data, *(o.ctypes.data for o in outs), None)
    assert status == 0
    want = sl.single_linkage_plain(torch.from_numpy(ea_s), torch.from_numpy(eb_s), n=n)
    for got, ref in zip(outs, want):
        np.testing.assert_array_equal(got, ref.numpy())
    assert (outs[2][:, -1] == n).all()


def test_single_linkage_source_refuses_shared_state_past_its_limit(libs):
    n = sl.SMEM_MAX_N + 1
    z = np.zeros((1, n - 1), np.int32)
    assert libs[1].repro_single_linkage(z.ctypes.data, z.ctypes.data, 1, n, 1, None, z.ctypes.data,
                                        z.ctypes.data, z.ctypes.data, None) != 0
    assert libs[1].repro_single_linkage(z.ctypes.data, z.ctypes.data, 1, n, 0, None, z.ctypes.data,
                                        z.ctypes.data, z.ctypes.data, None) != 0  # device layout, no scratch
