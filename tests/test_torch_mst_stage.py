"""The port's MST stage (``core/multi.py``) against the JAX package, on the CPU.

The stage turns the (R, m) MST masks into (R, n-1) edge ids, endpoints and
weights (``_compact_mst_rows``) and, past ``MST_CHUNK_ELEMS`` mask entries,
runs a chunk of rows at a time.  Held here:

* the compaction against the reference's ``repro.core.multi._compact_mst_rows``
  on random masks: full rows of n - 1 edges, rows with fewer (none, one, a
  few) and rows whose edges sit at both ends of the id range; ids,
  endpoints, weight bits and counts equal;
* that the compaction builds no int64 array of R x m elements (every op's
  output is recorded under a dispatch mode): the int64 (R, m) cumsum, its
  positions and the broadcast edge ids set the memory of a kmax = 256 fit;
* a fit whose MST stage runs a few rows at a time equals the same fit in one
  chunk, bit for bit (the rows' MSTs do not depend on each other).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax.numpy as jnp

from repro.core import multi as j_multi

from repro_torch import api as t_api
from repro_torch.core import multi as t_multi


def _masks(seed: int, r: int, m: int, n: int) -> np.ndarray:
    """R rows of m edge flags: n - 1 set in most rows, fewer in some."""
    rng = np.random.default_rng(seed)
    sizes = [n - 1, 0, 1, rng.integers(2, n - 1), n - 1][:r] + list(rng.integers(0, n, r))[: max(0, r - 5)]
    masks = np.zeros((r, m), bool)
    for row, size in enumerate(sizes):
        masks[row, rng.choice(m, int(size), replace=False)] = True
    masks[-1, [0, m - 1]] = True  # edge ids at both ends of the range
    return masks


@pytest.mark.parametrize("seed,r,m,n", [(0, 5, 300, 50), (1, 9, 1000, 120), (2, 3, 64, 40), (3, 12, 2048, 300)])
def test_compaction_equals_the_reference(seed, r, m, n):
    masks = _masks(seed, r, m, n)
    rng = np.random.default_rng(seed + 100)
    ea, eb = (rng.integers(0, n, m).astype(np.int32) for _ in range(2))
    w = rng.random((r, m)).astype(np.float32)
    got = t_multi._compact_mst_rows(*(torch.from_numpy(v) for v in (masks, ea, eb, w)), n=n)
    want = j_multi._compact_mst_rows(*(jnp.asarray(v) for v in (masks, ea, eb, w)), n=n)
    for name, g, e in zip(("ea", "eb", "mst_w", "counts"), got, want):
        g, e = g.numpy(), np.asarray(e)
        assert g.dtype == e.dtype and g.shape == e.shape, name
        np.testing.assert_array_equal(g.view(np.int32), e.view(np.int32), err_msg=name)


class _Outputs(TorchDispatchMode):
    """Records (dtype, element count) of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen += [(t.dtype, t.numel()) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        return out


def test_compaction_builds_no_int64_rows_by_edges():
    r, m, n = 8, 4096, 200
    masks = _masks(4, r, m, n)
    rng = np.random.default_rng(5)
    args = (torch.from_numpy(masks), *(torch.from_numpy(rng.integers(0, n, m).astype(np.int32)) for _ in range(2)),
            torch.from_numpy(rng.random((r, m)).astype(np.float32)))
    with _Outputs() as rec:
        t_multi._compact_mst_rows(*args, n=n)
    assert rec.seen, "the dispatch mode saw the compaction's ops"
    big = [(dt, k) for dt, k in rec.seen if dt == torch.int64 and k >= r * m]
    assert not big, f"int64 arrays of R x m elements or more: {big}"


def _blobs(n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10.0, 10.0, size=(4, d))
    x = centers[rng.integers(0, 4, n)] + rng.normal(0.0, 0.8, size=(n, d))
    return x.astype(np.float32)


def test_chunked_mst_stage_equals_one_chunk(monkeypatch):
    """kmax = 24 (23 rows): one chunk by default, then three rows at a time
    (the chunk's bound set to three rows of the graph's edges)."""
    x = _blobs(300, 4, seed=27)
    whole = t_api.FittedModel.fit(x, kmax=24, device="cpu").msts
    monkeypatch.setattr(t_multi, "MST_CHUNK_ELEMS", 3 * len(whole.graph.edges))
    chunked = t_api.FittedModel.fit(x, kmax=24, device="cpu").msts
    assert t_multi.MST_CHUNK_ELEMS // len(chunked.graph.edges) == 3  # eight chunks of the 23 rows
    np.testing.assert_array_equal(chunked.mst_ea, whole.mst_ea)
    np.testing.assert_array_equal(chunked.mst_eb, whole.mst_eb)
    np.testing.assert_array_equal(chunked.mst_w.view(np.int32), whole.mst_w.view(np.int32))
