"""The port past the card kernels' earlier limits (d > 256, K > 128),
against the JAX package, on the CPU.

Embedding-like inputs (``train.data.embedding_stream``, the stand-in for
LM-pooled states) at d = 320 and 1536 (qwen2-1.5b's width) with injected
near-duplicates, fitted at kmax = 24 as the curation example does; and a
kmax = 128 fit (K = 135, the reference's largest ``paper_sweeps`` kmax).
The reference runs its ``jnp`` backend (Pallas kernels in interpret mode
for the kernel checks); the port runs ``device="cpu"`` (the kernels' plain
versions).  kNN, graph edges, MST edge ids and labels must be equal, and
d2, w2 and MST weights bit-equal; raw top-K d2 agree to the matmul form's
error scale, 1e-5 * (|q|^2 + |k|^2).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multi as j_multi
from repro.kernels import fused_cascade as j_fc
from repro.kernels import ops as j_ops
from repro.kernels.pairwise_topk import pairwise_topk as j_pairwise_topk
from repro.train.data import embedding_stream

from repro_torch.core import multi as t_multi
from repro_torch.kernels import fused_cascade as t_fc
from repro_torch.kernels import ops as t_ops

t_pt = importlib.import_module("repro_torch.kernels.pairwise_topk")

RTOL = 1e-5
N = 600
KMAX = 24
KMAX_WIDE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embeddings(d: int, seed: int = 0) -> np.ndarray:
    """``embedding_stream`` with 20 near-duplicates, as the curation
    example injects them."""
    x = embedding_stream(seed, N, d)
    x[-20:] = x[:20] + np.random.default_rng(seed).normal(0, 1e-3, x[:20].shape).astype(np.float32)
    return x


@pytest.mark.parametrize("d", [1025, 1536, 4096])
def test_sum_sq_win32_matches_jnp_sum_past_32_windows(d):
    """Above 32 windows (d > 1024) XLA sums the window sums in windows of
    32 in turn: ``sum_sq_win32`` equals ``jnp.sum(v * v, -1)`` under
    ``jit`` bit for bit there too."""
    rng = np.random.default_rng(d)
    a = (rng.normal(size=(512, d)) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a * a, -1))(a))
    np.testing.assert_array_equal(t_ops.sum_sq_win32(torch.from_numpy(a)).numpy(), ref)


@pytest.fixture(scope="module")
def fits():
    """Per case: (x, reference result, port result)."""
    out = {}
    for name, x, kmax in (("d1536", _embeddings(1536), KMAX), ("d320", _embeddings(320, seed=1), KMAX),
                          ("kmax128", _embeddings(8, seed=2), KMAX_WIDE)):
        out[name] = (x, j_multi.multi_hdbscan(x, kmax, backend="jnp"), t_multi.multi_hdbscan(x, kmax, device="cpu"))
    return out


@pytest.mark.parametrize("name", ["d1536", "d320", "kmax128"])
def test_wide_fit_graph_equals_the_reference(fits, name):
    """kNN, core distances and the graph equal the reference's.  The SBCN
    emission's candidate counts may differ by a few near-ties: it keeps
    every pair within its tie tolerance of the matmul-form d2, which XLA's
    einsum and ``torch.bmm`` sum in different orders, and at d >= 320 that
    noise moves a few pairs across the tolerance (d = 1536: 3 of 36359).
    Such a pair only adds a candidate that the cascade then removes, so
    the edges, their weights and every later count are equal."""
    _, ref, port = fits[name]
    np.testing.assert_array_equal(port.knn_idx, np.asarray(ref.knn_idx))
    np.testing.assert_array_equal(np.asarray(port.cd2), np.asarray(ref.cd2))
    np.testing.assert_array_equal(port.graph.edges, ref.graph.edges)
    np.testing.assert_array_equal(port.graph.d2, ref.graph.d2)
    np.testing.assert_array_equal(port.graph.w2_kmax, ref.graph.w2_kmax)
    for key in ("path", "n_wspd_pairs", "m_certified", "m_edges"):
        assert port.graph.stats[key] == ref.graph.stats[key], key
    for key in ("m_candidates", "m_removed_knn"):
        got, want = port.graph.stats[key], ref.graph.stats[key]
        assert abs(got - want) <= 1e-3 * want, (key, got, want)
    assert (port.graph.stats["m_candidates"] - port.graph.stats["m_removed_knn"]
            == ref.graph.stats["m_candidates"] - ref.graph.stats["m_removed_knn"])


@pytest.mark.parametrize("name", ["d1536", "d320", "kmax128"])
def test_wide_fit_msts_and_labels_equal_the_reference(fits, name):
    _, ref, port = fits[name]
    assert port.mpts_values == ref.mpts_values
    for h_j, h_t in zip(ref.hierarchies, port.hierarchies):
        msg = f"{name} mpts={h_j.mpts}"
        np.testing.assert_array_equal(h_t.mst_ea, h_j.mst_ea, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_eb, h_j.mst_eb, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_w, h_j.mst_w, err_msg=msg)
        np.testing.assert_array_equal(h_t.labels, h_j.labels, err_msg=msg)


def test_kmax128_fit_keeps_the_smaller_fits_msts(fits):
    """The RNG^128 graph holds every smaller mpts' MST and the canonical
    weights do not depend on kmax: mpts 2..16 weight multisets equal a
    kmax = 16 fit's bit for bit."""
    x, _, port = fits["kmax128"]
    small = t_multi.multi_hdbscan(x, 16, device="cpu")
    wide = {h.mpts: h.mst_w for h in port.hierarchies}
    for h in small.hierarchies:
        np.testing.assert_array_equal(np.sort(wide[h.mpts]), np.sort(h.mst_w), err_msg=f"mpts={h.mpts}")


def _raw_d2_tol(x, idx):
    xn = (x.astype(np.float64) ** 2).sum(1)
    return RTOL * (xn[:, None] + xn[idx])


@pytest.mark.parametrize("d,k", [(320, 31), (1536, 31), (8, 135), (8, 256)])
def test_pairwise_topk_plain_matches_the_reference_wide(d, k):
    """The raw lists against the reference's Pallas kernel in interpret
    mode at the sliced widths and the lists past 128: d2 within the matmul
    form's error scale; where the indices differ, the two neighbours are
    a near-tie within that scale (at d = 1536 the scale, 1e-5 of the norms,
    covers more neighbour gaps: 1.7% of the slots here); the refined lists
    equal."""
    x = _embeddings(d, seed=d + k)
    d_j, i_j = j_pairwise_topk(jnp.asarray(x), k, block_q=128, block_k=128, interpret=True)
    d_t, i_t = t_pt.pairwise_topk(torch.from_numpy(x), k)
    d_j, i_j, d_t, i_t = np.asarray(d_j), np.asarray(i_j), d_t.numpy(), i_t.numpy()
    assert d_t.shape == i_t.shape == (N, k)
    assert (np.abs(d_t - d_j) <= _raw_d2_tol(x, i_t)).all()
    assert ((i_t >= 0) & (i_t != np.arange(N)[:, None])).all()
    rows, cols = np.nonzero(i_t != i_j)
    x64 = x.astype(np.float64)
    exact = lambda i: ((x64[rows] - x64[i[rows, cols]]) ** 2).sum(-1)  # noqa: E731
    near = _raw_d2_tol(x, i_t)[rows, cols] + _raw_d2_tol(x, i_j)[rows, cols]
    assert (np.abs(exact(i_t) - exact(i_j)) <= near).all()
    r_j = j_ops._refine_knn(jnp.asarray(x), jnp.asarray(x), jnp.asarray(i_j), k_top=k - 8)
    r_t = t_ops._refine_knn(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(i_t), k_top=k - 8)
    np.testing.assert_array_equal(r_t[1].numpy(), np.asarray(r_j[1]))
    np.testing.assert_array_equal(r_t[0].numpy(), np.asarray(r_j[0]))


@pytest.mark.parametrize("d,k_check", [(1536, 23), (8, 127)])
def test_edge_cascade_plain_matches_the_reference_wide(d, k_check):
    """The plain cascade against the reference's ``edge_cascade`` (its jnp
    twin) at d = 1536 (windows of windows) and at k_check = 127
    (the kmax = 128 list), on kNN edges, duplicate pairs and random pairs:
    verdicts equal, d2 and w2 bit-equal."""
    x = _embeddings(d, seed=3)
    d2, idx = (np.array(v) for v in j_ops.knn(jnp.asarray(x), k_check, backend="jnp"))
    cd2k = d2[:, 3].copy()
    rng = np.random.default_rng(d)
    rows = np.arange(N)
    pairs = np.concatenate([np.stack([np.repeat(rows, 3), idx[:, :3].ravel()], 1),
                            np.stack([rows[:20], rows[N - 20:]], 1), rng.integers(0, N, size=(600, 2))])
    # a power-of-two edge count, as the reference pads a fit's: XLA fuses the
    # adds of a ragged remainder loop (ROADMAP.md §3, reference-side caveats)
    pairs = pairs[rng.permutation(len(pairs))[:2048]]
    ea, eb = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    valid = rng.random(len(pairs)) > 0.05
    J, t = jnp.asarray, torch.from_numpy
    out_j = j_fc.edge_cascade(J(x), J(cd2k), J(idx), J(d2), J(ea), J(eb), J(valid), k_check=k_check,
                              backend="jnp")
    out_t = t_fc.edge_cascade(t(x), t(cd2k), t(idx), t(d2), t(ea), t(eb), t(valid), k_check=k_check,
                              order=t_ops.sum_order(d, "cascade"))
    killed_j, cert_j, d2_j, w2_j = (np.asarray(v) for v in out_j)
    killed_t, cert_t, d2_t, w2_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(killed_t, killed_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    np.testing.assert_array_equal(d2_t[valid], d2_j[valid])
    np.testing.assert_array_equal(w2_t[valid], w2_j[valid])
    assert killed_t.any() and cert_t.any()


@pytest.mark.parametrize("d", [320, 1536])
def test_lune_filter_plain_matches_the_reference_wide(d):
    """The exact lune verdicts at the sliced widths: near and far edges at
    their mrd (lunes with and without points), duplicate pairs, padding."""
    x = _embeddings(d, seed=4)
    d2, _ = j_ops.knn(jnp.asarray(x), 5, backend="jnp")
    cd2 = np.array(d2)[:, -1]
    rng = np.random.default_rng(d)
    ea = rng.integers(0, N, 400).astype(np.int32)
    eb = np.where(rng.random(400) < 0.5, (ea + 1) % N, rng.integers(0, N, 400)).astype(np.int32)
    ea[:10], eb[:10] = np.arange(10), np.arange(N - 20, N - 10)
    w2 = np.maximum(((x[ea] - x[eb]) ** 2).sum(-1), np.maximum(cd2[ea], cd2[eb])).astype(np.float32)
    w2[5::37] = -np.inf
    want = np.asarray(j_ops.lune_nonempty(jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(w2), jnp.asarray(x),
                                          jnp.asarray(cd2), backend="pallas_interpret"))
    t = torch.from_numpy
    got = t_ops.lune_nonempty(t(ea), t(eb), t(w2), t(x), t(cd2), backend="torch").numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
