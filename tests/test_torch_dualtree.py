"""The port's dual-tree tier (fits at n >= ``Plan.dualtree_min_n``) against
the JAX package, on the CPU.

Both packages run ``candidate_method="dualtree"``: the reference with its
``jnp`` backend, the port with ``device="cpu"``.  The host traversals are a
copy, so the candidate arrays are equal; every value that reaches a result
comes from the device side (``_refine_knn``, the canonical edge weights,
Borůvka), so kNN d2 and indices, graph edges, d2 and w2, MST edge ids and
``mst_w`` are bit-equal and labels equal for every mpts.  The port's
dual-tree tier also matches its own WSPD tier, as the reference's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as j_engine
from repro.core import dualtree as j_dualtree
from repro.core import multi as j_multi
from repro.kernels import ops as j_ops

from repro_torch import engine as t_engine
from repro_torch.core import dualtree as t_dualtree
from repro_torch.core import multi as t_multi
from repro_torch.kernels import ops as t_ops

KMAX = 8


# the dataset families of the reference's dual-tree tests
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blobs(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 1, (5, 2)) * 6
    per = [n // 5] * 4 + [n - 4 * (n // 5)]
    return np.concatenate([rng.normal(c[i], 0.7, (per[i], 2)) for i in range(5)]).astype(np.float32)


def _moons(n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h = n // 2
    t1 = np.linspace(0, np.pi, h)
    t2 = np.linspace(0, np.pi, n - h)
    pts = np.concatenate([
        np.stack([np.cos(t1), np.sin(t1)], axis=1),
        np.stack([1 - np.cos(t2), 0.5 - np.sin(t2)], axis=1),
    ])
    return (pts + rng.normal(0, 0.07, pts.shape)).astype(np.float32)


def _aniso(n: int, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shear = np.array([[0.6, -0.6], [-0.4, 0.8]])
    return (rng.normal(0, 1, (n, 2)) @ shear).astype(np.float32)


def _gauss64(n: int = 300, seed: int = 11) -> np.ndarray:
    """d = 64: the refine and the canonical weights sum in windows of 32."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(4, 64))
    return (centers[rng.integers(0, 4, n)] + rng.normal(0, 1.0, (n, 64))).astype(np.float32)


CASES = {
    "blobs-200": lambda: _blobs(200),
    "moons-200": lambda: _moons(200),
    "aniso-200": lambda: _aniso(200),
    "blobs-1000": lambda: _blobs(1000),
    "gauss64-300": _gauss64,
}


def _j_plan(**kw) -> j_engine.Plan:
    return dataclasses.replace(j_engine.resolve_plan("auto", backend="jnp"), **kw)


def _t_plan(**kw) -> t_engine.Plan:
    return dataclasses.replace(t_engine.resolve_plan(device="cpu"), **kw)


@pytest.fixture(scope="module", params=sorted(CASES))
def fits(request):
    """(x, reference dual-tree fit, port dual-tree fit, port ledger)."""
    x = CASES[request.param]()
    ref = j_multi.fit_msts(x, KMAX, plan=_j_plan(candidate_method="dualtree"))
    with t_engine.transfer_ledger() as led:
        port = t_multi.fit_msts(x, KMAX, plan=_t_plan(candidate_method="dualtree"))
    return x, ref, port, t_engine.io.tags(led)


def test_fit_runs_the_dual_tree_tier_with_three_syncs(fits):
    _, ref, port, tags = fits
    assert port.graph.stats["path"] == ref.graph.stats["path"] == "dualtree"
    assert port.graph.stats == ref.graph.stats
    assert tags == ["knn", "graph", "mst"]


def test_knn_and_graph_equal_the_reference(fits):
    _, ref, port, _ = fits
    np.testing.assert_array_equal(port.knn_idx, np.asarray(ref.knn_idx))
    np.testing.assert_array_equal(port.knn_d2, np.asarray(ref.knn_d2))
    np.testing.assert_array_equal(port.graph.edges, ref.graph.edges)
    np.testing.assert_array_equal(port.graph.d2, np.asarray(ref.graph.d2))
    np.testing.assert_array_equal(port.graph.w2_kmax, np.asarray(ref.graph.w2_kmax))


def test_msts_and_labels_equal_the_reference(fits):
    _, ref, port, _ = fits
    for f in ("mst_ea", "mst_eb", "mst_w"):
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(ref, f)), err_msg=f)
    h_j, _ = j_multi.extract_hierarchies(ref)
    h_t, _ = t_multi.extract_hierarchies(port, device="cpu")
    assert len(h_t) == len(h_j) == KMAX - 1
    for a, b in zip(h_t, h_j):
        np.testing.assert_array_equal(a.labels, np.asarray(b.labels), err_msg=f"mpts={a.mpts}")


@pytest.mark.parametrize("name", ["blobs-1000", "moons-200", "gauss64-300"])
def test_host_candidates_equal_the_reference(name):
    x = CASES[name]()
    k_eff = KMAX - 1 + 8
    c_t = t_dualtree.knn_candidates(x, k_eff, leaf_size=4, margin=1e-5)
    c_j = j_dualtree.knn_candidates(x, k_eff, leaf_size=4, margin=1e-5)
    np.testing.assert_array_equal(c_t, c_j)
    d2, idx = j_ops.knn_from_candidates(jnp.asarray(x), c_j, k_top=KMAX - 1)
    d2, idx = np.asarray(d2), np.asarray(idx)
    e_t, s_t = t_dualtree.candidate_edges(x, d2, idx, leaf_size=4, margin=1e-5)
    e_j, s_j = j_dualtree.candidate_edges(x, d2, idx, leaf_size=4, margin=1e-5)
    np.testing.assert_array_equal(e_t, e_j)
    assert s_t == s_j


def test_knn_from_candidates_matches_the_reference():
    x = _blobs(400)
    cand = j_dualtree.knn_candidates(x, 15, leaf_size=4, margin=1e-5)
    d2_j, i_j = j_ops.knn_from_candidates(jnp.asarray(x), cand, k_top=7)
    d2_t, i_t = t_ops.knn_from_candidates(torch.from_numpy(x), cand, k_top=7)
    assert i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))
    with pytest.raises(ValueError, match="columns < k_top"):
        t_ops.knn_from_candidates(torch.from_numpy(x), cand[:, :5], k_top=7)


@pytest.mark.parametrize("name", ["blobs-1000", "moons-200", "aniso-200"])
def test_dual_tree_tier_matches_the_wspd_tier(name):
    """The cross-tier oracle of the reference: both tiers' kNN bit-equal,
    MST weight multisets bit-equal, labels equal for every mpts."""
    x = CASES[name]()
    wspd = t_multi.fit_msts(x, KMAX, plan=_t_plan(candidate_method="wspd"))
    dt = t_multi.fit_msts(x, KMAX, plan=_t_plan(candidate_method="dualtree"))
    assert wspd.graph.stats.get("path") != "dualtree" and dt.graph.stats["path"] == "dualtree"
    np.testing.assert_array_equal(dt.knn_idx, wspd.knn_idx)
    np.testing.assert_array_equal(dt.knn_d2, wspd.knn_d2)
    np.testing.assert_array_equal(np.sort(dt.mst_w, axis=1), np.sort(wspd.mst_w, axis=1))
    for a, b in zip(t_multi.extract_hierarchies(dt, device="cpu")[0],
                    t_multi.extract_hierarchies(wspd, device="cpu")[0]):
        np.testing.assert_array_equal(a.labels, b.labels, err_msg=f"mpts={a.mpts}")


def test_auto_tier_switches_at_a_lowered_threshold():
    x = _blobs(300)
    plan = _t_plan()
    assert not plan.use_dualtree(plan.dualtree_min_n - 1) and plan.use_dualtree(plan.dualtree_min_n)
    m_wspd = t_multi.fit_msts(x, KMAX, plan=plan)
    m_auto = t_multi.fit_msts(x, KMAX, plan=dataclasses.replace(plan, dualtree_min_n=100))
    assert m_wspd.graph.stats.get("path") != "dualtree"
    assert m_auto.graph.stats["path"] == "dualtree"
    np.testing.assert_array_equal(np.sort(m_wspd.mst_w, axis=1), np.sort(m_auto.mst_w, axis=1))
    with pytest.raises(ValueError, match="candidate_method"):
        dataclasses.replace(plan, candidate_method="typo").use_dualtree(100)


@pytest.mark.parametrize("variant", ["rng", "rng_ss"])
def test_variant_filters_nothing_on_the_dual_tree_tier(variant):
    """The tier builds kNN ∪ S, not an RNG: every variant gives the same
    graph, as in the reference, and the exact scan does not run."""
    x = _blobs(300)
    plan = _t_plan(candidate_method="dualtree")
    star = t_multi.fit_msts(x, KMAX, plan=plan)
    with t_engine.transfer_ledger() as led:
        other = t_multi.fit_msts(x, KMAX, variant=variant, plan=plan)
    assert t_engine.io.tags(led) == ["knn", "graph", "mst"]
    np.testing.assert_array_equal(other.graph.edges, star.graph.edges)
    np.testing.assert_array_equal(other.mst_w, star.mst_w)
    ref = j_multi.fit_msts(x, KMAX, variant=variant, plan=_j_plan(candidate_method="dualtree"))
    np.testing.assert_array_equal(other.graph.edges, ref.graph.edges)


def test_knn_exact_on_duplicate_ties():
    """On duplicate-heavy data the dual-tree kNN is the exact float32
    (d2, idx) top-k, ties broken by index, as the reference's is."""
    rng = np.random.default_rng(0)
    x = np.stack([np.sort(rng.choice(np.linspace(0, 10, 80), 500)), np.zeros(500)], axis=1).astype(np.float32)
    k_top = 4
    plan = _t_plan(candidate_method="dualtree")
    d2_t, idx_t = plan.knn(torch.from_numpy(x), k_top)
    d2_j, idx_j = _j_plan(candidate_method="dualtree").knn(jnp.asarray(x), k_top)
    n = len(x)
    diff = x[:, None, :] - x[None, :, :]
    d2 = (diff * diff).sum(-1).astype(np.float32)
    np.fill_diagonal(d2, np.inf)
    order = np.lexsort((np.broadcast_to(np.arange(n), (n, n)), d2), axis=1)[:, :k_top]
    np.testing.assert_array_equal(idx_t.numpy(), order)
    np.testing.assert_array_equal(d2_t.numpy(), np.take_along_axis(d2, order, axis=1))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))


def test_plan_knn_takes_a_host_view_without_a_sync():
    x = _blobs(250)
    plan = _t_plan(candidate_method="dualtree")
    with t_engine.transfer_ledger() as led:
        d2_a, i_a = plan.knn(torch.from_numpy(x), 5, x_host=x)
    assert led == []
    with t_engine.transfer_ledger() as led:
        d2_b, i_b = plan.knn(torch.from_numpy(x), 5)
    assert t_engine.io.tags(led) == ["input"]
    np.testing.assert_array_equal(i_a.numpy(), i_b.numpy())
    np.testing.assert_array_equal(d2_a.numpy(), d2_b.numpy())
