"""The port's exact variant (``variant="rng"``) against the JAX package, on
the CPU.

The ``lune_filter`` kernel's plain version against the reference's
``lune_nonempty`` (its ``jnp`` twin and its Pallas kernel in interpret
mode): verdicts equal.  Whole exact fits on the fused path (the reference's
``jnp`` backend, the port's ``device="cpu"``) and on the slot path (the
duplicate-heavy input's tie overflow, and ``backend="ref"`` on both
sides): graph edges, MST edge ids, labels for every mpts and the filter
counts equal, MST weights bit-equal.  The paper's containment theorems on
the port's own graphs, and exact-fit artifacts across the packages.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import engine as j_engine
from repro.core import mrd as j_mrd
from repro.core import multi as j_multi
from repro.core import rng as j_rng
from repro.kernels import ops as j_ops

from repro_torch import api as t_api
from repro_torch import engine as t_engine
from repro_torch.core import mrd as t_mrd
from repro_torch.core import multi as t_multi
from repro_torch.core import rng as t_rng
from repro_torch.kernels import ops as t_ops

# the package binds the name to the kernel function, as the reference's does
t_lf = importlib.import_module("repro_torch.kernels.lune_filter")

KMAX = 16
EXACT_TAGS = ["knn", "candidate_count", "stage1_count", "graph", "lune_exact", "mst"]
STATS = ("m_candidates", "m_removed_knn", "m_certified", "m_unresolved", "m_removed_exact", "m_edges")


def _dup_heavy():
    base = np.random.default_rng(7).normal(size=(40, 2)).astype(np.float32)
    return np.repeat(base, 8, axis=0)


def _lune_case(d: int, seed: int):
    """Clustered points with exact duplicates, edges between near and far
    pairs weighted at their mrd (so some lunes hold points and some do
    not), an edge from a point to its own duplicate, and padded edges
    (w2 = -inf, the reference's padding)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(4, d))
    x = (centers[rng.integers(0, 4, 150)] + rng.normal(0, 0.7, size=(150, d))).astype(np.float32)
    x = np.concatenate([x, x[:30]])                       # 30 exact duplicates
    n = len(x)
    cd2 = np.sort(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1), axis=1)[:, 5].astype(np.float32)
    ea = rng.integers(0, n, 400).astype(np.int32)
    eb = rng.integers(0, n, 400).astype(np.int32)
    ea[:3], eb[:3] = [0, 1, 2], [150, 151, 152]           # a point and its duplicate
    d2 = ((x[ea] - x[eb]) ** 2).sum(-1)
    w2 = np.maximum(d2, np.maximum(cd2[ea], cd2[eb])).astype(np.float32)
    w2[5::37] = -np.inf
    return x, cd2, ea, eb, w2


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("d", [2, 8, 16])
def test_lune_filter_plain_matches_reference(d, backend):
    x, cd2, ea, eb, w2 = _lune_case(d, seed=d)
    want = np.asarray(j_ops.lune_nonempty(
        jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(w2), jnp.asarray(x), jnp.asarray(cd2),
        backend=backend,
    ))
    t = torch.from_numpy
    got = t_ops.lune_nonempty(t(ea), t(eb), t(w2), t(x), t(cd2), backend="torch").numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    assert not got[np.isneginf(w2)].any()


def test_lune_filter_ref_backend_and_chunking_agree():
    x, cd2, ea, eb, w2 = _lune_case(8, seed=11)
    t = torch.from_numpy
    plain = t_ops.lune_nonempty(t(ea), t(eb), t(w2), t(x), t(cd2), backend="torch")
    oracle = t_ops.lune_nonempty(t(ea), t(eb), t(w2), t(x), t(cd2), backend="ref")
    xe, ce = t(x)[t(ea).long()], t(cd2)[t(ea).long()]
    xb, cb = t(x)[t(eb).long()], t(cd2)[t(eb).long()]
    chunked = t_lf.lune_filter_plain(xe, xb, ce, cb, t(ea), t(eb), t(w2), t(x), t(cd2), chunk=7)
    np.testing.assert_array_equal(plain.numpy(), oracle.numpy())
    np.testing.assert_array_equal(chunked.numpy(), plain.numpy())


def test_lune_filter_excludes_endpoints_by_index_only():
    """With w2 above the edge's own weight the endpoints would lie inside;
    they never count, while a duplicate of an endpoint under another index
    does, in the port as in the reference."""
    x = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0]], np.float32)
    cd2 = np.zeros(3, np.float32)
    ea, eb, w2 = np.array([0], np.int32), np.array([1], np.int32), np.array([5.0], np.float32)
    t = torch.from_numpy
    for n_pts, want in ((2, False), (3, True)):
        got = t_ops.lune_nonempty(t(ea), t(eb), t(w2), t(x[:n_pts]), t(cd2[:n_pts]), backend="torch")
        ref = j_ops.lune_nonempty(
            jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(w2), jnp.asarray(x[:n_pts]),
            jnp.asarray(cd2[:n_pts]), backend="jnp",
        )
        assert bool(got[0]) == bool(ref[0]) == want, n_pts


def test_lune_filter_takes_the_plain_version_only_for_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(t_lf, "lune_filter_plain", boom)
    f = torch.empty((5, 3), device="meta")
    v = torch.empty((5,), device="meta")
    i = torch.empty((5,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_lf.lune_filter(f, f, v, v, i, i, v, f, v)
    with pytest.raises(ValueError, match=r"w2 must be \(5,\)"):
        t_lf.lune_filter(f, f, v, v, i, i, v[:4], f, v)
    # one warp per edge: a block holds at most 32 edges, checked before launch
    with pytest.raises(ValueError, match="1 <= block_e <= 32"):
        t_lf._launch(f, f, v, v, i, i, v, f, v, block_e=256, block_c=512)


@pytest.fixture(scope="module")
def exact_fits(blobs, gauss16d):
    """Per case: (x, reference result, reference tags, port result, port tags)."""
    out = {}
    for name, x, j_backend, t_backend in (
        ("blobs", blobs[0], "jnp", None),
        ("gauss16d", gauss16d, "jnp", None),
        ("dup", _dup_heavy(), "jnp", None),
        ("blobs-slot", blobs[0], "ref", "ref"),
        ("gauss16d-slot", gauss16d, "ref", "ref"),
    ):
        with j_engine.transfer_ledger() as lj:
            ref = j_multi.multi_hdbscan(x, KMAX, variant="rng", backend=j_backend)
        plan = t_engine.resolve_plan(device="cpu", backend=t_backend)
        with t_engine.transfer_ledger() as lt:
            port = t_multi.multi_hdbscan(x, KMAX, variant="rng", plan=plan)
        out[name] = (x, ref, j_engine.io.tags(lj), port, t_engine.io.tags(lt))
    return out


CASES = ["blobs", "gauss16d", "dup", "blobs-slot", "gauss16d-slot"]


@pytest.mark.parametrize("name", CASES)
def test_exact_graph_equals_reference(exact_fits, name):
    _, ref, _, port, _ = exact_fits[name]
    assert port.graph.variant == ref.graph.variant == "rng"
    assert port.graph.stats.get("path") == ref.graph.stats.get("path")
    np.testing.assert_array_equal(port.graph.edges, ref.graph.edges)
    np.testing.assert_array_equal(port.graph.d2, ref.graph.d2)
    np.testing.assert_array_equal(port.graph.w2_kmax, ref.graph.w2_kmax)
    for key in STATS:
        assert port.graph.stats.get(key) == ref.graph.stats.get(key), key
    assert port.graph.stats["m_unresolved"] > 0


@pytest.mark.parametrize("name", CASES)
def test_exact_msts_and_labels_equal_for_every_mpts(exact_fits, name):
    _, ref, _, port, _ = exact_fits[name]
    for h_j, h_t in zip(ref.hierarchies, port.hierarchies):
        msg = f"{name} mpts={h_j.mpts}"
        np.testing.assert_array_equal(h_t.mst_ea, h_j.mst_ea, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_eb, h_j.mst_eb, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_w, h_j.mst_w, err_msg=msg)
        np.testing.assert_array_equal(h_t.labels, h_j.labels, err_msg=msg)


@pytest.mark.parametrize("name", ["blobs", "gauss16d"])
def test_exact_pass_is_one_ledgered_sync(exact_fits, name):
    _, _, tags_j, _, tags_t = exact_fits[name]
    assert tags_t == tags_j == EXACT_TAGS + ["linkage"]


@pytest.mark.parametrize("name", ["blobs", "gauss16d", "dup"])
def test_exact_graph_is_inside_rng_star_and_holds_every_mst(exact_fits, name):
    """exact ⊆ RNG* (the exact pass only removes), and the exact RNG holds
    every per-mpts MST (Cor. 1): the same weight multisets as the RNG* fit's,
    and every MST edge is a graph edge."""
    x, _, _, port, _ = exact_fits[name]
    star = t_multi.multi_hdbscan(x, KMAX, device="cpu")
    exact = set(map(tuple, port.graph.edges.tolist()))
    assert exact <= set(map(tuple, star.graph.edges.tolist()))
    assert len(exact) == star.graph.stats["m_edges"] - port.graph.stats["m_removed_exact"]
    for h_s, h_e in zip(star.hierarchies, port.hierarchies):
        np.testing.assert_array_equal(np.sort(h_e.mst_w), np.sort(h_s.mst_w), err_msg=f"mpts={h_e.mpts}")
        pairs = set(zip(np.minimum(h_e.mst_ea, h_e.mst_eb).tolist(), np.maximum(h_e.mst_ea, h_e.mst_eb).tolist()))
        assert pairs <= exact


@pytest.fixture(scope="module")
def exact_models(blobs):
    x = blobs[0]
    return (
        j_api.FittedModel.fit(x, kmax=KMAX, variant="rng", backend="jnp"),
        t_api.FittedModel.fit(x, kmax=KMAX, variant="rng", device="cpu"),
    )


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
def test_exact_artifact_cross_loads(exact_models, tmp_path, direction):
    model_j, model_t = exact_models
    assert model_j.config_hash == model_t.config_hash
    if direction == "reference-to-port":
        loaded = t_api.FittedModel.load(model_j.save(str(tmp_path / "ref.npz")), device="cpu")
    else:
        loaded = j_api.FittedModel.load(model_t.save(str(tmp_path / "port.npz")), backend="jnp")
    assert loaded.config["variant"] == "rng"
    assert loaded.graph.stats == model_j.graph.stats
    np.testing.assert_array_equal(loaded.graph.edges, model_j.graph.edges)
    for mpts in model_j.mpts_values:
        np.testing.assert_array_equal(loaded.select(mpts).labels, model_j.select(mpts).labels)
        np.testing.assert_array_equal(loaded.mst(mpts)[2], model_j.mst(mpts)[2])


def test_estimator_accepts_the_exact_variant(blobs):
    x = blobs[0]
    est_t = t_api.MultiHDBSCAN(kmax=KMAX, variant="rng", device="cpu").fit(x)
    est_j = j_api.MultiHDBSCAN(kmax=KMAX, variant="rng", backend="jnp").fit(x)
    assert est_t.graph_.variant == "rng"
    assert est_t.n_graph_edges_ == est_j.n_graph_edges_
    for c_j, c_t in zip(est_j.select_all(), est_t.select_all()):
        np.testing.assert_array_equal(c_t.labels, c_j.labels)
    with pytest.raises(ValueError, match="variant"):
        t_api.MultiHDBSCAN(kmax=4, variant="exact", device="cpu").fit(x)


@pytest.mark.parametrize("variant", ["rng_star", "rng"])
def test_filter_edges_matches_reference(blobs, variant):
    """The host-edge-list wrapper: kNN pairs and random pairs through the
    cascade (and the exact scan), kept edges and counts as the reference's."""
    x = blobs[0]
    d2_j, idx_j = j_ops.knn(jnp.asarray(x), KMAX - 1, backend="jnp")
    d2_t, idx_t = t_ops.knn(torch.from_numpy(x), KMAX - 1, backend="torch")
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    rows = np.repeat(np.arange(len(x)), KMAX - 1)
    pairs = np.concatenate([
        np.stack([rows, np.asarray(idx_j).ravel()], 1),               # kNN edges: kept
        np.random.default_rng(0).integers(0, len(x), size=(600, 2)),  # mostly removed
    ])
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    edges = np.unique(np.sort(pairs, axis=1), axis=0)
    kept_j, stats_j = j_rng.filter_edges(
        jnp.asarray(x), j_mrd.core_distances2(d2_j), idx_j, d2_j, edges, variant,
        plan=j_engine.resolve_plan(backend="jnp"),
    )
    kept_t, stats_t = t_rng.filter_edges(
        torch.from_numpy(x), t_mrd.core_distances2(d2_t), idx_t, d2_t, edges, variant,
        plan=t_engine.resolve_plan(device="cpu"),
    )
    np.testing.assert_array_equal(kept_t, kept_j)
    assert stats_t == stats_j
    assert 0 < len(kept_t) < len(edges)


def _gauss(d: int, per_cluster: int):
    rng = np.random.default_rng(d)
    centers = rng.uniform(-6, 6, size=(5, d))
    return np.concatenate([rng.normal(c, 1.0, size=(per_cluster, d)) for c in centers]).astype(np.float32)


def _wide_exact_fit_matches_reference(x, kmax):
    ref = j_multi.multi_hdbscan(x, kmax, variant="rng", backend="jnp")
    port = t_multi.multi_hdbscan(x, kmax, variant="rng", device="cpu")
    assert port.graph.stats.get("path") == ref.graph.stats.get("path") == "fused"
    np.testing.assert_array_equal(port.graph.edges, ref.graph.edges)
    for key in STATS:
        assert port.graph.stats[key] == ref.graph.stats[key], key
    assert port.graph.stats["m_unresolved"] > 0
    np.testing.assert_array_equal(port.knn_idx, ref.knn_idx)
    np.testing.assert_array_equal(port.cd2, ref.cd2)
    np.testing.assert_array_equal(port.graph.d2, ref.graph.d2)
    np.testing.assert_array_equal(port.graph.w2_kmax, ref.graph.w2_kmax)
    assert port.mpts_values == ref.mpts_values == list(range(2, kmax + 1))
    for h_j, h_t in zip(ref.hierarchies, port.hierarchies):
        msg = f"d={x.shape[1]} mpts={h_j.mpts}"
        np.testing.assert_array_equal(h_t.mst_ea, h_j.mst_ea, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_eb, h_j.mst_eb, err_msg=msg)
        np.testing.assert_array_equal(h_t.labels, h_j.labels, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_w, h_j.mst_w, err_msg=msg)


def test_d64_exact_fit_matches_reference():
    """d = 64, where XLA sums every row of squares in windows of 32
    (``ops.sum_order``).  Everything integer is equal: graph edges, the
    filter counts, MST edge ids and labels for every mpts; the core
    distances, the graph's d2 and w2 and the MST weights bit for bit."""
    _wide_exact_fit_matches_reference(_gauss(64, 120), 8)


def test_d100_exact_fit_matches_reference():
    """d = 100: four windows of 32, the row padded 14 + 14."""
    _wide_exact_fit_matches_reference(_gauss(100, 120), 8)
