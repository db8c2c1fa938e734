"""The port's whole fit against the JAX package, on the CPU.

The reference runs its ``jnp`` backend; the port runs ``device="cpu"``
(the kernels' plain PyTorch versions).  Graph edges, MST edge ids, labels
for every mpts, the certificate count and the ledger's tag sequence must
be equal, and MST weights bit-equal: the port takes every float32 square
root through float64, which rounds it correctly as XLA's does (PyTorch's
vectorised CPU float32 ``sqrt`` is off by one ulp on some inputs), and
sums the cascade's squares in the order XLA compiles the reference's
cascade to at each width.  Fitted state crosses between the packages in
both directions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import engine as j_engine
from repro.core import multi as j_multi

from repro_torch import api as t_api
from repro_torch import engine as t_engine
from repro_torch.core import multi as t_multi

RTOL = 1e-5
KMAX = 16
# kmax per fit where it is not KMAX: kmax = 40 over-selects 47 neighbours,
# past the 32 that the card's top-K list held before it was widened
KMAX_OF = {"blobs-k40": 40}
FUSED_TAGS = ["knn", "candidate_count", "stage1_count", "graph", "mst"]
SLOT_TAGS = ["knn", "candidate_count", "candidate_slots", "candidate_count", "graph", "mst"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dup_heavy():
    base = np.random.default_rng(7).normal(size=(40, 2)).astype(np.float32)
    return np.repeat(base, 8, axis=0)


def _gauss8d():
    """d = 8, the widest unfused cascade order (the smoke fit's width)."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-6, 6, size=(5, 8))
    return np.concatenate([rng.normal(c, 1.0, size=(100, 8)) for c in centers]).astype(np.float32)


@pytest.fixture(scope="module")
def fits(blobs, gauss16d):
    """Per dataset: (x, reference result, reference tags, port result, port tags)."""
    out = {}
    for name, x in (
        ("blobs", blobs[0]), ("gauss16d", gauss16d), ("dup", _dup_heavy()), ("gauss8d", _gauss8d()),
        ("blobs-k40", blobs[0]),
    ):
        kmax = KMAX_OF.get(name, KMAX)
        with j_engine.transfer_ledger() as lj:
            ref = j_multi.multi_hdbscan(x, kmax, backend="jnp")
        with t_engine.transfer_ledger() as lt:
            port = t_multi.multi_hdbscan(x, kmax, device="cpu")
        out[name] = (x, ref, j_engine.io.tags(lj), port, t_engine.io.tags(lt))
    return out


@pytest.mark.parametrize(
    "name,path",
    [("blobs", "fused"), ("gauss16d", "fused"), ("dup", None), ("gauss8d", "fused"), ("blobs-k40", "fused")],
)
def test_graph_edges_equal(fits, name, path):
    _, ref, _, port, _ = fits[name]
    assert port.graph.stats.get("path") == ref.graph.stats.get("path") == path
    np.testing.assert_array_equal(port.graph.edges, ref.graph.edges)
    np.testing.assert_allclose(port.graph.d2, ref.graph.d2, rtol=RTOL)
    np.testing.assert_allclose(port.graph.w2_kmax, ref.graph.w2_kmax, rtol=RTOL)
    for key in ("m_candidates", "n_wspd_pairs", "m_removed_knn", "m_certified", "m_edges"):
        assert port.graph.stats[key] == ref.graph.stats[key], key


@pytest.mark.parametrize("name", ["blobs", "gauss16d", "dup", "gauss8d", "blobs-k40"])
def test_msts_and_labels_equal_for_every_mpts(fits, name):
    _, ref, _, port, _ = fits[name]
    assert port.mpts_values == ref.mpts_values == list(range(2, KMAX_OF.get(name, KMAX) + 1))
    np.testing.assert_array_equal(port.knn_idx, ref.knn_idx)
    np.testing.assert_allclose(port.cd2, ref.cd2, rtol=RTOL)
    for h_j, h_t in zip(ref.hierarchies, port.hierarchies):
        msg = f"{name} mpts={h_j.mpts}"
        np.testing.assert_array_equal(h_t.mst_ea, h_j.mst_ea, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_eb, h_j.mst_eb, err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_w, h_j.mst_w, err_msg=msg)
        np.testing.assert_array_equal(h_t.labels, h_j.labels, err_msg=msg)
        assert h_t.selected == h_j.selected, msg


@pytest.mark.parametrize("name,tags", [("blobs", FUSED_TAGS), ("dup", SLOT_TAGS)])
def test_transfer_ledger_tags_equal(fits, name, tags):
    _, _, tags_j, _, tags_t = fits[name]
    assert tags_t == tags_j == tags + ["linkage"]


def test_reference_pack_extracts_equal_in_port(fits):
    """``repro.core.multi.pack_msts`` output feeds the port's extraction."""
    x = fits["blobs"][0]
    msts_j = j_multi.fit_msts(x, KMAX, backend="jnp")
    arrays, meta = j_multi.pack_msts(msts_j)
    msts_t = t_multi.unpack_msts({k: np.asarray(v) for k, v in arrays.items()}, meta)
    hs_j, _ = j_multi.extract_hierarchies(msts_j)
    hs_t, _ = t_multi.extract_hierarchies(msts_t, device="cpu")
    for h_j, h_t in zip(hs_j, hs_t):
        np.testing.assert_array_equal(h_t.labels, h_j.labels, err_msg=f"mpts={h_j.mpts}")
    # and back: the port's pack is the reference's format
    arrays_t, meta_t = t_multi.pack_msts(msts_t)
    assert arrays_t.keys() == arrays.keys() and meta_t == meta


@pytest.fixture(scope="module")
def models(blobs):
    x = blobs[0]
    return (
        j_api.FittedModel.fit(x, kmax=KMAX, backend="jnp"),
        t_api.FittedModel.fit(x, kmax=KMAX, device="cpu"),
    )


def test_artifact_saved_by_reference_loads_in_port(models, tmp_path):
    model_j, _ = models
    path = model_j.save(str(tmp_path / "ref.npz"))
    loaded = t_api.FittedModel.load(path, device="cpu")
    assert loaded.config_hash == model_j.config_hash
    for mpts in model_j.mpts_values:
        np.testing.assert_array_equal(loaded.select(mpts).labels, model_j.select(mpts).labels)


def test_artifact_saved_by_port_loads_in_reference(models, tmp_path):
    model_j, model_t = models
    path = model_t.save(str(tmp_path / "port.npz"))
    loaded = j_api.FittedModel.load(path, backend="jnp")
    assert loaded.config_hash == model_t.config_hash == model_j.config_hash
    assert loaded.provenance["torch_version"] == torch.__version__
    for mpts in model_t.mpts_values:
        np.testing.assert_array_equal(loaded.select(mpts).labels, model_t.select(mpts).labels)
        np.testing.assert_array_equal(loaded.select(mpts).labels, model_j.select(mpts).labels)


def test_artifact_errors_name_the_problem(models, tmp_path):
    _, model_t = models
    bad = tmp_path / "garbage.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(t_api.ArtifactError, match="not a readable"):
        t_api.FittedModel.load(str(bad), device="cpu")
    path = model_t.save(str(tmp_path / "ok.npz"))
    with pytest.raises(t_api.ArtifactError, match="does not match"):
        t_api.FittedModel.load(path, device="cpu", expect_config_hash="0" * 16)


def test_estimator_surface_matches_reference(blobs):
    x = blobs[0]
    est_j = j_api.MultiHDBSCAN(kmax=KMAX, backend="jnp").fit(x)
    est_t = t_api.MultiHDBSCAN(kmax=KMAX, device="cpu")
    labels = est_t.fit_predict(x, mpts=8)
    np.testing.assert_array_equal(labels, est_j.select(8).labels)
    for row_t, row_j in zip(est_t.mpts_profile(), est_j.mpts_profile()):
        stab = ("max_stability", "total_stability")
        assert {k: v for k, v in row_t.items() if k not in stab} == {
            k: v for k, v in row_j.items() if k not in stab
        }
        np.testing.assert_allclose([row_t[k] for k in stab], [row_j[k] for k in stab], rtol=RTOL)
    for c_j, c_t in zip(est_j.select_all(), est_t.select_all()):
        np.testing.assert_array_equal(c_t.labels, c_j.labels)
        np.testing.assert_allclose(c_t.lambdas, c_j.lambdas, rtol=RTOL)
    ea_t, eb_t, w_t = est_t.mst_for(5)
    ea_j, eb_j, w_j = est_j.mst_for(5)
    np.testing.assert_array_equal(ea_t, ea_j)
    np.testing.assert_array_equal(eb_t, eb_j)
    np.testing.assert_allclose(w_t, w_j, rtol=RTOL)
    assert est_t.n_graph_edges_ == est_j.n_graph_edges_
    assert est_t.timings_.keys() >= {"knn", "rng_build", "mst_range"}
    lab_t, prob_t = est_t.approximate_predict(x[:3], mpts=8)
    lab_j, prob_j = est_j.approximate_predict(x[:3], mpts=8)
    np.testing.assert_array_equal(lab_t, lab_j)
    np.testing.assert_allclose(prob_t, prob_j, rtol=RTOL)
    assert est_t.dbcv_profile() == est_j.dbcv_profile()


def test_estimator_rejects_bad_input():
    est = t_api.MultiHDBSCAN(kmax=4, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        est.fit(np.array([[0.0, 1.0]] * 5 + [[np.nan, 0.0]], np.float32))
    with pytest.raises(ValueError, match="2-d"):
        est.fit(np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="cluster_selection_method"):
        t_api.MultiHDBSCAN(cluster_selection_method="bogus")
    with pytest.raises(RuntimeError, match="not fitted"):
        est.model_


def test_disconnected_graph_raises(blobs, monkeypatch):
    """A graph that cannot span fails loudly instead of feeding partial
    MST rows to extraction, as the reference's ``fit_msts`` does."""
    import dataclasses

    real_build = t_multi.build_rng_graph

    def severed(*args, **kwargs):
        g = real_build(*args, **kwargs)
        cut = g.edges[:, 0] != g.edges[0, 0]  # isolate one point
        return dataclasses.replace(g, edges=g.edges[cut], d2=g.d2[cut], w2_kmax=g.w2_kmax[cut])

    monkeypatch.setattr(t_multi, "build_rng_graph", severed)
    with pytest.raises(RuntimeError, match="MST incomplete"):
        t_multi.fit_msts(blobs[0], 6, device="cpu")
