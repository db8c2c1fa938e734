"""The port's out-of-sample prediction and DBCV against the JAX package, on
the CPU.

Both packages predict from the same fitted state: the reference fits with
its ``jnp`` backend, and the port loads that fit's artifact
(``device="cpu"``), so any difference is the prediction path's own.
Integers (neighbour indices, attachment neighbours, labels, exemplars) are
equal.  Lambdas agree to ``LAMBDA_ULPS`` float32 ulps and probabilities to
two ulps relative: XLA compiles the reference's ``1 / sqrt`` on the CPU to
an ``rsqrt`` whose LLVM IR is the CPU's approximate reciprocal square root
(``llvm.x86.avx.rsqrt.ps.256``) refined by two Newton steps, so its bits
rest on the estimate that instruction gives, which differs between CPU
models; the port rounds a float64 ``1 / sqrt`` once.  On these fixtures
about one lambda in seven differs, by one ulp.  The DBCV profile is equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as j_api
from repro import engine as j_engine
from repro.core import predict as j_predict
from repro.kernels import ops as j_ops

from repro_torch import api as t_api
from repro_torch import engine as t_engine
from repro_torch.core import predict as t_predict
from repro_torch.kernels import ops as t_ops

KMAX = 16
RTOL = 1e-5
# largest distance measured over these fixtures and the serving tests' ones
LAMBDA_ULPS = 1
PROB_RTOL = 2.0**-22


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ulp_distance(a, b) -> int:
    """Largest distance in float32 ulps between two arrays of float32
    values (non-negative or inf, as lambdas are)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _queries(x, seed: int = 5):
    """Points near the fitted ones, uniform noise over the bounding box, a
    handful of exact copies of fitted points and one far outlier."""
    rng = np.random.default_rng(seed)
    lo, hi = x.min(0), x.max(0)
    q = np.concatenate([
        x[rng.integers(0, len(x), 150)] + rng.normal(0, 0.1, size=(150, x.shape[1])),
        rng.uniform(lo - 1, hi + 1, size=(80, x.shape[1])),
        x[:10],
        np.full((1, x.shape[1]), 250.0),
    ])
    return q.astype(np.float32)


@pytest.fixture(scope="module", params=["blobs", "gauss16d"])
def models(request, blobs, gauss16d, tmp_path_factory):
    """(x, reference model, port model loaded from the reference's artifact)."""
    x = blobs[0] if request.param == "blobs" else gauss16d
    model_j = j_api.FittedModel.fit(x, kmax=KMAX, backend="jnp")
    path = model_j.save(str(tmp_path_factory.mktemp("predict") / "ref.npz"))
    return x, model_j, t_api.FittedModel.load(path, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_query_knn_matches_reference(models, backend):
    x, _, _ = models
    q = _queries(x)
    j_backend = "jnp" if backend == "torch" else "ref"
    d2_j, i_j = j_ops.query_knn(jnp.asarray(q), jnp.asarray(x), KMAX - 1, backend=j_backend)
    d2_t, i_t = t_ops.query_knn(torch.from_numpy(q), torch.from_numpy(x), KMAX - 1, backend=backend)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))


def test_query_knn_blocks_do_not_change_the_result(models):
    x, _, _ = models
    q = torch.from_numpy(_queries(x))
    whole = t_ops._query_knn_blocked(q, torch.from_numpy(x), k_top=23)
    tiled = t_ops._query_knn_blocked(q, torch.from_numpy(x), k_top=23, block_q=37, block_k=50)
    for a, b in zip(whole, tiled):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_attach_queries_matches_reference(models):
    x, model_j, model_t = models
    q = _queries(x)
    mpts = model_j.mpts_values
    with j_engine.transfer_ledger() as lj:
        lam_j, nbr_j = j_predict.attach_queries(q, x, model_j.msts.cd2, mpts, plan=model_j.plan)
    with t_engine.transfer_ledger() as lt:
        lam_t, nbr_t = t_predict.attach_queries(q, x, model_t.msts.cd2, mpts, plan=model_t.plan)
    assert t_engine.io.tags(lt) == j_engine.io.tags(lj) == ["predict"]
    np.testing.assert_array_equal(nbr_t, nbr_j)
    assert ulp_distance(lam_t, lam_j) <= LAMBDA_ULPS
    assert np.isinf(lam_t).sum() == np.isinf(lam_j).sum()


def test_approximate_predict_matches_reference(models):
    x, model_j, model_t = models
    q = _queries(x)
    res_j, res_t = model_j.approximate_predict(q), model_t.approximate_predict(q)
    assert res_t.mpts_values == res_j.mpts_values == list(range(2, KMAX + 1))
    np.testing.assert_array_equal(res_t.labels, res_j.labels)
    np.testing.assert_array_equal(res_t.neighbors, res_j.neighbors)
    assert ulp_distance(res_t.lambdas, res_j.lambdas) <= LAMBDA_ULPS
    np.testing.assert_allclose(res_t.probabilities, res_j.probabilities, rtol=PROB_RTOL)
    assert (res_t.labels >= 0).any()
    for mpts in (2, 8, KMAX):
        lab_t, prob_t = model_t.approximate_predict(q, mpts=mpts)
        lab_j, prob_j = model_j.approximate_predict(q, mpts=mpts)
        np.testing.assert_array_equal(lab_t, lab_j)
        np.testing.assert_allclose(prob_t, prob_j, rtol=PROB_RTOL)
        np.testing.assert_array_equal(lab_t, res_t.row(mpts)[0])


def test_clustering_probabilities_and_exemplars_match_reference(models):
    _, model_j, model_t = models
    for c_j, c_t in zip(model_j.select_all(), model_t.select_all()):
        np.testing.assert_array_equal(c_t.probabilities, c_j.probabilities)
        assert len(c_t.exemplars) == len(c_j.exemplars) == c_t.n_clusters
        for e_t, e_j in zip(c_t.exemplars, c_j.exemplars):
            np.testing.assert_array_equal(e_t, e_j)


def test_dbcv_profile_matches_reference(models):
    _, model_j, model_t = models
    assert model_t.dbcv_profile() == model_j.dbcv_profile()


def test_walk_table_matches_reference(models):
    _, model_j, model_t = models
    for mpts in (3, 9):
        w_j = j_predict.build_walk_table(model_j.hierarchy(mpts))
        w_t = t_predict.build_walk_table(model_t.hierarchy(mpts))
        for field in ("pt_cluster", "parent", "birth", "sel_label", "max_lam"):
            np.testing.assert_array_equal(getattr(w_t, field), getattr(w_j, field), err_msg=field)
        assert w_t.root == w_j.root


def _xla_rsqrt_newton(x, y0):
    """The reference's lambda as XLA's LLVM IR computes it on the CPU from
    an estimate ``y0`` of 1/sqrt(x): two Newton steps, float32, unfused
    (``y = y + (-0.5 y) ((x y) y - 1)``)."""
    for _ in range(2):
        y0 = (y0 * np.float32(-0.5)) * ((x * y0) * y0 + np.float32(-1.0)) + y0
    return y0


def test_the_reference_rsqrt_sequence_rests_on_its_estimate():
    """Two estimates within the instruction's error bound (1.5 * 2**-12)
    give lambdas that differ in their last bit for some inputs: the
    reference's bits are the CPU model's, which is why the port rounds a
    float64 1/sqrt once and the tests allow LAMBDA_ULPS.  Either way the
    result is within one ulp of the correctly rounded value."""
    x = np.random.default_rng(0).uniform(1e-3, 100.0, 20000).astype(np.float32)
    exact = 1.0 / np.sqrt(x.astype(np.float64))
    lo, hi = ((exact * (1.0 + r)).astype(np.float32) for r in (-3e-4, 3e-4))
    y_lo, y_hi = _xla_rsqrt_newton(x, lo), _xla_rsqrt_newton(x, hi)
    assert (y_lo != y_hi).any()
    # the port's rounding (core.predict._attach), on the same values
    rounded = (1.0 / torch.sqrt(torch.from_numpy(x).double())).float().numpy()
    assert ulp_distance(y_lo, rounded) <= LAMBDA_ULPS and ulp_distance(y_hi, rounded) <= LAMBDA_ULPS


@pytest.fixture(scope="module")
def est(blobs):
    return t_api.MultiHDBSCAN(kmax=KMAX, device="cpu").fit(blobs[0])


def test_far_outlier_is_noise_with_zero_probability(est):
    res = est.approximate_predict(np.array([[250.0, -250.0]], np.float32))
    assert (res.labels == -1).all()
    assert (res.probabilities == 0.0).all()


def test_predict_validation_errors(est, blobs):
    x = blobs[0]
    with pytest.raises(RuntimeError, match="not fitted"):
        t_api.MultiHDBSCAN(kmax=4, device="cpu").approximate_predict(x[:2])
    with pytest.raises(ValueError, match="2 features"):
        est.approximate_predict(np.zeros((3, 5), np.float32))
    with pytest.raises(KeyError, match="not in computed range"):
        est.approximate_predict(x[:2], mpts=99)
    bad = x[:3].copy()
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite.*row 1"):
        est.approximate_predict(bad)


def test_empty_query_batch_returns_empty_result(est):
    res = est.approximate_predict(np.zeros((0, 2), np.float32))
    assert res.labels.shape == (len(est.mpts_values_), 0)
    lab, prob = est.approximate_predict(np.zeros((0, 2), np.float32), mpts=5)
    assert lab.shape == (0,) and prob.shape == (0,)


@pytest.fixture(scope="module")
def est_j(blobs):
    return j_api.MultiHDBSCAN(kmax=KMAX, backend="jnp").fit(blobs[0])


def test_copies_of_fitted_points_keep_their_labels(est, est_j, blobs):
    """A query that duplicates a clustered fitted point gets that point's
    label, with the reference's probability."""
    x = blobs[0]
    labels8 = est.select(8).labels
    idx = np.flatnonzero(labels8 >= 0)[:20]
    lab, prob = est.approximate_predict(x[idx], mpts=8)
    lab_j, prob_j = est_j.approximate_predict(x[idx], mpts=8)
    np.testing.assert_array_equal(lab, labels8[idx])
    np.testing.assert_array_equal(lab, lab_j)
    np.testing.assert_allclose(prob, prob_j, rtol=PROB_RTOL)
    assert ((prob > 0.0) & (prob <= 1.0)).all()


def test_estimator_dbcv_profile_matches_reference(est, est_j):
    assert est.dbcv_profile() == est_j.dbcv_profile()
