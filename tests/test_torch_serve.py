"""The port's clustering serve engine, on the CPU: the reference's serving
tests on a port model (``device="cpu"``), rider independence inside a
micro-batch, and an artifact of the JAX package served by both engines.

Labels, attachment neighbours and probabilities of the port's own engine
equal its direct predictions bit for bit.  Against the JAX engine, labels
and neighbours are equal and lambdas agree to ``LAMBDA_ULPS`` float32 ulps:
XLA computes the reference's ``1 / sqrt`` with the CPU's approximate
reciprocal square root and two Newton steps (``test_torch_predict.py``).
"""

import sys
import threading

import numpy as np
import pytest

from repro import api as j_api
from repro.serve import ClusterServeEngine as JEngine

from repro_torch.api import ArtifactError, MultiHDBSCAN, SelectionPolicy
from repro_torch.serve import ClusterServeEngine

LAMBDA_ULPS = 1  # as in test_torch_predict.py


def ulp_distance(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(41)
    x = np.concatenate([
        rng.normal((0, 0), 0.3, size=(90, 2)),
        rng.normal((4, 0), 0.5, size=(90, 2)),
        rng.normal((2, 4), 0.4, size=(70, 2)),
    ]).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def engine(dataset):
    est = MultiHDBSCAN(kmax=8, device="cpu").fit(dataset)
    eng = ClusterServeEngine(est, max_batch=32, hierarchy_cache_size=3)
    yield eng
    eng.close()


def test_requires_fitted_estimator():
    with pytest.raises(RuntimeError, match="fitted"):
        ClusterServeEngine(MultiHDBSCAN(kmax=4, device="cpu"))


def test_serve_predict_matches_estimator(dataset, engine):
    q = dataset[:9] + 0.02
    direct = engine.estimator.approximate_predict(q, mpts=8)
    lab, prob = engine.predict(q, mpts=8)
    np.testing.assert_array_equal(lab, direct[0])
    np.testing.assert_array_equal(prob, direct[1])

    res = engine.predict(q)  # full range
    direct_all = engine.estimator.approximate_predict(q)
    for f in ("labels", "neighbors", "lambdas", "probabilities"):
        np.testing.assert_array_equal(getattr(res, f), getattr(direct_all, f), err_msg=f)


def test_concurrent_clients_are_microbatched(dataset, engine):
    """Many concurrent single-row clients: every answer correct, and the
    engine fuses them into far fewer device batches than requests."""
    rng = np.random.default_rng(43)
    queries = [(dataset[rng.integers(len(dataset))] + 0.01).astype(np.float32) for _ in range(24)]
    direct = engine.estimator.approximate_predict(np.stack(queries), mpts=6)

    before = engine.stats()
    results: dict[int, tuple] = {}

    def client(i):
        results[i] = engine.predict(queries[i], mpts=6)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    after = engine.stats()

    for i in range(24):
        lab, prob = results[i]
        assert lab[0] == direct[0][i]
        assert prob[0] == direct[1][i]
    n_batches = after["n_batches"] - before["n_batches"]
    assert n_batches < 24, f"no micro-batching: {n_batches} batches for 24 requests"
    assert after["n_queries"] - before["n_queries"] == 24


def test_mixed_mpts_requests_share_one_batch(dataset, engine):
    """Riders asking for different levels still fuse into one device pass."""
    before = engine.stats()
    futs = [engine.submit_predict(dataset[:2] + 0.01, mpts=m) for m in (4, 5, 6, 7)]
    outs = [f.result(timeout=60) for f in futs]
    for m, (lab, _) in zip((4, 5, 6, 7), outs):
        direct = engine.estimator.approximate_predict(dataset[:2] + 0.01, mpts=m)
        np.testing.assert_array_equal(lab, direct[0])
    assert engine.stats()["n_batches"] - before["n_batches"] <= 2


def test_labels_profile_and_selection_override(dataset, engine):
    model = engine.model
    np.testing.assert_array_equal(engine.labels(8), model.select(8).labels)
    leaf = engine.labels(8, cluster_selection_method="leaf")
    assert leaf.max() >= model.select(8).labels.max()  # leaf refines eom
    # the override never disturbs the estimator's own configuration
    np.testing.assert_array_equal(engine.labels(8), model.select(8).labels)

    prof = engine.profile()
    assert [r["mpts"] for r in prof] == engine.estimator.mpts_values_
    assert prof == model.mpts_profile()
    dbcv = engine.dbcv_profile()
    assert all(-1.0 <= r["dbcv"] <= 1.0 for r in dbcv)
    assert dbcv == model.dbcv_profile()
    m = engine.membership(5)
    np.testing.assert_array_equal(m.labels, model.select(5).labels)
    np.testing.assert_array_equal(m.probabilities, model.select(5).probabilities)


def test_hierarchy_cache_is_lru_bounded(dataset, engine):
    for m in engine.estimator.mpts_values_:
        engine.labels(m)
    cache = engine.model._cache
    assert len(cache) <= 3
    # most recently served levels survive
    assert (engine.estimator.mpts_values_[-1], engine.model.default_policy) in cache
    assert engine.estimator.max_cached_hierarchies == 3
    # evicted levels still answer correctly (re-extracted on demand)
    np.testing.assert_array_equal(engine.labels(2), engine.model.select(2).labels)


def test_invalid_requests_fail_alone_at_submit_time(dataset, engine):
    """A malformed request is rejected before enqueueing: it never reaches
    the micro-batcher, where its failure would poison its co-riders."""
    with pytest.raises(KeyError, match="not in computed range"):
        engine.submit_predict(dataset[:1], mpts=99)
    with pytest.raises(ValueError, match="features"):
        engine.submit_predict(np.zeros((1, 7), np.float32), mpts=8)
    bad = dataset[:1].copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        engine.submit_predict(bad, mpts=8)
    # a healthy rider submitted right after still succeeds
    lab, _ = engine.predict(dataset[:1], mpts=8)
    assert lab.shape == (1,)


def test_a_failing_pass_fails_its_riders_and_the_worker_lives_on(dataset):
    est = MultiHDBSCAN(kmax=4, device="cpu").fit(dataset)
    with ClusterServeEngine(est, max_batch=64, max_delay_ms=50.0) as eng:
        real = eng.model.predict_range

        def broken(*args, **kwargs):
            raise RuntimeError("device pass failed")

        eng.model.predict_range = broken
        futs = [eng.submit_predict(dataset[i : i + 2], mpts=4) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device pass failed"):
                f.result(timeout=60)
        eng.model.predict_range = real
        lab, _ = eng.predict(dataset[:3], mpts=4)
        np.testing.assert_array_equal(lab, est.approximate_predict(dataset[:3], mpts=4)[0])


def test_engine_rejects_degenerate_cache_size(dataset):
    est = MultiHDBSCAN(kmax=4, device="cpu").fit(dataset)
    with pytest.raises(ValueError, match="hierarchy_cache_size"):
        ClusterServeEngine(est, hierarchy_cache_size=0)
    with pytest.raises(ValueError, match="max_batch"):
        ClusterServeEngine(est, max_batch=0)


def test_closed_engine_rejects_requests(dataset):
    est = MultiHDBSCAN(kmax=4, device="cpu").fit(dataset)
    eng = ClusterServeEngine(est)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.predict(dataset[:1])


def test_stats_shape(engine):
    s = engine.stats()
    for k in ("n_requests", "n_queries", "n_batches", "p50_ms", "p95_ms", "queries_per_s", "mean_batch"):
        assert k in s
    assert s["p95_ms"] >= s["p50_ms"] >= 0.0
    engine.reset_stats()
    assert engine.stats()["n_requests"] == 0


def test_engine_loads_from_artifact_and_matches_fresh(dataset, engine, tmp_path):
    """``ClusterServeEngine.load`` boots from a saved artifact, with no
    refit, and answers predict/labels exactly as the fitted engine does."""
    path = engine.model.save(str(tmp_path / "served.npz"))
    q = dataset[:7] + 0.03
    with ClusterServeEngine.load(
        path, device="cpu", serve_options={"max_batch": 16, "hierarchy_cache_size": 4}
    ) as loaded:
        assert loaded.estimator is None  # model-only boot, no estimator
        for mpts in (2, 5, 8):
            np.testing.assert_array_equal(loaded.labels(mpts), engine.labels(mpts), err_msg=f"mpts={mpts}")
            lab_l, prob_l = loaded.predict(q, mpts=mpts)
            lab_f, prob_f = engine.predict(q, mpts=mpts)
            np.testing.assert_array_equal(lab_l, lab_f)
            np.testing.assert_array_equal(prob_l, prob_f)
        res_l, res_f = loaded.predict(q), engine.predict(q)  # full range
        np.testing.assert_array_equal(res_l.labels, res_f.labels)
        np.testing.assert_array_equal(res_l.probabilities, res_f.probabilities)


def test_engine_load_pins_expected_config(dataset, engine, tmp_path):
    path = engine.model.save(str(tmp_path / "pinned.npz"))
    with ClusterServeEngine.load(path, device="cpu", expect_config_hash=engine.model.config_hash) as eng:
        assert eng.model.config_hash == engine.model.config_hash
    with pytest.raises(ArtifactError, match="does not match the expected"):
        ClusterServeEngine.load(path, device="cpu", expect_config_hash="f" * 16)


def test_per_request_selection_policy(dataset, engine):
    """A SelectionPolicy rides along per request — predict and labels — and
    never disturbs the engine's default configuration."""
    model = engine.model
    leaf = SelectionPolicy(method="leaf")
    np.testing.assert_array_equal(engine.labels(8, policy=leaf), model.select(8, leaf).labels)
    eps = SelectionPolicy(method="leaf", epsilon=1.0)
    np.testing.assert_array_equal(engine.labels(8, policy=eps), model.select(8, eps).labels)
    with pytest.raises(ValueError, match="not both"):
        engine.labels(8, policy=leaf, cluster_selection_method="eom")

    q = dataset[:5] + 0.02
    lab_leaf, prob_leaf = engine.predict(q, mpts=8, policy=leaf)
    direct = model.approximate_predict(q, mpts=8, policy=leaf)
    np.testing.assert_array_equal(lab_leaf, direct[0])
    np.testing.assert_array_equal(prob_leaf, direct[1])
    # default-policy answers are unchanged afterwards
    np.testing.assert_array_equal(engine.labels(8), model.select(8).labels)
    m = engine.membership(8, policy=leaf)
    np.testing.assert_array_equal(m.labels, model.select(8, leaf).labels)


def test_fit_classmethod_serves_a_fresh_estimator(dataset):
    with ClusterServeEngine.fit(dataset, kmax=6, device="cpu", serve_options={"max_batch": 8}) as eng:
        assert eng.max_batch == 8 and eng.estimator is not None
        np.testing.assert_array_equal(eng.labels(6), eng.estimator.select(6).labels)


def test_counters_and_answers_hold_under_many_clients(dataset):
    """More client threads than cores, with a short switch interval: every
    answer is the direct prediction and the counters lose no update."""
    est = MultiHDBSCAN(kmax=6, device="cpu").fit(dataset)
    direct = est.approximate_predict(dataset[:64] + 0.01, mpts=6)
    n_clients, per_client = 32, 6
    results: dict[tuple[int, int], tuple] = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ClusterServeEngine(est, max_batch=16, max_delay_ms=1.0) as eng:
            def client(c):
                for j in range(per_client):
                    i = (c * per_client + j) % 64
                    results[(c, j)] = (i, eng.predict(dataset[i : i + 1] + 0.01, mpts=6, timeout=120))

            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            stats = eng.stats()
    finally:
        sys.setswitchinterval(old)
    assert len(results) == n_clients * per_client
    for i, (lab, prob) in results.values():
        assert lab[0] == direct[0][i] and prob[0] == direct[1][i]
    assert stats["n_requests"] == stats["n_queries"] == n_clients * per_client
    assert stats["n_batches"] < n_clients * per_client


# -- rider independence ------------------------------------------------------


def test_a_rows_answer_does_not_depend_on_its_co_riders(dataset):
    """The same rows answered alone and inside a 512-row batch: equal labels,
    neighbours, lambdas and probabilities (the over-selecting query kNN
    and the exact refine keep a row's neighbours its own)."""
    est = MultiHDBSCAN(kmax=8, device="cpu").fit(dataset)
    rng = np.random.default_rng(44)
    lo, hi = dataset.min(0), dataset.max(0)
    batch = np.concatenate([
        dataset[rng.integers(0, len(dataset), 256)] + rng.normal(0, 0.2, (256, 2)),
        rng.uniform(lo - 1, hi + 1, (256, 2)),
    ]).astype(np.float32)
    probe = rng.choice(512, 24, replace=False)
    with ClusterServeEngine(est, max_batch=512, max_delay_ms=200.0) as eng:
        futs = [eng.submit_predict(batch[i : i + 64]) for i in range(0, 512, 64)]
        together = [f.result(timeout=60) for f in futs]
        assert eng.stats()["mean_batch"] > 64
        alone = [eng.predict(batch[i]) for i in probe]
    for i, res in zip(probe, alone):
        big = together[i // 64]
        for f in ("labels", "neighbors", "lambdas", "probabilities"):
            np.testing.assert_array_equal(getattr(res, f)[:, 0], getattr(big, f)[:, i % 64], err_msg=f"{f} row {i}")


# -- an artifact of the JAX package, served by both engines --------------------


def test_jax_artifact_serves_like_the_jax_engine(dataset, tmp_path):
    model_j = j_api.FittedModel.fit(dataset, kmax=8, backend="jnp")
    path = model_j.save(str(tmp_path / "jax.npz"))
    rng = np.random.default_rng(45)
    q = np.concatenate([
        dataset[rng.integers(0, len(dataset), 40)] + rng.normal(0, 0.1, (40, 2)),
        rng.uniform(-2, 6, (20, 2)),
    ]).astype(np.float32)
    with JEngine.load(path, serve_options={"max_batch": 64}) as ej, \
            ClusterServeEngine.load(path, device="cpu", serve_options={"max_batch": 64}) as et:
        res_j, res_t = ej.predict(q), et.predict(q)
        np.testing.assert_array_equal(res_t.labels, res_j.labels)
        np.testing.assert_array_equal(res_t.neighbors, res_j.neighbors)
        assert ulp_distance(res_t.lambdas, res_j.lambdas) <= LAMBDA_ULPS
        for mpts in (3, 8):
            np.testing.assert_array_equal(et.labels(mpts), ej.labels(mpts))
            np.testing.assert_array_equal(et.predict(q, mpts=mpts)[0], ej.predict(q, mpts=mpts)[0])
        assert et.profile() == ej.profile()
