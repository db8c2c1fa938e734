"""The estimator's legacy surface and the clustering examples of the port,
against the JAX package on the CPU.

  * ``Membership`` and the four deprecated per-level accessors
    (``hierarchy_for``, ``labels_for``, ``membership_for``,
    ``probabilities_for``): each warns with ``FutureWarning`` and answers
    as the reference's does on the pipeline fixtures (labels equal,
    probabilities and lambdas to rtol 1e-5, the tolerance of the MST
    weights); ``max_cached_hierarchies`` is set, bounds the cache and is
    rejected as in the reference; the legacy internals (``_msts``, ``_X``,
    ``_linkage``, ``_hierarchy_cache``, ``_walk_cache``, ``_check_fitted``,
    ``_ensure_linkage``) answer as the reference's.
  * ``examples/*_torch.py`` run with ``--device cpu`` at a small size: each
    builds the reference example's data bit for bit, and its labels equal
    the reference's on that data.
"""

import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro import api as j_api

from repro_torch import api as t_api

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
KMAX = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs (the other
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fitted(blobs):
    x = blobs[0]
    return (j_api.MultiHDBSCAN(kmax=KMAX, backend="jnp").fit(x),
            t_api.MultiHDBSCAN(kmax=KMAX, device="cpu").fit(x))


@pytest.mark.parametrize("name", ["labels_for", "hierarchy_for", "membership_for", "probabilities_for"])
def test_deprecated_accessors_warn_and_answer_as_the_reference(fitted, name):
    est_j, est_t = fitted
    for mpts in (2, 5, KMAX):
        with pytest.warns(FutureWarning, match=name):
            got = getattr(est_t, name)(mpts)
        with pytest.warns(FutureWarning, match=name):
            want = getattr(est_j, name)(mpts)
        if name == "labels_for":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, est_t.model_.select(mpts).labels)
        elif name == "hierarchy_for":
            assert got is est_t.model_.hierarchy(mpts)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.mst_w, want.mst_w)
        elif name == "probabilities_for":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
        else:
            assert isinstance(got, t_api.Membership) and got.mpts == want.mpts == mpts
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_allclose(got.probabilities, want.probabilities, rtol=RTOL, atol=0.0)
            np.testing.assert_allclose(got.lambdas, want.lambdas, rtol=RTOL, atol=0.0)


def test_membership_fields_equal_the_reference():
    import dataclasses

    fields = [(f.name, f.type) for f in dataclasses.fields(t_api.Membership)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(j_api.Membership)]


def test_the_new_surface_is_warning_free(fitted, blobs):
    _, est = fitted
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        est.model_.select(KMAX).labels
        est.select(KMAX).probabilities
        est.approximate_predict(blobs[0][:3], mpts=KMAX)


def test_max_cached_hierarchies_is_set_and_rejected_as_in_the_reference(blobs):
    x = blobs[0]
    for api, kw in ((j_api, {"backend": "jnp"}), (t_api, {"device": "cpu"})):
        with pytest.raises(ValueError, match="max_cached_hierarchies"):
            api.MultiHDBSCAN(kmax=4, max_cached_hierarchies=0, **kw)
        est = api.MultiHDBSCAN(kmax=KMAX, max_cached_hierarchies=2, **kw)
        assert est.max_cached_hierarchies == 2
        with pytest.raises(ValueError, match="max_cached_hierarchies"):
            est.max_cached_hierarchies = 0
        est.fit(x)
        assert est.model_.max_cached_hierarchies == 2
        with pytest.warns(FutureWarning):
            first = est.labels_for(4).copy()
            est.labels_for(5)
            est.labels_for(6)  # evicts mpts=4
        assert list(est._hierarchy_cache) == [5, 6]
        with pytest.warns(FutureWarning):
            np.testing.assert_array_equal(est.labels_for(4), first)  # re-extracts
        assert list(est._hierarchy_cache) == [6, 4]
        est.max_cached_hierarchies = None  # reaches the fitted model
        assert est.max_cached_hierarchies is None and est.model_.max_cached_hierarchies is None
        for m in (2, 3, 7):
            est.select(m)
        assert list(est._hierarchy_cache) == [6, 4, 2, 3, 7]


def test_legacy_internals_answer_as_the_reference(blobs):
    x = blobs[0]
    ests = {}
    for name, api, kw in (("j", j_api, {"backend": "jnp"}), ("t", t_api, {"device": "cpu"})):
        est = api.MultiHDBSCAN(kmax=KMAX, **kw)
        assert est._msts is None and est._X is None and est._linkage is None
        assert not est._hierarchy_cache and est._walk_cache == {}
        with pytest.raises(RuntimeError, match="not fitted"):
            est._check_fitted()
        with pytest.raises(RuntimeError, match="not fitted"):
            est.labels_for(2)
        est.fit(x)
        assert est._linkage is None and est._msts is est._check_fitted() is est.model_.msts
        np.testing.assert_array_equal(est._X, x)
        link = est._ensure_linkage()
        assert est._linkage is link
        est.approximate_predict(x[:5], mpts=4)
        assert list(est._walk_cache) == [4]
        ests[name] = est
    np.testing.assert_array_equal(ests["t"]._msts.mst_ea, ests["j"]._msts.mst_ea)
    for key in ("left", "right", "size"):
        np.testing.assert_array_equal(getattr(ests["t"]._linkage, key), np.asarray(getattr(ests["j"]._linkage, key)))


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _ref_data(mod, attr: str, monkeypatch) -> np.ndarray:
    """The data the reference example ``mod`` builds: its ``attr`` (the
    estimator class or ``FittedModel``) is replaced by one that records the
    points and stops the example there."""
    seen = {}

    def record(x, *a, **k):
        seen["x"] = np.array(x)
        raise _Stop

    class Spy:  # ``Spy(...).fit(x)`` and ``Spy.fit(x)`` both record
        fit = staticmethod(record)

        def __init__(self, *a, **k):
            pass

    monkeypatch.setattr(mod, attr, Spy)
    with pytest.raises(_Stop):
        mod.main()
    return seen["x"]


def _ref_labels(x, kmax: int) -> dict:
    est = j_api.MultiHDBSCAN(kmax=kmax, backend="jnp").fit(x)
    return {v.mpts: np.asarray(v.labels) for v in est.select_all()}


def test_quickstart_example(monkeypatch, capsys):
    port = _load("quickstart_torch")
    np.testing.assert_array_equal(port.make_data(), _ref_data(_load("quickstart"), "MultiHDBSCAN", monkeypatch))
    out = port.main(["--device", "cpu", "--n-per-center", "60", "--kmax", str(KMAX)])
    assert "hierarchies are exact" in capsys.readouterr().out
    np.testing.assert_array_equal(out["x"], port.make_data(60))
    want = _ref_labels(out["x"], KMAX)
    assert out["labels"].keys() == want.keys() == set(range(2, KMAX + 1))
    for mpts, labels in want.items():
        np.testing.assert_array_equal(out["labels"][mpts], labels, err_msg=f"mpts={mpts}")


def test_multi_density_explore_example(monkeypatch, capsys):
    """The port's table equals the reference example's line for line at
    n = 600, kmax = 10 (the fit-time line aside), and its labels the
    reference estimator's on the reference example's own points."""
    ref_mod = _load("multi_density_explore")
    seen = {}
    real = ref_mod.MultiHDBSCAN

    class Recording(real):
        def fit(self, x):
            seen["est"] = self
            return super().fit(x)

    monkeypatch.setattr(ref_mod, "MultiHDBSCAN", Recording)
    ref_mod.explore(600, 10)
    want_out = capsys.readouterr().out.splitlines()[1:]
    out = _load("multi_density_explore_torch").explore(600, 10, device="cpu")
    got_out = capsys.readouterr().out.splitlines()[1:]
    assert got_out == want_out
    est_j = seen["est"]
    np.testing.assert_array_equal(out["x"], np.asarray(est_j.model_.X))
    for v in est_j.select_all():
        np.testing.assert_array_equal(out["labels"][v.mpts], v.labels, err_msg=f"mpts={v.mpts}")
    with pytest.raises(SystemExit):
        _load("multi_density_explore_torch").main(["--sweep"])


def test_serve_clusters_example(monkeypatch):
    """The 128 concurrent queries' labels equal the reference model's
    prediction at each query's mpts, and the per-policy cluster counts
    its selections'."""
    port = _load("serve_clusters_torch")
    x_ref = _ref_data(_load("serve_clusters"), "FittedModel", monkeypatch)
    out = port.main(["--device", "cpu"])
    np.testing.assert_array_equal(out["x"], x_ref)
    model = j_api.FittedModel.fit(out["x"], kmax=16, backend="jnp")
    for mpts in (4, 8, 12, 16):
        rows = [i for i in range(128) if 4 + 4 * (i % 4) == mpts]
        labels, _ = model.approximate_predict(out["queries"][rows], mpts=mpts)
        np.testing.assert_array_equal([out["labels"][i] for i in rows], labels, err_msg=f"mpts={mpts}")
    policies = {"eom": None, "leaf": j_api.SelectionPolicy(method="leaf"),
                "leaf+eps": j_api.SelectionPolicy(method="leaf", epsilon=0.8)}
    for key, pol in policies.items():
        assert out["n_clusters"][key] == int(np.asarray(model.select(8, pol).labels).max() + 1), key


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("quickstart_torch").main(["--n-per-center", "20", "--kmax", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("multi_density_explore_torch").main(["--n", "200", "--kmax", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("serve_clusters_torch").main([])
