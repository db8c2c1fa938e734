"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package, and the fit never carries on on the CPU unless asked to."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as t_api
from repro_torch import engine as t_engine
from repro_torch.core import dualtree as t_dualtree
from repro_torch.kernels import ops as t_ops

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def test_fit_without_a_card_raises_unless_cpu_is_asked_for(monkeypatch, blobs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = blobs[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.MultiHDBSCAN(kmax=4).fit(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.FittedModel.fit(x, kmax=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.resolve_plan()
    est = t_api.MultiHDBSCAN(kmax=4, device="cpu").fit(x)
    assert est.plan_.backend == "torch" and est.plan_.device == "cpu"
    assert np.asarray(est.select(4).labels).shape == (len(x),)


def test_plan_backends_and_later_slices():
    assert t_engine.resolve_plan(device="cpu").backend == "torch"
    assert t_engine.resolve_plan(device="cpu", backend="ref").backend == "ref"
    with pytest.raises(ValueError, match="does not run on"):
        t_engine.resolve_plan(device="cpu", backend="cuda")
    # the reference's rules without a mesh: "mesh" raises, "auto" and
    # "single" run on one device (the rules over meshes: test_torch_dist)
    with pytest.raises(ValueError, match="non-trivial 'data' axis"):
        t_engine.resolve_plan("mesh", device="cpu")
    plan = t_engine.resolve_plan(device="cpu")
    assert not plan.sharded and plan.n_shards == 1 and t_engine.resolve_plan("single", device="cpu") == plan
    # n >= dualtree_min_n selects the dual-tree tier, whose kNN is the host
    # candidate search through the shared refine
    assert plan.use_dualtree(plan.dualtree_min_n) and not plan.use_dualtree(plan.dualtree_min_n - 1)
    pts = torch.from_numpy(np.random.default_rng(1).normal(size=(300, 2)).astype(np.float32))
    forced = dataclasses.replace(plan, candidate_method="dualtree")
    cand = t_dualtree.knn_candidates(pts.numpy(), 3 + plan.knn_refine_slack, leaf_size=plan.dualtree_leaf)
    for got, want in zip(forced.knn(pts, 3), t_ops._refine_knn(pts, pts, torch.from_numpy(cand), k_top=3)):
        assert torch.equal(got, want)
    # the exact lune scan and out-of-sample kNN are in: the plan runs both
    x = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    e = torch.tensor([0], dtype=torch.int32)
    assert plan.lune_nonempty(e, e + 1, torch.tensor([5.0]), x, torch.zeros(3)).tolist() == [True]
    d2, idx = plan.query_knn(torch.tensor([[0.9, 0.0]]), x, 2)
    assert idx.tolist() == [[1, 0]]
    # both tiers give the same kNN, duplicate points included
    dup = torch.cat([pts, pts[:40]])
    for got, want in zip(forced.knn(dup, 5), plan.knn(dup, 5)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="mesh"):
        t_engine.resolve_plan("mesh", device="cpu", axis="model")
    with pytest.raises(ValueError, match="backend='mesh' requires mesh="):
        t_ops.knn(pts, 3, backend="mesh")


def test_the_exact_and_prediction_modules_are_covered():
    assert {"repro_torch.kernels.lune_filter", "repro_torch.core.predict", "repro_torch.core.dbcv"} <= set(MODULES)


def test_the_serving_and_dual_tree_modules_are_covered():
    assert {"repro_torch.core.dualtree", "repro_torch.serve", "repro_torch.serve.engine"} <= set(MODULES)


def test_the_lm_serving_modules_are_covered():
    assert {"repro_torch.serve.lm", "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen2_1_5b", "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.transformer", "repro_torch.train", "repro_torch.train.data"} <= set(MODULES)
    ref_configs = {p.stem for p in (REPO / "src" / "repro" / "configs").glob("*.py")}
    assert {p.stem for p in (PORT / "configs").glob("*.py")} == ref_configs
    # LM training and its launcher are in, and the SSM, recurrent and
    # encoder-decoder families
    assert {"repro_torch.train.step", "repro_torch.train.optim", "repro_torch.train.checkpoint",
            "repro_torch.train.metrics", "repro_torch.launch.train"} <= set(MODULES)
    assert {"repro_torch.models.ssm", "repro_torch.models.griffin"} <= set(MODULES)
    assert "repro_torch.models.encdec" in set(MODULES)
    assert {"repro_torch.dist", "repro_torch.dist.cluster_parallel", "repro_torch.launch.mesh"} <= set(MODULES)
    # the last slice: the sharded train step and the dry runs
    assert {"repro_torch.dist.sharding", "repro_torch.launch.dryrun", "repro_torch.launch.cluster"} <= set(MODULES)


def test_the_baseline_and_linkage_kernel_modules_are_covered():
    assert {"repro_torch.kernels.prim_mst", "repro_torch.kernels.single_linkage"} <= set(MODULES)
    src = PORT / "kernels" / "csrc"
    assert (src / "prim_mst.cu").is_file() and (src / "single_linkage.cu").is_file()
    from repro_torch.kernels import _build

    assert {"prim_mst", "single_linkage"} <= set(_build.KERNEL_SOURCES)
    assert all((src / f"{name}.cu").is_file() for name in _build.KERNEL_SOURCES)


def test_baseline_needs_a_card_unless_cpu_is_asked_for(monkeypatch, blobs):
    from repro_torch.core import hdbscan_baseline

    x = blobs[0][:100]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hdbscan_baseline(x, [3, 5])
    res, timings = hdbscan_baseline(x, [3, 5], device="cpu")
    assert [h.mpts for h in res] == [3, 5] and set(timings) == {"knn", "mst", "hierarchy", "total"}


# Names of the reference's public surface the port leaves out, per package:
# only ``engine.cached_program`` (XLA's program cache, which eager PyTorch
# does not need), for good.
KNOWN_GAPS = {
    "": set(),
    "core": set(),
    "kernels": set(),
    "engine": {"cached_program"},
    "api": set(),
    "serve": set(),
    "configs": set(),
    "models": set(),
    "train": set(),
    "dist": set(),
}
# every subpackage of the reference is in
LATER_SUBPACKAGES = set()
# every launcher of the reference is in (``train``, ``mesh``, ``dryrun``, ``cluster``)
LATER_LAUNCHERS = set()


@pytest.mark.parametrize("package", list(KNOWN_GAPS), ids=lambda p: p or "top")
def test_public_surface_equals_the_reference(package):
    """Each package's ``__all__`` is the reference's, but for the names that
    later slices bring; every listed gap is still a gap."""
    import importlib

    suffix = f".{package}" if package else ""
    ref = importlib.import_module(f"repro{suffix}")
    port = importlib.import_module(f"repro_torch{suffix}")
    gaps = KNOWN_GAPS[package]
    assert gaps <= set(ref.__all__) and not gaps & set(port.__all__)
    assert set(port.__all__) == set(ref.__all__) - gaps
    for name in port.__all__:
        assert hasattr(port, name), name


def test_kernel_names_are_the_kernel_functions():
    import importlib

    import repro_torch.kernels as k

    for name in ("pairwise_topk", "edge_cascade", "lune_filter"):
        fn = getattr(k, name)
        assert callable(fn) and not isinstance(fn, type(k)) and isinstance(fn.launches, int), name
    # the modules stay reachable by their own names
    for name in ("pairwise_topk", "lune_filter", "fused_cascade", "prim_mst", "single_linkage"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert isinstance(mod, type(k)), name
    from repro_torch.core import (PredictResult, edge_mrd2, hdbscan_baseline, membership_probabilities,
                                  predict_range, prim_dense_mst)

    assert all(callable(f) for f in (PredictResult, edge_mrd2, hdbscan_baseline, membership_probabilities,
                                     predict_range, prim_dense_mst))


def test_subpackages_and_estimator_surface_equal_the_reference():
    def subpackages(root):
        return {p.name for p in root.iterdir() if p.is_dir() and any(p.glob("*.py"))}

    ref_pkgs, port_pkgs = subpackages(REPO / "src" / "repro"), subpackages(PORT)
    assert LATER_SUBPACKAGES <= ref_pkgs and port_pkgs == ref_pkgs - LATER_SUBPACKAGES

    def launchers(root):
        return {p.stem for p in (root / "launch").glob("*.py") if p.stem != "__init__"}

    ref_launch, port_launch = launchers(REPO / "src" / "repro"), launchers(PORT)
    assert LATER_LAUNCHERS <= ref_launch and port_launch == ref_launch - LATER_LAUNCHERS
    from repro.api import MultiHDBSCAN as JEst

    def public(cls):
        return {n for n in dir(cls) if not n.startswith("_")}

    # the deprecated per-level accessors and the legacy cache knob included
    assert {"hierarchy_for", "labels_for", "membership_for", "probabilities_for",
            "max_cached_hierarchies"} <= public(t_api.MultiHDBSCAN)
    assert public(t_api.MultiHDBSCAN) == public(JEst)
    from repro.api import FittedModel as JModel

    assert public(t_api.FittedModel) == public(JModel)


def test_edge_mrd2_matches_the_reference():
    import jax.numpy as jnp
    from repro.core import mrd as j_mrd
    from repro_torch.core import mrd as t_mrd

    rng = np.random.default_rng(4)
    for d in (2, 8, 40):
        x = rng.normal(size=(60, d)).astype(np.float32)
        cd2 = rng.random(60).astype(np.float32)
        ea, eb = rng.integers(0, 60, 200).astype(np.int32), rng.integers(0, 60, 200).astype(np.int32)
        want = np.asarray(j_mrd.edge_mrd2(jnp.asarray(x), jnp.asarray(cd2), jnp.asarray(ea), jnp.asarray(eb)))
        got = t_mrd.edge_mrd2(*(torch.from_numpy(a) for a in (x, cd2, ea, eb))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_serving_needs_a_card_unless_cpu_is_asked_for(monkeypatch, blobs, tmp_path):
    from repro_torch.serve import ClusterServeEngine

    x = blobs[0]
    path = t_api.FittedModel.fit(x, kmax=4, device="cpu").save(str(tmp_path / "m.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterServeEngine.load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterServeEngine.fit(x, kmax=4)
    with ClusterServeEngine.load(path, device="cpu") as eng:
        assert eng.device == torch.device("cpu")
        labels, _ = eng.predict(x[:5], mpts=4)
        np.testing.assert_array_equal(labels, eng.model.select(4).labels[:5])


def test_exact_fit_and_loaded_model_need_a_card_unless_cpu_is_asked_for(monkeypatch, blobs, tmp_path):
    x = blobs[0]
    path = t_api.FittedModel.fit(x, kmax=4, variant="rng", device="cpu").save(str(tmp_path / "m.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.MultiHDBSCAN(kmax=4, variant="rng").fit(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_api.FittedModel.load(path)
    model = t_api.FittedModel.load(path, device="cpu")
    labels, _ = model.approximate_predict(x[:5], mpts=4)
    np.testing.assert_array_equal(labels, model.select(4).labels[:5])
