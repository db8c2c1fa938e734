"""The port's re-run baseline against the JAX package, on the CPU.

``prim_dense_mst`` (the ``prim_mst`` kernel's plain version on CPU
tensors) against ``repro.core.boruvka.prim_dense_mst``: ``src`` equal and
``w2`` bit-equal at widths on both sides of the summation-order switch,
and on duplicates whose argmin ties must break by the lowest index.
``hdbscan_baseline`` against ``repro.core.multi.hdbscan_baseline``: MST
edge ids equal, ``mst_w`` bit-equal and labels equal for every mpts, the
same ledger tags and timing keys; its labels agree with the port's own
``multi_hdbscan`` as ``tests/test_api.py`` holds the reference's.  The
``"prim"`` summation order against the order read from the reference's
compiled program.
"""

import importlib
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as j_engine
from repro.core import boruvka as j_boruvka
from repro.core import multi as j_multi

from repro_torch import engine as t_engine
from repro_torch.core import boruvka as t_boruvka
from repro_torch.core import linkage as t_linkage
from repro_torch.core import multi as t_multi
from repro_torch.kernels import ops as t_ops

# the kernel's module by its own name (the package binds kernel names to functions)
t_pm = importlib.import_module("repro_torch.kernels.prim_mst")

KMAX = 16
MPTS = list(range(2, KMAX + 1))
REPO = pathlib.Path(__file__).resolve().parents[1]


def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(4, d))
    x = centers[rng.integers(0, 4, n)] + rng.normal(0, 0.8, size=(n, d))
    return x.astype(np.float32)


def _core_col(x, k, seed):
    """Squared distance to the k-th other point: a plausible cd2 column."""
    d2 = ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)
    return np.sort(d2, axis=1)[:, k].astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n,d", [(600, 2), (400, 8), (300, 16), (257, 32), (200, 33), (150, 64)])
def test_prim_dense_mst_matches_reference(n, d):
    x = _points(n, d, seed=n + d)
    cd2 = _core_col(x, 5, seed=d)
    src_j, w2_j = j_boruvka.prim_dense_mst(jnp.asarray(x), jnp.asarray(cd2))
    src_t, w2_t = t_boruvka.prim_dense_mst(torch.from_numpy(x), torch.from_numpy(cd2))
    assert src_t.dtype == torch.int32 and w2_t.dtype == torch.float32
    np.testing.assert_array_equal(src_t.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(_bits(w2_t.numpy()), _bits(w2_j))
    assert float(w2_t[0]) == 0.0


@pytest.mark.parametrize("d", [2, 33])
def test_prim_dense_mst_breaks_ties_by_lowest_index(d):
    """Every point 8 times and core distances rounded to a few values:
    most minima tie, and the pick must be the lowest index, as
    ``jax.lax.argmin`` takes it."""
    base = _points(40, d, seed=d)
    x = np.repeat(base, 8, axis=0)
    cd2 = np.round(_core_col(x, 9, seed=d), 0).astype(np.float32)
    src_j, w2_j = j_boruvka.prim_dense_mst(jnp.asarray(x), jnp.asarray(cd2))
    src_t, w2_t = t_boruvka.prim_dense_mst(torch.from_numpy(x), torch.from_numpy(cd2))
    np.testing.assert_array_equal(src_t.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(_bits(w2_t.numpy()), _bits(w2_j))
    assert len(np.unique(np.asarray(w2_j))) < len(x) // 4  # the case does tie


def test_prim_plain_rows_up_front_or_per_step_agree(monkeypatch):
    """The plain version sums the d2 rows up front while the matrix fits
    its budget, one row a step above it: the same bits either way."""
    x = torch.from_numpy(_points(300, 8, seed=3))
    cd2 = torch.from_numpy(_core_col(x.numpy(), 4, seed=3))
    a = t_pm.prim_mst_plain(x, cd2)
    monkeypatch.setattr(t_pm, "MATRIX_BYTES", 0)
    b = t_pm.prim_mst_plain(x, cd2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


def test_prim_mst_on_the_cpu_runs_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launch")

    monkeypatch.setattr(t_pm, "_launch", boom)
    before = t_pm.prim_mst.launches
    x = torch.from_numpy(_points(50, 2, seed=1))
    src, w2 = t_pm.prim_mst(x, torch.zeros(50))
    assert src.shape == (50,) and float(w2[0]) == 0.0
    assert t_pm.prim_mst.launches == before


def test_prim_mst_rejects_bad_input():
    x = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="cd2_col"):
        t_pm.prim_mst(x, torch.zeros(4))
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        t_pm.prim_mst(torch.zeros(5), torch.zeros(5))
    with pytest.raises(ValueError, match="floating"):
        t_pm.prim_mst(x.int(), torch.zeros(5))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_pm.prim_mst(x.to("meta"), torch.zeros(5, device="meta"))


def test_single_point():
    src, w2 = t_boruvka.prim_dense_mst(torch.zeros((1, 3)), torch.zeros(1))
    assert src.tolist() == [0] and w2.tolist() == [0.0]


# -- the baseline ------------------------------------------------------------

def _blobs520():
    """``tests/test_api.py``'s acceptance data set (n = 520, d = 2)."""
    rng = np.random.default_rng(11)
    return np.concatenate([
        rng.normal((0, 0), 0.35, size=(180, 2)),
        rng.normal((5, 0), 0.5, size=(180, 2)),
        rng.normal((2.5, 4.5), 0.4, size=(130, 2)),
        rng.uniform(-2, 7, size=(30, 2)),
    ]).astype(np.float32)


BASELINE_CASES = {
    "blobs520": lambda blobs: _blobs520(),
    "blobs": lambda blobs: blobs[0],
    "gauss8d": lambda blobs: _points(400, 8, seed=8),
    "gauss33d": lambda blobs: _points(250, 33, seed=33),
}


@pytest.fixture(scope="module")
def baselines(blobs):
    """Per case: (x, reference (results, timings, tags), port (results, timings, tags))."""
    out = {}
    for name, make in BASELINE_CASES.items():
        x = make(blobs)
        with j_engine.transfer_ledger() as lj:
            ref = j_multi.hdbscan_baseline(x, MPTS)
        with t_engine.transfer_ledger() as lt:
            port = t_multi.hdbscan_baseline(x, MPTS, device="cpu")
        out[name] = (x, (*ref, j_engine.io.tags(lj)), (*port, t_engine.io.tags(lt)))
    return out


@pytest.mark.parametrize("name", list(BASELINE_CASES))
def test_baseline_matches_reference_for_every_mpts(baselines, name):
    _, (hs_j, _, _), (hs_t, _, _) = baselines[name]
    assert [h.mpts for h in hs_t] == [h.mpts for h in hs_j] == MPTS
    for h_j, h_t in zip(hs_j, hs_t):
        msg = f"{name} mpts={h_j.mpts}"
        np.testing.assert_array_equal(h_t.mst_ea, np.asarray(h_j.mst_ea), err_msg=msg)
        np.testing.assert_array_equal(h_t.mst_eb, np.asarray(h_j.mst_eb), err_msg=msg)
        np.testing.assert_array_equal(_bits(h_t.mst_w), _bits(h_j.mst_w), err_msg=msg)
        np.testing.assert_array_equal(h_t.labels, np.asarray(h_j.labels), err_msg=msg)
        assert h_t.n_clusters == h_j.n_clusters and h_t.selected == h_j.selected, msg


@pytest.mark.parametrize("name", list(BASELINE_CASES))
def test_baseline_ledger_and_timings_match_reference(baselines, name):
    _, (_, t_j, tags_j), (_, t_t, tags_t) = baselines[name]
    assert tags_t == tags_j == ["mst"] * len(MPTS) + ["knn", "linkage"]
    assert t_t.keys() == t_j.keys() == {"knn", "mst", "hierarchy", "total"}
    assert t_t["total"] == pytest.approx(t_t["knn"] + t_t["mst"] + t_t["hierarchy"])


def _assert_partitions_agree(a, b, tol=0.98):
    """``tests/test_api.py``'s test: the same partition up to label
    permutation and rare tie-boundary points."""
    assert abs((a >= 0).sum() - (b >= 0).sum()) <= max(2, 0.01 * len(a))
    agree = total = 0
    for c in np.unique(a[a >= 0]):
        members = b[a == c]
        members = members[members >= 0]
        if len(members) == 0:
            continue
        _, counts = np.unique(members, return_counts=True)
        agree += counts.max()
        total += counts.sum()
    assert total > 0 and agree / total > tol


def test_baseline_agrees_with_the_port_fit(baselines):
    """As ``tests/test_api.py`` holds the reference, on its data set: the
    fit's MSTs carry the baseline's weight multisets and its labels the
    same partitions.  (Equal-weight MSTs may differ in their edges, so on
    other data the partitions of a small mpts can differ as much for the
    reference's own fit and baseline.)"""
    x, _, (hs_t, _, _) = baselines["blobs520"]
    fit = t_multi.multi_hdbscan(x, KMAX, device="cpu")
    for hb, hf in zip(hs_t, fit.hierarchies):
        assert hb.mpts == hf.mpts
        np.testing.assert_allclose(np.sort(hf.mst_w), np.sort(hb.mst_w), rtol=1e-5, atol=1e-6)
        assert abs(hf.n_clusters - hb.n_clusters) <= 1
        _assert_partitions_agree(hf.labels, hb.labels)


def _cluster_counts(fit, baseline):
    """Clusters per mpts, (fit, baseline), of two lists of hierarchies."""
    return {hb.mpts: (int(hf.n_clusters), int(hb.n_clusters)) for hf, hb in zip(fit, baseline)}


def reference_cluster_counts(x):
    """The JAX package's clusters per mpts 2..KMAX, (fit, baseline)."""
    fit = j_multi.multi_hdbscan(x, KMAX)
    base, _ = j_multi.hdbscan_baseline(x, MPTS, kmax=KMAX)
    return _cluster_counts(fit.hierarchies, base)


@pytest.mark.parametrize("name", list(BASELINE_CASES))
def test_fit_and_baseline_cluster_counts_are_the_references(baselines, name):
    """Wherever the fit and the baseline count clusters differently, the
    reference's own fit and baseline differ the same way: both exact
    methods condense equal-weight merges in their own MST's order."""
    x, _, (hs_t, _, _) = baselines[name]
    fit = t_multi.multi_hdbscan(x, KMAX, device="cpu")
    assert _cluster_counts(fit.hierarchies, hs_t) == reference_cluster_counts(x)


@pytest.mark.parametrize("name", list(BASELINE_CASES))
def test_baseline_and_fit_give_the_same_single_linkage_hierarchy(baselines, name):
    """Any two MSTs of one weighted graph carry the same weights and the
    same single-linkage partitions at every height, whichever equal-weight
    edges their tie-breaks picked: the baseline's dense Prim and the fit's
    Borůvka over the RNG* graph must, bit for bit, for every mpts."""
    x, _, (hs_t, _, _) = baselines[name]
    fit = t_multi.fit_msts(x, KMAX, device="cpu")
    n = len(x)
    for hb in hs_t:
        row = fit.row_of(hb.mpts)
        tree_f = (fit.mst_ea[row], fit.mst_eb[row], fit.mst_w[row])
        assert t_linkage.same_single_linkage(tree_f, (hb.mst_ea, hb.mst_eb, hb.mst_w), n), hb.mpts
    # and the check has teeth: the same weights on other edges break it
    h = hs_t[3]
    w = h.mst_w.copy()
    lo, hi = np.argmin(w), np.argmax(w)
    w[lo], w[hi] = w[hi], w[lo]
    assert not t_linkage.same_single_linkage((h.mst_ea, h.mst_eb, w), (h.mst_ea, h.mst_eb, h.mst_w), n)


def test_baseline_without_hierarchies_and_with_a_plan(blobs):
    x = blobs[0][:120]
    res, t = t_multi.hdbscan_baseline(x, [3, 7], compute_hierarchies=False, device="cpu")
    assert res == [] and t["hierarchy"] >= 0.0 and set(t) == {"knn", "mst", "hierarchy", "total"}
    plan = t_engine.resolve_plan(device="cpu")
    res, _ = t_multi.hdbscan_baseline(x, [3, 7], kmax=10, plan=plan)
    ref, _ = j_multi.hdbscan_baseline(x, [3, 7], kmax=10)
    for h_t, h_j in zip(res, ref):
        np.testing.assert_array_equal(_bits(h_t.mst_w), _bits(h_j.mst_w))
        np.testing.assert_array_equal(h_t.labels, np.asarray(h_j.labels))
    with pytest.raises(ValueError, match="min_cluster_size"):
        t_multi.hdbscan_baseline(x, [3], min_cluster_size=1, device="cpu")


# -- the "prim" summation order, read from the reference's compiled program ----

_DUMP = r"""
import os, sys
import jax, jax.numpy as jnp
from repro.core import boruvka
for d in map(int, sys.argv[2:]):
    x = jnp.zeros((300, d), jnp.float32)
    jax.jit(boruvka.prim_dense_mst).lower(x, jnp.zeros((300,), jnp.float32)).compile()
"""


def _compiled_orders(tmp_path, widths):
    """The order XLA compiled ``prim_dense_mst``'s row sum to at each width:
    ``win32`` where its optimised HLO has a ``reduce-window``, else ``fma``
    or ``seq`` by whether the row-sum fusion's object code has ``vfmadd``."""
    out = {}
    for d in widths:
        dump = tmp_path / f"d{d}"
        env = {**os.environ, "XLA_FLAGS": f"--xla_dump_to={dump} --xla_dump_hlo_as_text",
               "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO / "src")}
        subprocess.run([sys.executable, "-c", _DUMP, "x", str(d)], env=env, check=True, timeout=300)
        hlo = next(dump.glob("*jit_prim_dense_mst.cpu_after_optimizations.txt")).read_text()
        if "reduce-window(" in hlo:
            out[d] = "win32"
            continue
        # the fusion that multiplies and row-sums the diffs, and its object code
        name = re.search(r"%(\S*multiply\S*reduce\S*) = f32\[300\]\{0\} fusion", hlo).group(1)
        obj = next(dump.glob(f"*jit_prim_dense_mst.obj-file.{name}_kernel_module.o"))
        asm = subprocess.run(["objdump", "-d", str(obj)], capture_output=True, text=True, check=True).stdout
        out[d] = "fma" if "vfmadd" in asm else "seq"
    return out


def test_prim_sum_order_is_the_compiled_programs(tmp_path):
    """``ops.sum_order(d, "prim")`` at one width on each side of the switch
    at 32, and on each side of the cascade's switch at 8 (where the prim
    program does not switch)."""
    widths = (8, 9, 32, 33)
    compiled = _compiled_orders(tmp_path, widths)
    for d in widths:
        assert t_ops.sum_order(d, "prim") == compiled[d], d


if __name__ == "__main__":
    # The reference's clusters per mpts, (fit, baseline), on the points of
    # chip_smoke.py's main path: python tests/test_torch_baseline.py [n] [seed]
    sys.path.insert(0, str(REPO))
    from chip_smoke import D, N, SEED, make_points

    n = int(sys.argv[1]) if len(sys.argv) > 1 else N
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else SEED
    print(f"reference, n={n}, d={D}, seed={seed}: clusters (fit, baseline) per mpts",
          reference_cluster_counts(make_points(n, D, seed)))
