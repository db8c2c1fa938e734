"""The port's core modules against the JAX package, on the CPU.

Same numpy inputs, JAX function beside its port counterpart.  Integer and
boolean outputs must be equal; float outputs agree to rtol 1e-5.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import boruvka as j_boruvka
from repro.core import hierarchy as j_hier
from repro.core import linkage as j_linkage
from repro.core import sbcn as j_sbcn
from repro.core import wspd as j_wspd
from repro.engine.plan import Plan as JPlan
from repro.kernels import ops as j_ops

from repro_torch.core import boruvka as t_boruvka
from repro_torch.core import hierarchy as t_hier
from repro_torch.core import linkage as t_linkage
from repro_torch.core import multi as t_multi
from repro_torch.core import sbcn as t_sbcn
from repro_torch.core import wspd as t_wspd

# the kernel's module by its own name (the package binds kernel names to functions)
t_sl = importlib.import_module("repro_torch.kernels.single_linkage")

RTOL = 1e-5
# the reference plan's emission settings, so the JAX package's program
# registry sees the bucket ladder its fits use
TIE_CAP = JPlan(backend="jnp").cascade_tie_cap
TIER_CHUNK = JPlan(backend="jnp").tier_chunk_elems


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
    """Every point duplicated 8x: mass ties, overflowing the bounded emission."""
    base = np.random.default_rng(7).normal(size=(40, 2)).astype(np.float32)
    return np.repeat(base, 8, axis=0)


@pytest.fixture(scope="module")
def inputs(blobs, gauss16d):
    """Per dataset: x, the reference kNN (k = 15) and its WSPD pairs."""
    out = {}
    for name, x in (("blobs", blobs[0]), ("gauss16d", gauss16d), ("dup", _dup_heavy())):
        d2, idx = j_ops.knn(jnp.asarray(x), 15, backend="jnp")
        cd2k = np.array(d2[:, -1])
        tree = j_wspd.build_fair_split_tree(x.astype(np.float64), np.sqrt(cd2k.astype(np.float64)))
        pu, pv = j_wspd.wspd_pairs(tree, s=1.0)
        out[name] = (x, cd2k, tree, pu, pv)
    return out


def _pair_ranges(tree, pu, pv):
    return (tree.perm, tree.start[pu], tree.end[pu] - tree.start[pu],
            tree.start[pv], tree.end[pv] - tree.start[pv])


@pytest.mark.parametrize("name", ["blobs", "gauss16d", "dup"])
def test_wspd_tree_and_pairs_equal(inputs, name):
    x, cd2k, tree, pu, pv = inputs[name]
    t_tree = t_wspd.build_fair_split_tree(x.astype(np.float64), np.sqrt(cd2k.astype(np.float64)))
    for f in dataclasses.fields(tree):
        np.testing.assert_array_equal(getattr(t_tree, f.name), getattr(tree, f.name), err_msg=f.name)
    t_pu, t_pv = t_wspd.wspd_pairs(t_tree, s=1.0)
    np.testing.assert_array_equal(t_pu, pu)
    np.testing.assert_array_equal(t_pv, pv)


@pytest.mark.parametrize("name", ["blobs", "gauss16d", "dup"])
def test_cascade_candidates_keys_and_counters_equal(inputs, name):
    x, cd2k, tree, pu, pv = inputs[name]
    ks_j, *cnt_j = j_sbcn.cascade_candidates(
        jnp.asarray(x), jnp.asarray(cd2k), *_pair_ranges(tree, pu, pv),
        tie_cap=TIE_CAP, tier_chunk_elems=TIER_CHUNK,
    )
    ks_t, *cnt_t = t_sbcn.cascade_candidates(
        torch.from_numpy(x), torch.from_numpy(cd2k), *_pair_ranges(tree, pu, pv),
        tie_cap=TIE_CAP, tier_chunk_elems=TIER_CHUNK,
    )
    cnt_j = [int(v) for v in cnt_j]
    assert [int(v) for v in cnt_t] == cnt_j  # n_real, n_unique, n_mutual, n_overflow
    n_real = cnt_j[0]
    np.testing.assert_array_equal(ks_t.numpy()[:n_real], np.asarray(ks_j)[:n_real])
    if name == "dup":
        assert cnt_j[3] > 0  # the duplicate-heavy input overflows the tie cap


@pytest.mark.parametrize("name", ["blobs", "dup"])
def test_sbcn_candidates_equal(inputs, name):
    x, cd2k, tree, pu, pv = inputs[name]
    lo_j, hi_j, keep_j = (np.asarray(v) for v in j_sbcn.sbcn_candidates(
        jnp.asarray(x), jnp.asarray(cd2k), *_pair_ranges(tree, pu, pv)
    ))
    lo_t, hi_t, keep_t = (v.numpy() for v in t_sbcn.sbcn_candidates(
        torch.from_numpy(x), torch.from_numpy(cd2k), *_pair_ranges(tree, pu, pv)
    ))
    np.testing.assert_array_equal(lo_t[keep_t], lo_j[keep_j])
    np.testing.assert_array_equal(hi_t[keep_t], hi_j[keep_j])
    assert keep_t.sum() > 0


def _graph_with_ties(n=120, m=700, seed=0):
    rng = np.random.default_rng(seed)
    ea = np.concatenate([np.arange(n - 1), rng.integers(0, n, m - (n - 1))]).astype(np.int32)
    eb = np.concatenate([np.arange(1, n), rng.integers(0, n, m - (n - 1))]).astype(np.int32)
    eb = np.where(ea == eb, (eb + 1) % n, eb).astype(np.int32)
    # three weight rows, the last one with mass ties and zeros
    w = np.stack([
        rng.uniform(0.1, 5.0, m),
        rng.choice([0.5, 1.0, 2.0], m),
        rng.choice([0.0, 1.0], m),
    ]).astype(np.float32)
    return ea, eb, w, n


def test_boruvka_mst_range_masks_equal():
    ea, eb, w, n = _graph_with_ties()
    mask_j = np.asarray(j_boruvka.boruvka_mst_range(jnp.asarray(ea), jnp.asarray(eb), jnp.asarray(w), n=n))
    t = torch.from_numpy
    mask_t = t_boruvka.boruvka_mst_range(t(ea), t(eb), t(w), n=n).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    assert (mask_t.sum(axis=1) == n - 1).all()
    single = t_boruvka.boruvka_mst(t(ea), t(eb), t(w[1]), n=n).numpy()
    np.testing.assert_array_equal(single, mask_j[1])


def _spanning_trees(n=80, rows=6):
    eas, ebs, ws = [], [], []
    for seed in range(rows):
        rng = np.random.default_rng(seed)
        eas.append(np.array([rng.integers(0, i + 1) for i in range(n - 1)]))
        ebs.append(np.arange(1, n))
        if seed % 2 == 0:
            ws.append(rng.choice([0.5, 1.0, 1.5, 2.0], size=n - 1).astype(np.float32))
        else:
            ws.append(rng.uniform(0.1, 5.0, size=n - 1).astype(np.float32))
    return np.stack(eas).astype(np.int32), np.stack(ebs).astype(np.int32), np.stack(ws), n


def test_single_linkage_batch_arrays_equal():
    ea, eb, w, n = _spanning_trees()
    out_j = j_linkage.single_linkage_batch(ea, eb, w, n=n)
    out_t = t_linkage.single_linkage_batch(ea, eb, w, n=n)
    for name, a, b in zip(("left", "right", "height", "size"), out_j, out_t):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
    t_linkage.validate_spanning(ea[0], eb[0], n)
    with pytest.raises(ValueError, match="cycle"):
        t_linkage.validate_spanning(np.r_[ea[0][:-1], 0], np.r_[eb[0][:-1], 1], n)


def _numpy_single_linkage(ea, eb, w, n):
    """The port's earlier host union-find: numpy, vectorised over the rows."""
    R, m = w.shape
    order = np.argsort(w, axis=1, kind="stable")
    ea_s = np.take_along_axis(ea, order, axis=1).astype(np.int64)
    eb_s = np.take_along_axis(eb, order, axis=1).astype(np.int64)
    rows = np.arange(R)
    parent = np.tile(np.arange(n, dtype=np.int64), (R, 1))
    label = parent.copy()
    csize = np.ones((R, n), np.int64)
    left, right, size = (np.zeros((R, m), np.int32) for _ in range(3))

    def find(v):
        r = v.copy()
        while True:
            p = parent[rows, r]
            if (p == r).all():
                return r
            r = np.where(p != r, p, r)

    for i in range(m):
        ra, rb = find(ea_s[:, i]), find(eb_s[:, i])
        sa, sb = csize[rows, ra], csize[rows, rb]
        left[:, i], right[:, i], size[:, i] = label[rows, ra], label[rows, rb], sa + sb
        winner, loser = np.where(sa >= sb, ra, rb), np.where(sa >= sb, rb, ra)
        parent[rows, loser] = winner
        label[rows, winner] = n + i
        csize[rows, winner] = sa + sb
    return left, right, np.take_along_axis(w, order, axis=1), size


@pytest.mark.parametrize("rows", [1, 15])
@pytest.mark.parametrize("ties", [True, False], ids=["tied-and-zero", "distinct"])
def test_single_linkage_plain_matches_reference_and_the_numpy_loop(rows, ties):
    """The kernel's plain version on sorted endpoints, and the whole
    ``single_linkage_batch`` on the CPU, against the reference's device
    program and against the earlier numpy loop: all four arrays equal."""
    n = 300
    ea, eb, w = t_linkage.random_spanning_trees(n, rows, seed=rows + ties, ties=ties)
    out_j = [np.asarray(a) for a in j_linkage.single_linkage_batch(ea, eb, w, n=n)]
    out_np = _numpy_single_linkage(ea, eb, w, n)
    order = np.argsort(w, axis=1, kind="stable")
    t = torch.from_numpy
    plain = t_sl.single_linkage_plain(t(np.take_along_axis(ea, order, 1)), t(np.take_along_axis(eb, order, 1)), n=n)
    batch = t_linkage.single_linkage_batch(t(ea), t(eb), t(w), n=n)
    for k, name in enumerate(("left", "right", "height", "size")):
        np.testing.assert_array_equal(out_np[k], out_j[k], err_msg=name)
        np.testing.assert_array_equal(batch[k].numpy(), out_j[k], err_msg=name)
    for got, want, name in zip(plain, (out_j[0], out_j[1], out_j[3]), ("left", "right", "size")):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_single_linkage_on_the_cpu_runs_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launch")

    monkeypatch.setattr(t_sl, "_launch", boom)
    before = t_sl.single_linkage.launches
    ea, eb, w = t_linkage.random_spanning_trees(50, 3, seed=5, ties=True)
    left, right, height, size = t_linkage.single_linkage_batch(ea, eb, w, n=50)
    assert (size[:, -1] == 50).all() and t_sl.single_linkage.launches == before
    empty = t_linkage.single_linkage_batch(ea[:0], eb[:0], w[:0], n=50)  # an empty mpts list
    assert all(a.shape == (0, 49) for a in empty)
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(R, n-1\)"):
        t_sl.single_linkage(z, z, n=4)
    with pytest.raises(ValueError, match="integers"):
        t_sl.single_linkage(z.float(), z.float(), n=5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_sl.single_linkage(z.to("meta"), z.to("meta"), n=5)


def test_direct_linkage_needs_a_card_unless_cpu_is_asked_for(monkeypatch, blobs):
    """``linkage_range`` and ``extract_hierarchies`` take host MSTs, so the
    caller names the device; the default is the card, which raises
    without one.  With ``device="cpu"`` they equal the reference's."""
    from repro.core import multi as j_multi

    x = blobs[0]
    msts = t_multi.fit_msts(x, 6, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_multi.linkage_range(msts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_multi.extract_hierarchies(msts)
    lk = t_multi.linkage_range(msts, device="cpu")
    lk_j = j_multi.linkage_range(msts)
    for f in ("left", "right", "height", "size"):
        np.testing.assert_array_equal(getattr(lk, f), np.asarray(getattr(lk_j, f)), err_msg=f)
    hs, t = t_multi.extract_hierarchies(msts, device="cpu")
    hs_j, _ = j_multi.extract_hierarchies(msts)
    assert "hierarchy_linkage" in t
    for h_t, h_j in zip(hs, hs_j):
        np.testing.assert_array_equal(h_t.labels, np.asarray(h_j.labels))


@pytest.mark.parametrize("method", ["eom", "leaf"])
@pytest.mark.parametrize("mcs", [2, 5, 25])
def test_hierarchy_labels_equal(method, mcs):
    ea, eb, w, n = _spanning_trees()
    left, right, height, size = t_linkage.single_linkage_batch(ea, eb, w, n=n)
    for row in range(len(w)):
        Z = t_linkage.linkage_to_Z(left[row], right[row], height[row], size[row])
        out = []
        for hier in (j_hier, t_hier):
            tree = hier.condense_tree_fast(Z, n, mcs)
            stab = hier.compute_stability_fast(tree)
            sel = hier.extract_clusters(tree, stab, cluster_selection_method=method)
            out.append((hier.labels_for_fast(tree, sel), stab))
        (lab_j, lam_j), stab_j = out[0]
        (lab_t, lam_t), stab_t = out[1]
        np.testing.assert_array_equal(lab_t, lab_j)
        np.testing.assert_allclose(lam_t, lam_j, rtol=RTOL)
        assert stab_t.keys() == stab_j.keys()
