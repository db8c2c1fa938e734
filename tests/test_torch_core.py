"""The port's core modules against the JAX package, on the CPU.

Same numpy inputs, JAX function beside its port counterpart.  Integer and
boolean outputs must be equal; float outputs agree to rtol 1e-5.
"""

import dataclasses

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
from repro_torch.core import sbcn as t_sbcn
from repro_torch.core import wspd as t_wspd

RTOL = 1e-5
# the reference plan's emission settings, so the JAX package's program
# registry sees the bucket ladder its fits use
TIE_CAP = JPlan(backend="jnp").cascade_tie_cap
TIER_CHUNK = JPlan(backend="jnp").tier_chunk_elems


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
