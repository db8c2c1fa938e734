"""The port's kernel modules against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, or the jnp twin) and through the port's wrapper, which on
CPU tensors runs the kernel's plain PyTorch version.  Integer outputs must
be equal; float outputs agree to rtol 1e-5, the tolerance the repo uses
for MST weight multisets.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sbcn as j_sbcn
from repro.core import wspd as j_wspd
from repro.engine.plan import Plan as JPlan
from repro.kernels import fused_cascade as j_fc
from repro.kernels import ops as j_ops
from repro.kernels.pairwise_topk import pairwise_topk as j_pairwise_topk

from repro_torch.kernels import fused_cascade as t_fc
from repro_torch.kernels import ops as t_ops

# the package binds the name to the kernel function, as the reference's does
t_pt = importlib.import_module("repro_torch.kernels.pairwise_topk")

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


def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(3, d))
    return (centers[rng.integers(0, 3, n)] + rng.normal(0, 0.5, size=(n, d))).astype(np.float32)


# (n, d, k): the kmax = 16 widths, and k = 72 and 128, whose over-selected
# lists (k + 8) need the card kernel's second to fifth list slots
KNN_CASES = [(n, d, k) for n in (64, 257) for d in (2, 8) for k in (4, 15)] + [
    (300, d, k) for d in (3, 8) for k in (72, 128)
]


def _raw_d2_tol(x, idx):
    """The matmul form's error scale per entry: 1e-5 * (|q|^2 + |k|^2)."""
    xn = (x.astype(np.float64) ** 2).sum(1)
    return RTOL * (xn[:, None] + xn[idx])


@pytest.mark.parametrize("backend", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("n,d,k", KNN_CASES)
def test_knn_matches_reference(n, d, k, backend):
    x = _points(n, d, seed=n + d)
    d_j, i_j = j_ops.knn(jnp.asarray(x), k, backend=backend)
    d_t, i_t = t_ops.knn(torch.from_numpy(x), k, backend="torch")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL)


def test_knn_ref_backend_matches_torch_backend(blobs):
    x = torch.from_numpy(blobs[0])
    d_r, i_r = t_ops.knn(x, 15, backend="ref")
    d_t, i_t = t_ops.knn(x, 15, backend="torch")
    np.testing.assert_array_equal(i_r.numpy(), i_t.numpy())
    np.testing.assert_array_equal(d_r.numpy(), d_t.numpy())


@pytest.mark.parametrize("k", [7, 60])
def test_pairwise_topk_plain_orders_ties_by_index(k):
    """Duplicated points tie exactly; the lower index comes first, as the
    reference's stable streaming merge orders them, at every list position
    (k = 60 reaches the card kernel's second list slot)."""
    base = np.random.default_rng(3).normal(size=(30, 2)).astype(np.float32)
    x_np = np.repeat(base, 4, axis=0)
    x = torch.from_numpy(x_np)
    d2, idx = t_pt.pairwise_topk_plain(x, k, block_q=16, block_k=24)
    d2_r, idx_r = t_pt.pairwise_topk_plain(x, k, block_q=1024, block_k=2048)
    np.testing.assert_array_equal(idx.numpy(), idx_r.numpy())
    np.testing.assert_array_equal(d2.numpy(), d2_r.numpy())
    same = d2[:, :-1] == d2[:, 1:]  # duplicated points tie exactly
    assert same[:, 32:].any() if k > 33 else same.any()
    assert (idx[:, :-1][same] < idx[:, 1:][same]).all()
    _, idx_j = j_pairwise_topk(jnp.asarray(x_np), k, block_q=32, block_k=32, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("k", [7, 72, 128])
@pytest.mark.parametrize("d", [3, 8])
def test_pairwise_topk_plain_matches_reference(d, k):
    """The raw lists against the reference's Pallas kernel in interpret
    mode: d2 within the matmul form's error scale; indices equal but at
    near-ties, which that error may order either way."""
    x = _points(300, d, seed=k + d)
    d_j, i_j = j_pairwise_topk(jnp.asarray(x), k, block_q=128, block_k=128, interpret=True)
    d_t, i_t = t_pt.pairwise_topk(torch.from_numpy(x), k)
    d_j, i_j, d_t, i_t = np.asarray(d_j), np.asarray(i_j), d_t.numpy(), i_t.numpy()
    assert d_t.shape == i_t.shape == (300, k)
    assert (np.abs(d_t - d_j) <= _raw_d2_tol(x, i_t)).all()
    assert ((i_t >= 0) & (i_t != np.arange(300)[:, None])).all()
    assert (i_t == i_j).mean() > 0.99


@pytest.fixture(scope="module")
def blobs_candidates(blobs):
    """The real stage-1 input of the fused build on ``blobs``: the sorted
    packed candidate keys of the reference's bounded SBCN emission."""
    x = blobs[0]
    xj = jnp.asarray(x)
    d2, idx = j_ops.knn(xj, 15, backend="jnp")
    cd2k = d2[:, -1]
    tree = j_wspd.build_fair_split_tree(x.astype(np.float64), np.sqrt(np.asarray(cd2k, np.float64)))
    pu, pv = j_wspd.wspd_pairs(tree, s=1.0)
    ks, n_real, *_ = j_sbcn.cascade_candidates(
        xj, cd2k, tree.perm, tree.start[pu], tree.end[pu] - tree.start[pu],
        tree.start[pv], tree.end[pv] - tree.start[pv],
        tie_cap=TIE_CAP, tier_chunk_elems=TIER_CHUNK,
    )
    keys = np.asarray(ks)[: int(n_real)]
    n = len(x)
    return x, np.array(d2), np.array(idx), keys // n, keys % n


@pytest.mark.parametrize("k_check", [2, 15])
def test_edge_cascade_matches_pallas_interpret(blobs_candidates, k_check):
    x, d2, idx, lo, hi = blobs_candidates
    rng = np.random.default_rng(k_check)
    valid = rng.random(len(lo)) > 0.05
    cd2k = d2[:, -1]
    out_j = j_fc.edge_cascade(
        jnp.asarray(x), jnp.asarray(cd2k), jnp.asarray(idx), jnp.asarray(d2),
        jnp.asarray(lo.astype(np.int32)), jnp.asarray(hi.astype(np.int32)), jnp.asarray(valid),
        k_check=k_check, backend="pallas_interpret",
    )
    t = torch.from_numpy
    out_t = t_fc.edge_cascade(
        t(x), t(cd2k), t(idx), t(d2), t(lo.astype(np.int32)), t(hi.astype(np.int32)), t(valid),
        k_check=k_check,
    )
    killed_j, cert_j, d2_j, w2_j = (np.asarray(v) for v in out_j)
    killed_t, cert_t, d2_t, w2_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(killed_t, killed_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    assert killed_t.any() and cert_t.any()
    np.testing.assert_allclose(d2_t[valid], d2_j[valid], rtol=RTOL)
    np.testing.assert_allclose(w2_t[valid], w2_j[valid], rtol=RTOL)


def test_stage1_packed_matches_reference(blobs_candidates):
    """Unpack -> cascade -> certificate split of the sorted keys (the
    kernel's stage-1 dispatch) against the reference's one-program block."""
    x, d2, idx, lo, hi = blobs_candidates
    n = len(x)
    keys = (lo * n + hi).astype(np.int32)
    keys = np.concatenate([keys, np.full(5, np.iinfo(np.int32).max, np.int32)])
    cd2k = d2[:, -1]
    out_j = j_fc.stage1_packed(
        jnp.asarray(x), jnp.asarray(cd2k), jnp.asarray(idx), jnp.asarray(d2),
        jnp.asarray(keys), jnp.int32(n), k_check=2, chunk=65536,
    )
    t = torch.from_numpy
    out_t = t_fc.stage1_packed(
        t(x), t(cd2k), t(idx), t(d2), t(keys), n, k_check=2, chunk=65536, block_e=256,
    )
    for name, a, b in zip(("lo", "hi", "surv_cert", "surv_open", "n_cert", "n_open"),
                          (out_j[i] for i in (0, 1, 4, 5, 6, 7)),
                          (out_t[i] for i in (0, 1, 4, 5, 6, 7))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("d", [2, 8, 9, 16, 32, 33, 48, 64, 100])
def test_cascade_sum_order_matches_the_reference_programs(d):
    """``ops.sum_order`` picks, at each width, the order in which XLA sums
    the reference's cascade squares: the fused programs (stage 1 in one
    program, the jnp twin, the Pallas kernel in interpret mode) and the
    slot path's eager ``edge_d2``.  The stage d2 and w2 are bit-equal.

    The edge count is a multiple of 16, as the reference's power-of-two
    buckets make it in a fit: XLA's vectorised loops leave a scalar
    remainder for a ragged count, and that remainder fuses its adds."""
    from repro.core import mrd as j_mrd

    rng = np.random.default_rng(d)
    n, m, k = 300, 2000, 4
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    lo = rng.integers(0, n - 1, m).astype(np.int32)
    hi = (lo + rng.integers(1, n - lo)).astype(np.int32)
    keys = np.unique(lo * n + hi).astype(np.int32)
    keys = keys[: len(keys) // 16 * 16]
    lo, hi = keys // n, keys % n
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    kd2 = np.sort(np.abs(rng.normal(size=(n, k))), axis=1).astype(np.float32)
    cd2k = kd2[:, -1]
    valid = np.ones(len(lo), bool)
    J = jnp.asarray
    fused = {
        "stage1_packed": j_fc.stage1_packed(
            J(x), J(cd2k), J(idx), J(kd2), J(keys), jnp.int32(n), k_check=2, chunk=65536
        )[2],
        "jnp twin": j_fc.edge_cascade(J(x), J(cd2k), J(idx), J(kd2), J(lo), J(hi), J(valid), k_check=k)[2],
        "pallas_interpret": j_fc.edge_cascade(
            J(x), J(cd2k), J(idx), J(kd2), J(lo), J(hi), J(valid), k_check=k, backend="pallas_interpret"
        )[2],
    }
    t = torch.from_numpy
    for program, programs in (("cascade", fused), ("slot", {"slot edge_d2": j_mrd.edge_d2(J(x), J(lo), J(hi))})):
        order = t_ops.sum_order(d, program)
        assert order == ("win32" if d > 32 else order)
        _, _, d2_t, w2_t = t_fc.edge_cascade(
            t(x), t(cd2k), t(idx), t(kd2), t(lo), t(hi), t(valid), k_check=k, order=order,
        )
        for name, d2_j in programs.items():
            np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j), err_msg=name)
        np.testing.assert_array_equal(w2_t.numpy(), np.maximum(cd2k[lo], np.maximum(cd2k[hi], d2_t.numpy())))


@pytest.mark.parametrize("d", [33, 40, 48, 64, 100, 256])
def test_sum_sq_win32_matches_jnp_sum(d):
    """Above 32, XLA on the CPU sums a row in windows of 32 (``sum_sq_win32``):
    bit for bit equal to ``jnp.sum(v * v, -1)`` under ``jit``, where no
    index order is."""
    import jax

    rng = np.random.default_rng(d)
    a = (rng.normal(size=(4096, d)) * 3).astype(np.float32)
    b = rng.normal(size=(4096, d)).astype(np.float32)
    ref_diff = np.asarray(jax.jit(lambda a, b: jnp.sum((a - b) * (a - b), -1))(a, b))
    ref_norm = np.asarray(jax.jit(lambda a: jnp.sum(a * a, -1))(a))
    np.testing.assert_array_equal(t_ops.sum_sq_win32(torch.from_numpy(a - b)).numpy(), ref_diff)
    np.testing.assert_array_equal(t_ops.sum_sq_win32(torch.from_numpy(a)).numpy(), ref_norm)
    assert (t_ops.sum_sq_seq(torch.from_numpy(a)).numpy() != ref_norm).any()


def test_sum_sq_win32_is_the_index_order_up_to_32():
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(512, 32)).astype(np.float32))
    for d in (1, 2, 7, 8, 31, 32):
        assert torch.equal(t_ops.sum_sq_win32(v[:, :d]), t_ops.sum_sq_seq(v[:, :d]))


@pytest.mark.parametrize("d", [48, 100])
def test_refine_and_weights_sum_in_the_reference_order_above_32(d):
    """The refine (kNN d2, hence the core distances) and the canonical edge
    weights equal the reference's bit for bit above d = 32."""
    from repro.core import rng as j_rng

    from repro_torch.core import rng as t_rng

    x = _points(300, d, seed=d)
    d_j, i_j = j_ops.knn(jnp.asarray(x), 15, backend="jnp")
    d_t, i_t = t_ops.knn(torch.from_numpy(x), 15, backend="torch")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    rng = np.random.default_rng(d + 1)
    ea = rng.integers(0, 300, 1000).astype(np.int32)
    eb = rng.integers(0, 300, 1000).astype(np.int32)
    cd2k = np.array(d_j)[:, -1]
    w_j = j_rng.canonical_edge_weights(jnp.asarray(x), jnp.asarray(cd2k), ea, eb)
    w_t = t_rng.canonical_edge_weights(torch.from_numpy(x), torch.from_numpy(cd2k), torch.from_numpy(ea),
                                       torch.from_numpy(eb))
    for a, b in zip(w_t, w_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tie_case(d: int, k_full: int):
    """Clustered points with 40 exact duplicates, the reference's kNN, and
    an unsorted edge list: kNN edges (a neighbour is an endpoint), edges
    from a point to its duplicate (d2 = 0), each point to its k-th
    neighbour (d2 equal to its core distance, so w2 ties cd2), random
    pairs, and invalid slots."""
    rng = np.random.default_rng(d + k_full)
    centers = rng.uniform(-4, 4, size=(3, d))
    x = (centers[rng.integers(0, 3, 260)] + rng.normal(0, 0.6, size=(260, d))).astype(np.float32)
    x = np.concatenate([x, x[:40]])
    n = len(x)
    d2, idx = (np.array(v) for v in j_ops.knn(jnp.asarray(x), k_full, backend="jnp"))
    rows = np.arange(n)
    pairs = np.concatenate([
        np.stack([np.repeat(rows, 3), idx[:, :3].ravel()], 1),
        np.stack([rows[:40], rows[260:]], 1),
        np.stack([rows, idx[:, -1]], 1),
        rng.integers(0, n, size=(600, 2)),
    ])
    pairs = pairs[rng.permutation(len(pairs))]
    valid = rng.random(len(pairs)) > 0.05
    return x, d2, idx, pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), valid


@pytest.mark.parametrize("backend", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("k_check", [2, 15])
@pytest.mark.parametrize("d", [48, 64])
def test_edge_cascade_plain_matches_reference_above_32(d, k_check, backend):
    """The plain cascade (own-side table, split test, windows of 32) against
    the reference's ``edge_cascade`` above d = 32, on unsorted edges with
    ties: verdicts equal, d2 and w2 bit-equal."""
    x, d2, idx, ea, eb, valid = _tie_case(d, 15)
    cd2k = d2[:, -1]
    J, t = jnp.asarray, torch.from_numpy
    out_j = j_fc.edge_cascade(J(x), J(cd2k), J(idx), J(d2), J(ea), J(eb), J(valid),
                              k_check=k_check, backend=backend)
    out_t = t_fc.edge_cascade(t(x), t(cd2k), t(idx), t(d2), t(ea), t(eb), t(valid),
                              k_check=k_check, order=t_ops.sum_order(d, "cascade"))
    killed_j, cert_j, d2_j, w2_j = (np.asarray(v) for v in out_j)
    killed_t, cert_t, d2_t, w2_t = (v.numpy() for v in out_t)
    np.testing.assert_array_equal(killed_t, killed_j)
    np.testing.assert_array_equal(cert_t, cert_j)
    np.testing.assert_array_equal(d2_t[valid], d2_j[valid])
    np.testing.assert_array_equal(w2_t[valid], w2_j[valid])
    # both verdicts occur, and the k-th-neighbour edges tie w2 with cd2
    assert killed_t.any() and cert_t.any() and (~killed_t & ~cert_t & valid).any()
    kth = (eb == idx[ea, -1]) & valid
    assert (w2_t[kth] == cd2k[ea[kth]]).any()


def test_own_table_is_the_own_half_of_each_check(blobs):
    """``own_table`` holds, per (point, slot), the own-side mrd of the
    reference's check, with the norms of the order asked for."""
    x = torch.from_numpy(blobs[0])
    d2, idx = t_ops.knn(x, 7, backend="torch")
    cd2k = d2[:, -1]
    xn, mrd_own = t_fc.own_table(x, cd2k, idx, d2, k_check=5, order="fma")
    assert mrd_own.shape == (len(x), 5)
    assert torch.equal(xn, t_ops.sum_sq_fma(x))
    c = idx[:, :5].long()
    eps = torch.tensor(t_fc._EPS, dtype=torch.float32)
    expect = torch.maximum(torch.maximum(d2[:, :5], cd2k[:, None]), cd2k[c]) + eps * (xn[:, None] + xn[c])
    assert torch.equal(mrd_own, expect)


@pytest.mark.parametrize("k_check,lanes", [(0, 1), (2, 1), (8, 1), (9, 2), (15, 2), (63, 8), (64, 8), (127, 16), (300, 32)])
def test_pick_lanes_gives_a_lane_at_most_16_checks_up_to_a_warp(k_check, lanes):
    assert t_fc.pick_lanes(k_check) == lanes


def test_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    """A tensor on any device but the CPU never reaches a plain version:
    a CUDA tensor launches the kernel, anything else raises."""
    def boom(*a, **k):
        raise AssertionError("plain version reached for a non-CPU tensor")

    monkeypatch.setattr(t_pt, "pairwise_topk_plain", boom)
    monkeypatch.setattr(t_fc, "edge_cascade_plain", boom)
    x = torch.empty((16, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_pt.pairwise_topk(x, 3)
    i = torch.empty((16,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        t_fc.edge_cascade(
            x, x[:, 0], torch.empty((16, 3), dtype=torch.int32, device="meta"),
            torch.empty((16, 3), device="meta"), i, i,
            torch.empty((16,), dtype=torch.bool, device="meta"), k_check=2,
        )


def test_edge_cascade_rejects_bad_input():
    x = torch.zeros((16, 2))
    idx = torch.zeros((16, 3), dtype=torch.int32)
    e = torch.zeros((4,), dtype=torch.int32)
    valid = torch.ones((4,), dtype=torch.bool)
    args = (x, x[:, 0], idx, x[:, :1].expand(16, 3).contiguous(), e, e, valid)
    with pytest.raises(ValueError, match="order"):
        t_fc.edge_cascade(*args, k_check=2, order="pairwise")
    with pytest.raises(ValueError, match="k_check"):
        t_fc.edge_cascade(*args, k_check=4)
    with pytest.raises(ValueError, match="valid"):
        t_fc.edge_cascade(*args[:6], valid.int(), k_check=2)
    # the launch path refuses a lane count or block size the kernel has no instance for
    with pytest.raises(ValueError, match="lanes"):
        t_fc._launch(*args, k_check=2, order="seq", block_e=256, lanes=3)
    with pytest.raises(ValueError, match="block"):
        t_fc._launch(*args, k_check=2, order="seq", block_e=100, lanes=4)
    with pytest.raises(ValueError, match="block"):
        t_fc._launch(*args, k_check=2, order="seq", block_e=512, lanes=4)


def test_pairwise_topk_rejects_bad_input():
    # the kernel's list holds 256 entries; its launch path says so before
    # it touches the card
    with pytest.raises(ValueError, match=r"at most 256 neighbours .* kmax <= 249 on the card"):
        t_pt._launch(torch.zeros((300, 2)), 257)
    with pytest.raises(ValueError, match="k_top"):
        t_pt.pairwise_topk(torch.zeros((5, 2)), 5)
    with pytest.raises(ValueError, match="float"):
        t_pt.pairwise_topk(torch.zeros((5, 2), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="shape"):
        t_pt.pairwise_topk(torch.zeros((5,)), 2)
