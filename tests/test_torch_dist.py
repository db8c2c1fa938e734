"""The port's multi-GPU clustering path (``dist.cluster_parallel``,
``launch.mesh``, the Plan's mesh placement) against the JAX package, on
the CPU: gloo process groups of 4 and of 3 ranks.

Each world is one set of spawned processes (``WORKER``, one process a
rank, one intra-op thread each) on a ``FileStore`` under ``tmp_path``,
every group with a timeout of ``GROUP_TIMEOUT_S`` and the whole world
with a wall limit of ``WORLD_TIMEOUT_S``, so a hung collective fails the
test instead of hanging the suite.  The parent draws the inputs, runs the
JAX package in process and holds every rank's outputs to it:

  * ``ring_knn`` to the reference test's own tolerances against
    ``repro.kernels.ops.knn(backend="jnp", refine_slack=0)`` (d2 rtol
    2e-3, atol 1e-5; over 99.9% of indices equal), and the refined kNN
    (``ops.knn(backend="mesh")``) bit-equal to the reference's;
  * ``ring_lune_count`` equal to ``repro.kernels.ref.lune_filter_ref``;
  * ``sharded_mst_range`` equal to ``repro.core.boruvka.boruvka_mst_range``
    with R not a multiple of the world;
  * the mesh fit (RNG* and exact) on ``test_mesh_pipeline_matches_dualtree_tier``'s
    points, equal on every rank and to the JAX package's single-device
    fit: kNN, graph edges, MST ids, ``mst_w`` and labels bit for bit;
  * the reference's ``resolve_plan`` rules.

The ring cases' row count is ragged: 241 rows pad to 244 over 4 ranks and
to 243 over 3.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import MultiHDBSCAN as JEst
from repro.core import boruvka as j_boruvka
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (4, 3)
GROUP_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 150
N_RING, D_RING, K_RING = 241, 5, 7
N_FIT, D_FIT, KMAX_FIT = 1536, 6, 8  # test_distributed.py::test_mesh_pipeline_matches_dualtree_tier's
R_MST = 7

WORKER = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, inputs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=%(timeout)d))
    import dataclasses
    from repro_torch import engine
    from repro_torch.api import MultiHDBSCAN
    from repro_torch.dist import cluster_parallel as cp
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as t_mesh

    z = np.load(inputs)
    mesh = t_mesh.make_host_mesh(device="cpu")
    res = {}
    # ring_knn over the padded, sharded rows; every rank gathers the whole
    x = torch.from_numpy(z["x"])
    n = x.shape[0]
    x_loc = cp.shard_rows(cp.pad_rows(x, world), mesh)
    d2, idx = cp.ring_knn(x_loc, int(z["k"]), mesh, n_valid=n)
    for name, t in (("ring_d2", d2), ("ring_idx", idx)):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=mesh.get_group("data"))
        res[name] = torch.cat(parts)[:n].numpy()
    res["knn_d2"], res["knn_idx"] = (t.numpy() for t in ops.knn(x, int(z["k"]), backend="mesh", mesh=mesh))
    # the lune scan and the Borůvka rows
    cd2 = torch.from_numpy(z["cd2"])
    ea, eb, w2 = (torch.from_numpy(z[k]) for k in ("ea", "eb", "w2"))
    cd2_loc = cp.shard_rows(cp.pad_rows(cd2, world), mesh)
    res["lune"] = cp.ring_lune_count(x_loc, cd2_loc, ea, eb, w2, mesh, n_valid=n).numpy()
    res["lune_ops"] = ops.lune_nonempty(ea, eb, w2, x, cd2, backend="mesh", mesh=mesh).numpy()
    res["in_mst"] = cp.sharded_mst_range(torch.from_numpy(z["mst_ea"]), torch.from_numpy(z["mst_eb"]),
                                         torch.from_numpy(z["w_range"]), n=n, mesh=mesh).numpy()
    res["replicated"] = cp.replicate(torch.full((3,), float(rank)), mesh).numpy()
    # the mesh fits
    xf = z["x_fit"]
    for variant in ("rng_star", "rng"):
        est = MultiHDBSCAN(kmax=int(z["kmax"]), variant=variant, device="cpu", mesh=mesh).fit(xf)
        m = est.model_.msts
        res[f"{variant}_sharded"] = np.array([est.plan_.sharded, est.plan_.n_shards])
        res[f"{variant}_knn_idx"], res[f"{variant}_knn_d2"] = m.knn_idx, m.knn_d2
        res[f"{variant}_edges"] = est.graph_.edges
        res[f"{variant}_mst_ea"], res[f"{variant}_mst_eb"], res[f"{variant}_mst_w"] = m.mst_ea, m.mst_eb, m.mst_w
        res[f"{variant}_labels"] = np.stack([v.labels for v in est.select_all()])
    # the reference's resolve_plan rules
    rules = {}

    def outcome(fn):
        try:
            p = fn()
        except ValueError:
            return "ValueError"
        return p.describe() if p.sharded else "single"

    cpu = dict(device="cpu")
    rules["auto"] = outcome(lambda: engine.resolve_plan(mesh=mesh, **cpu))
    rules["single"] = outcome(lambda: engine.resolve_plan("single", mesh=mesh, **cpu))
    rules["mesh"] = outcome(lambda: engine.resolve_plan("mesh", mesh=mesh, **cpu))
    rules["auto_model_axis"] = outcome(lambda: engine.resolve_plan(mesh=mesh, axis="model", **cpu))
    rules["mesh_model_axis"] = outcome(lambda: engine.resolve_plan("mesh", mesh=mesh, axis="model", **cpu))
    narrow = t_mesh.make_host_mesh(model_axis=world, device="cpu")  # a one-rank data axis
    rules["auto_one_rank"] = outcome(lambda: engine.resolve_plan(mesh=narrow, **cpu))
    rules["mesh_one_rank"] = outcome(lambda: engine.resolve_plan("mesh", mesh=narrow, **cpu))
    rules["mesh_none"] = outcome(lambda: engine.resolve_plan("mesh", **cpu))
    built = engine.resolve_plan(mesh=mesh, **cpu)
    rules["prebuilt_same_mesh"] = engine.resolve_plan(built, mesh=mesh) is built
    rules["prebuilt_other_mesh"] = outcome(lambda: engine.resolve_plan(built, mesh=narrow))
    rules["card_plan_on_a_cpu_mesh"] = outcome(lambda: engine.Plan(backend="cuda", device="cuda", mesh=mesh))
    one = dataclasses.replace(engine.resolve_plan(**cpu), mesh=narrow, axis="data")
    rules["replaced_one_rank"] = [one.sharded, one.n_shards]
    rules["n_shards"] = built.n_shards
    np.savez(out, **res)
    with open(out + ".json", "w") as f:
        json.dump(rules, f)
    dist.barrier()
    dist.destroy_process_group()
""") % {"timeout": GROUP_TIMEOUT_S}


def _inputs(world: int):
    """The ring cases' and the fit's inputs and the JAX package's answers."""
    rng = np.random.default_rng(world)
    x = rng.normal(size=(N_RING, D_RING)).astype(np.float32)
    jx = jnp.asarray(x)
    d2, idx = j_ops.knn(jx, K_RING - 1, backend="jnp")
    cd2 = np.asarray(d2[:, 4])
    near = np.asarray(idx[:, 0])
    ea = np.concatenate([rng.integers(0, N_RING, 64), np.arange(0, N_RING, 4)]).astype(np.int32)
    eb = np.concatenate([rng.integers(0, N_RING, 64), near[::4]]).astype(np.int32)
    d2ab = np.sum((x[ea] - x[eb]) ** 2, -1)
    w2 = np.maximum(np.maximum(cd2[ea], cd2[eb]), d2ab).astype(np.float32)
    # a connected edge list (a random tree plus extras), R rows of weights with ties
    parent = np.array([rng.integers(0, i) for i in range(1, N_RING)])
    extra = rng.integers(0, N_RING, (3 * N_RING, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    mst_ea = np.concatenate([np.arange(1, N_RING), extra[:, 0]]).astype(np.int32)
    mst_eb = np.concatenate([parent, extra[:, 1]]).astype(np.int32)
    w_range = rng.integers(0, 400, (R_MST, len(mst_ea))).astype(np.float32)
    rng_fit = np.random.default_rng(5)  # the reference test's points
    c = rng_fit.uniform(-10, 10, size=(6, D_FIT))
    x_fit = (c[rng_fit.integers(0, 6, N_FIT)] + rng_fit.normal(0, 1.0, size=(N_FIT, D_FIT))).astype(np.float32)
    inputs = dict(x=x, k=K_RING, cd2=cd2, ea=ea, eb=eb, w2=w2, mst_ea=mst_ea, mst_eb=mst_eb, w_range=w_range,
                  x_fit=x_fit, kmax=KMAX_FIT)
    want = {
        "knn_raw": j_ops.knn(jx, K_RING, backend="jnp", refine_slack=0),
        "knn": j_ops.knn(jx, K_RING, backend="jnp"),
        "lune": j_ref.lune_filter_ref(jx[ea], jx[eb], jnp.asarray(cd2[ea]), jnp.asarray(cd2[eb]), jnp.asarray(ea),
                                      jnp.asarray(eb), jnp.asarray(w2), jx, jnp.asarray(cd2)),
        "in_mst": j_boruvka.boruvka_mst_range(jnp.asarray(mst_ea), jnp.asarray(mst_eb), jnp.asarray(w_range),
                                              n=N_RING),
    }
    for variant in ("rng_star", "rng"):
        est = JEst(kmax=KMAX_FIT, variant=variant, plan="single").fit(x_fit)
        m = est.model_.msts
        want[variant] = dict(knn_idx=m.knn_idx, knn_d2=m.knn_d2, edges=est.graph_.edges, mst_ea=m.mst_ea,
                             mst_eb=m.mst_eb, mst_w=m.mst_w, labels=np.stack([v.labels for v in est.select_all()]))
    return inputs, jax.tree.map(np.asarray, want)


def _run_world(world: int, tmp) -> list:
    """Start ``world`` ranks at once and wait for all of them, within
    ``WORLD_TIMEOUT_S``; returns each rank's (arrays, rules)."""
    # gloo's pairs connect over the loopback device: no other network is needed
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    store, outs = str(tmp / "store"), [str(tmp / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), store, str(tmp / "in.npz"), outs[r]],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}"
    results = []
    for out in outs:
        with np.load(out) as z:
            arrays = {k: z[k] for k in z.files}
        with open(out + ".json") as f:
            results.append((arrays, json.load(f)))
    return results


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, tmp_path_factory):
    """(world size, inputs, the JAX package's answers, every rank's results)."""
    w = request.param
    tmp = tmp_path_factory.mktemp(f"world{w}")
    inputs, want = _inputs(w)
    np.savez(tmp / "in.npz", **inputs)
    return w, inputs, want, _run_world(w, tmp)


def test_ring_knn_matches_the_reference(world):
    """The raw ring lists to the reference test's tolerances; the refined
    kNN bit-equal on every rank."""
    w, _, want, results = world
    d2_ref, idx_ref = want["knn_raw"]
    for arrays, _ in results:
        np.testing.assert_allclose(arrays["ring_d2"], d2_ref, rtol=2e-3, atol=1e-5)
        assert (arrays["ring_idx"] == idx_ref).mean() > 0.999
        np.testing.assert_array_equal(arrays["knn_idx"], want["knn"][1])
        np.testing.assert_array_equal(arrays["knn_d2"].view(np.int32), want["knn"][0].view(np.int32))
        assert not (arrays["ring_idx"] >= N_RING).any()  # padding is never a neighbour
    assert (N_RING % w) != 0  # ragged


def test_ring_lune_count_equals_the_reference(world):
    _, _, want, results = world
    assert 0 < want["lune"].sum() < len(want["lune"])  # both verdicts occur
    for arrays, _ in results:
        np.testing.assert_array_equal(arrays["lune"], want["lune"])
        np.testing.assert_array_equal(arrays["lune_ops"], want["lune"])


def test_sharded_mst_range_equals_the_reference(world):
    w, _, want, results = world
    assert R_MST % w != 0
    assert (want["in_mst"].sum(1) == N_RING - 1).all()
    for arrays, _ in results:
        np.testing.assert_array_equal(arrays["in_mst"], want["in_mst"])


def test_replicate_broadcasts_the_first_rank(world):
    for arrays, _ in world[3]:
        np.testing.assert_array_equal(arrays["replicated"], np.zeros(3, np.float32))


@pytest.mark.parametrize("variant", ["rng_star", "rng"])
def test_mesh_fit_equals_the_reference_single_device_fit(world, variant):
    """``MultiHDBSCAN(mesh=...)`` shards (n_shards = world) and equals the
    JAX package's single-device fit bit for bit on every rank."""
    w, _, want, results = world
    ref = want[variant]
    for arrays, _ in results:
        assert arrays[f"{variant}_sharded"].tolist() == [1, w]
        for key in ("knn_idx", "edges", "mst_ea", "mst_eb", "labels"):
            np.testing.assert_array_equal(arrays[f"{variant}_{key}"], ref[key], err_msg=key)
        for key in ("knn_d2", "mst_w"):
            np.testing.assert_array_equal(arrays[f"{variant}_{key}"].view(np.int32), ref[key].view(np.int32),
                                          err_msg=key)
    assert (ref["labels"] >= 0).any()


def test_resolve_plan_follows_the_reference_rules(world):
    w, _, _, results = world
    expected = {
        "auto": f"Plan(backend='torch', device='cpu', placement=mesh[data={w}])",
        "single": "single",
        "mesh": f"Plan(backend='torch', device='cpu', placement=mesh[data={w}])",
        "auto_model_axis": "single",
        "mesh_model_axis": "ValueError",
        "auto_one_rank": "single",
        "mesh_one_rank": "ValueError",
        "mesh_none": "ValueError",
        "prebuilt_same_mesh": True,
        "prebuilt_other_mesh": "ValueError",
        "card_plan_on_a_cpu_mesh": "ValueError",
        "replaced_one_rank": [True, 1],
        "n_shards": w,
    }
    for _, rules in results:
        assert rules == expected
