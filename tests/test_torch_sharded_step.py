"""The port's sharded train step (``dist.sharding`` on DTensor, the train
step, its optimizers and checkpoints on a mesh) against the JAX package's
unsharded step, on the CPU: spawned gloo worlds of 4 ranks.

One world (``WORKER``, one process a rank, one intra-op thread each, on a
``FileStore`` under ``tmp_path``; group timeout ``GROUP_TIMEOUT_S``, world
wall limit ``WORLD_TIMEOUT_S``) runs every case in turn, each on its own
mesh of the 4 ranks: the reduced model's parameters (the reference's
init, its all-zero leaves perturbed, carried across by
``params_from_jax``), optimizer states and batch placed by
``dist.sharding``'s rules, one ``train_step`` in an ``activation_context``.
Rank 0 writes the loss, grad norm, lr, the accumulated gradients (read
where the step hands them to the optimizer) and the updated parameters,
gathered whole.  While the world runs, the parent runs the JAX package's
unsharded step on the same inputs and then holds every case to it:

  * loss, ``grad_norm`` and ``lr``: relative 1e-5;
  * each gradient: relative Frobenius distance 1e-5
    (``test_torch_train_step.py``'s ``GRAD_RTOL``), 5e-5 for mamba2's
    per-head vectors and 2e-5 for griffin (the reference's jitted float32
    gradients lie that far from a float64 run: ``test_torch_ssm.py``,
    ``test_torch_griffin.py``);
  * each update: relative Frobenius distance 1e-3 (``DELTA_RTOL``) over
    the elements whose two gradients agree to 1e-3 (Adam's first step is
    about lr * sign(g), so a cancelled gradient element can flip).

The cases (two layers of each reduced model): qwen2-1.5b with the
reference test's inputs (``tests/test_distributed.py``: microbatch 2, a
batch of 8 x 32 from ``train.data``, lr 1e-3, warmup 1) on (2, 2), (1, 4)
and (4, 1), and with int8 AdamW states on (2, 2); deepseek-v2-lite on
(1, 4), its 8 experts on ``model``.  After the (2, 2) qwen2 step its state
is checkpointed (whole tensors, rank 0 writing), restored onto (1, 4) in
the same world and onto (1, 1) in a world of one rank: every tensor
bit-equal to the state saved.  mamba2, griffin and seamless on (2, 2) and
mamba2 with Adafactor on (1, 4) run in test_torch_sharded_families.py
(its per-layer (L, H) vectors are one factored matrix across the layers).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.train import data as j_data
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import get_config
from repro_torch.models import reference_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GROUP_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 140
SCALAR_RTOL = 1e-5
GRAD_RTOL = {"default": 1e-5, "mamba2_780m": 5e-5, "recurrentgemma_2b": 2e-5}
DELTA_RTOL = 1e-3

# name -> (arch, mesh, optimizer, state dtype, microbatch); this file runs
# the transformers' (``STEP_CASES``), test_torch_sharded_families.py the
# other families' in a world of its own (``FAMILY_CASES``): each file stays
# well inside its time on one test worker
CASES = {
    "qwen2_2x2": ("qwen2_1_5b", (2, 2), "adamw", "float32", 2),
    "qwen2_1x4": ("qwen2_1_5b", (1, 4), "adamw", "float32", 2),
    "qwen2_4x1": ("qwen2_1_5b", (4, 1), "adamw", "float32", 2),
    "deepseek_1x4": ("deepseek_v2_lite_16b", (1, 4), "adamw", "float32", 1),
    "deepseek_1x4_data": ("deepseek_v2_lite_16b", (1, 4), "adamw", "float32", 1),
    "mamba2_2x2": ("mamba2_780m", (2, 2), "adamw", "float32", 1),
    "griffin_2x2": ("recurrentgemma_2b", (2, 2), "adamw", "float32", 1),
    "seamless_2x2": ("seamless_m4t_large_v2", (2, 2), "adamw", "float32", 1),
    "qwen2_int8_2x2": ("qwen2_1_5b", (2, 2), "adamw", "int8", 2),
    "mamba2_adafactor_1x4": ("mamba2_780m", (1, 4), "adafactor", "float32", 1),
}
FAMILY_CASES = ("mamba2_2x2", "griffin_2x2", "seamless_2x2", "mamba2_adafactor_1x4")
STEP_CASES = tuple(c for c in CASES if c not in FAMILY_CASES)
CKPT_CASE = "qwen2_2x2"
BATCH, SEQ = 8, 32
# MoE routing is discontinuous: where two gates lie within rounding of each
# other, the sharded sums (other orders) can send a token to another expert.
# On train.data's 8 x 32 batch that happens at layer 1 of the reduced
# deepseek (its inputs within 2.4e-6 of the unsharded ones, one token routed
# elsewhere, the loss 1.2e-4 apart), so deepseek is held in full on
# test_torch_moe.py's batch (4 x 12 random tokens, one mask entry zero) and
# on train.data's batch only as the reference's own sharded test holds its
# step (tests/test_distributed.py: loss within 5e-3 relative).
MOE_BATCH_CASES = {"deepseek_1x4"}
LOSS_ONLY = {"deepseek_1x4_data": 5e-3}

WORKER = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world, store, spec, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=%(timeout)d))
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import param_specs, params_from_jax, reference_leaves
    from repro_torch.train import checkpoint as ckpt, optim, step as step_lib

    def whole(t):
        # a copy: a replicated DTensor's full_tensor() is its local tensor, which the update clips in place
        return (t.full_tensor() if isinstance(t, torch.distributed.tensor.DTensor) else t).detach().clone()

    def placed(cfg, mesh):
        rules = sh.resolve_rules(mesh)
        p_shard = sh.tree_shardings(param_specs(cfg), mesh, rules)
        layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}
        return rules, p_shard, layouts

    with open(spec) as f:
        job = json.load(f)
    for name, case in job["cases"].items():
        cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["cfg"])
        mesh = make_mesh_compat(case["mesh"], ("data", "model"), device="cpu")
        rules, p_shard, layouts = placed(cfg, mesh)
        with np.load(f"{tmp}/{case['arch']}_params.npz") as z:
            tree = ckpt._unflatten({k: z[k] for k in z.files})
        params = sh.distribute_module(params_from_jax(cfg, tree, device="cpu"), p_shard)
        ocfg = optim.OptConfig(name=case["opt"], lr=1e-3, warmup_steps=1, total_steps=10, state_dtype=case["state"])
        state = optim.make_optimizer(ocfg, cfg)[0](params)
        state = sh.distribute(state, sh.opt_state_shardings(p_shard, state, mesh, layouts))
        with np.load(f"{tmp}/{name}_batch.npz") as z:
            batch = {k: torch.from_numpy(z[k]) for k in z.files}
        batch = sh.distribute(batch, sh.batch_shardings(batch, mesh))
        grads = {}

        def recording(ocfg, cfg, make=optim.make_optimizer):
            init, update = make(ocfg, cfg)

            def update_and_record(params, g, state):  # the accumulated gradients, as the step hands them on
                grads.update({k: whole(v) for k, v in g.items()})
                return update(params, g, state)

            return init, update_and_record

        optim.make_optimizer = recording
        step = step_lib.make_train_step(cfg, ocfg)
        optim.make_optimizer = recording.__defaults__[0]
        with sh.activation_context(mesh, rules):
            _, _, m = step(params, state, batch)
        out = {f"g/{k}": v.numpy() for k, v in grads.items()}
        out.update({f"p/{k}": whole(v).numpy() for k, v in params.named_parameters()})
        out.update({k: np.asarray(float(m[k])) for k in ("loss", "grad_norm", "lr")})
        if name == job["ckpt_case"]:
            snapshot = {"params": dict(params.named_parameters()), "opt": state}
            ckpt.save(f"{tmp}/ckpt", 1, snapshot)
            saved = {k: whole(v) for k, v in ckpt._flatten(snapshot).items()}
            dist.barrier()
            other = make_mesh_compat((1, world), ("data", "model"), device="cpu")
            _, o_shard, _ = placed(cfg, other)
            o_state = sh.opt_state_shardings(o_shard, state, other, layouts)
            back, step_no = ckpt.restore(f"{tmp}/ckpt", shardings={"params": o_shard, "opt": o_state})
            flat = ckpt._flatten(back)
            out["ckpt_step"] = np.asarray(step_no)
            out["ckpt_keys"] = np.asarray(sorted(flat) == sorted(saved))
            out["ckpt_placed"] = np.asarray(all(isinstance(v, torch.distributed.tensor.DTensor) for v in flat.values()))
            out["ckpt_equal"] = np.asarray(all(torch.equal(whole(flat[k]), saved[k]) for k in saved))
            out["ckpt_sharded"] = np.asarray(any(
                any(isinstance(p, torch.distributed.tensor.Shard) for p in flat[k].placements) for k in flat))
        if rank == 0:
            np.savez(f"{tmp}/{name}_out.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
""") % {"timeout": GROUP_TIMEOUT_S}

# depth of each case's model: two layers (one + one for the encoder-decoder);
# griffin keeps its reduced four, one (R, R, A) period and an R
DEPTH = {"qwen2_1_5b": {"n_layers": 2}, "deepseek_v2_lite_16b": {"n_layers": 2}, "mamba2_780m": {"n_layers": 2},
         "recurrentgemma_2b": {}, "seamless_m4t_large_v2": {"n_enc_layers": 1, "n_dec_layers": 1}}


def _cfg(case):
    arch, _, _, _, micro = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), microbatch=micro, **DEPTH[arch])


def _jcfg(cfg, arch):
    return dataclasses.replace(j_get_config(arch), **dataclasses.asdict(cfg))


def _ref_params(cfg, arch):
    """The reference's init with its all-zero leaves perturbed; numpy."""
    params = jax.jit(lambda key: j_init_params(_jcfg(cfg, arch), key)[0])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(100)

    def perturb(a):
        a = np.asarray(a)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree.map(perturb, params)


def _batch(cfg, case: str) -> dict:
    """The reference test's batch (``train.data``, seed 0, 8 x 32); the
    encoder-decoder's decoder rows over 16 frames of their own; for
    ``MOE_BATCH_CASES`` test_torch_moe.py's (4 x 12, seed 0)."""
    if case in MOE_BATCH_CASES:
        rng = np.random.default_rng(0)
        mask = np.ones((4, 12), np.float32)
        mask[1, 3] = 0.0
        return {"tokens": rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32), "mask": mask}
    dcfg = j_data.DataConfig(seed=0, vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    batch = {k: np.asarray(v) for k, v in j_data.train_batch(dcfg, 0).items()}
    if cfg.arch == "encdec":
        rng = np.random.default_rng(7)
        batch = {"dec_" + k: v for k, v in batch.items()}
        batch["frames"] = rng.normal(size=(BATCH, 16, cfg.frontend_dim)).astype(np.float32)
    return batch


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port_view(cfg, tree, name):
    leaf = reference_leaves(cfg)[name]
    a = tree
    for key in leaf.path:
        a = a[key]
    a = np.asarray(a, np.float32)
    a = a[leaf.layer] if leaf.layer is not None else a
    return a.T if leaf.transposed else a


def _references(trees, batches) -> dict:
    """The JAX package's unsharded step for every case: the loss and the
    gradients of the mean of the slices' losses (jitted once a model and
    batch), then its optimizer's update on them (once an optimizer): loss,
    grad_norm, lr, gradients and the parameters after."""
    grads, out = {}, {}
    for case in batches:
        arch, _, opt, state, micro = CASES[case]
        cfg = _cfg(case)
        jcfg = _jcfg(cfg, arch)
        jp = jax.tree.map(jnp.asarray, trees[arch])
        key = (arch, case in MOE_BATCH_CASES or case in LOSS_ONLY and case)
        if key not in grads:
            jb = {k: jnp.asarray(v) for k, v in batches[case].items()}
            per = next(iter(batches[case].values())).shape[0] // micro
            slices = [slice(i * per, (i + 1) * per) for i in range(micro)]
            loss_fn = j_step.make_loss_fn(jcfg)
            mean = jax.jit(jax.value_and_grad(
                lambda p: sum(loss_fn(p, {k: v[s] for k, v in jb.items()})[0] for s in slices) / micro))
            grads[key] = mean(jp)
        loss, g = grads[key]
        j_ocfg = j_optim.OptConfig(name=opt, lr=1e-3, warmup_steps=1, total_steps=10, state_dtype=state)
        j_init, j_update = j_optim.make_optimizer(j_ocfg)
        after, _, m = jax.jit(j_update)(jp, g, j_init(jp))
        out[case] = {"loss": float(loss), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                     "grads": jax.tree.map(np.asarray, g), "after": jax.tree.map(np.asarray, after)}
    return out


def _spawn(code: str, args_for_rank, tmp, n: int):
    # gloo's pairs connect over the loopback device: no other network is needed
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    env.pop("JAX_PLATFORMS", None)
    return [subprocess.Popen([sys.executable, "-c", code, *args_for_rank(r)], env=env, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]


def _wait(procs, what: str) -> None:
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
        assert p.returncode == 0, f"{what}: rank {r} exited {p.returncode}:\n{log[-4000:]}"


RESTORE_ONE = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store, tmp, spec = sys.argv[1], sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=%(timeout)d))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import abstract_init, param_specs, reference_leaves
    from repro_torch.train import checkpoint as ckpt, optim

    with open(spec) as f:
        job = json.load(f)
    case = job["cases"][job["ckpt_case"]]
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(), **case["cfg"])
    mesh = make_host_mesh(device="cpu")
    rules = sh.resolve_rules(mesh)
    p_shard = sh.tree_shardings(param_specs(cfg), mesh, rules)
    layouts = {n: leaf.transposed for n, leaf in reference_leaves(cfg).items()}
    ocfg = optim.OptConfig(name=case["opt"], state_dtype=case["state"])
    like = optim.make_optimizer(ocfg, cfg)[0](abstract_init(cfg))
    back, _ = ckpt.restore(f"{tmp}/ckpt", shardings={"params": p_shard,
                                                     "opt": sh.opt_state_shardings(p_shard, like, mesh, layouts)})
    flat = ckpt._flatten(back)
    assert all(isinstance(v, torch.distributed.tensor.DTensor) for v in flat.values())
    np.savez(f"{tmp}/restored_one.npz", **{k: v.full_tensor().view(torch.int16).numpy()
                                          if v.dtype == torch.bfloat16 else v.full_tensor().numpy()
                                          for k, v in flat.items()})
    dist.destroy_process_group()
""") % {"timeout": GROUP_TIMEOUT_S}


def run_cases(names, tmp) -> tuple[dict, dict, dict]:
    """Run ``names`` in one world of ``WORLD`` ranks while the parent
    computes the reference's steps; with ``CKPT_CASE`` among them, restore
    its checkpoint in a world of one too.  Returns (case -> the world's
    arrays, case -> the reference's step, arch -> parameters before)."""
    trees, batches, job = {}, {}, {"cases": {}, "ckpt_case": CKPT_CASE}
    for case in names:
        arch, mesh, opt, state, micro = CASES[case]
        cfg = _cfg(case)
        if arch not in trees:
            trees[arch] = _ref_params(cfg, arch)
            np.savez(tmp / f"{arch}_params.npz", **_flat(trees[arch]))
        batches[case] = _batch(cfg, case)
        np.savez(tmp / f"{case}_batch.npz", **batches[case])
        job["cases"][case] = {"arch": arch, "mesh": list(mesh), "opt": opt, "state": state,
                              "cfg": {"microbatch": micro, **DEPTH[arch]}}
    spec = tmp / "job.json"
    spec.write_text(json.dumps(job))
    procs = _spawn(WORKER, lambda r: [str(r), str(WORLD), str(tmp / "store"), str(spec), str(tmp)], tmp, WORLD)
    try:
        want = _references(trees, batches)
    finally:
        _wait(procs, f"the world of {WORLD}")
    got = {}
    for case in names:
        with np.load(tmp / f"{case}_out.npz") as z:
            got[case] = {k: z[k] for k in z.files}
    if CKPT_CASE in names:
        _wait(_spawn(RESTORE_ONE, lambda r: [str(tmp / "store1"), str(tmp), str(spec)], tmp, 1), "the world of 1")
        with np.load(tmp / "restored_one.npz") as z:
            got["restored_one"] = {k: z[k] for k in z.files}
    return got, want, trees


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(STEP_CASES, tmp_path_factory.mktemp("sharded"))


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_the_reference_unsharded_step(results, case):
    check_case(results, case)


def check_case(results, case: str) -> None:
    """One case's world against the reference's unsharded step, to the
    module's tolerances."""
    got, want, trees = results
    g, w = got[case], want[case]
    arch = CASES[case][0]
    cfg = _cfg(case)
    if case in LOSS_ONLY:
        assert _rel(g["loss"], w["loss"]) <= LOSS_ONLY[case], (float(g["loss"]), w["loss"])
        assert all(np.isfinite(v).all() for v in g.values())
        return
    for key in ("loss", "grad_norm", "lr"):
        assert _rel(g[key], w[key]) <= SCALAR_RTOL, (key, float(g[key]), w[key])
    grad_tol = GRAD_RTOL.get(arch, GRAD_RTOL["default"])
    names = [k[2:] for k in g if k.startswith("p/")]
    assert names == list(reference_leaves(cfg))
    excluded, total = 0, 0
    for name in names:
        gj = _port_view(cfg, w["grads"], name)
        assert _rel_fro(g[f"g/{name}"], gj) <= grad_tol, (name, _rel_fro(g[f"g/{name}"], gj))
        before = _port_view(cfg, trees[arch], name).astype(np.float64)
        d_t = g[f"p/{name}"] - before
        d_j = _port_view(cfg, w["after"], name) - before
        well = np.abs(g[f"g/{name}"] - gj) <= 1e-3 * np.abs(gj)
        excluded += int((~well).sum())
        total += gj.size
        assert np.isfinite(d_t).all(), name
        assert _rel_fro(d_t[well], d_j[well]) <= DELTA_RTOL, (name, _rel_fro(d_t[well], d_j[well]))
    assert excluded <= 1e-2 * total, excluded


def test_checkpoint_moves_between_meshes_bit_for_bit(results):
    """Saved on (2, 2) (whole tensors, rank 0 writing), restored onto
    (1, 4): placed, sharded and equal; onto (1, 1) in a world of one:
    equal, bit for bit."""
    got = results[0]
    g = got[CKPT_CASE]
    assert int(g["ckpt_step"]) == 1
    assert bool(g["ckpt_keys"]) and bool(g["ckpt_placed"]) and bool(g["ckpt_sharded"]) and bool(g["ckpt_equal"])
    one = got["restored_one"]
    for name in reference_leaves(_cfg(CKPT_CASE)):
        np.testing.assert_array_equal(one[f"params/{name}"], g[f"p/{name}"])
    assert {k.split("/")[0] for k in one} == {"params", "opt"}
