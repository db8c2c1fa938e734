"""The port's optimizers, checkpoints, metrics and launcher against the JAX
package, on the CPU.

Weights come from the reference's init (zero norms and biases perturbed,
so decay and the factored moments see them) and cross with
``repro_torch.models.params_from_jax``; gradients are the same numpy
arrays, laid out per reference leaf and sliced for the port with
``models.reference_leaves``.  Everything runs in float32.

Tolerances, over 3 updates on the same gradients:
  * ``lr`` and ``grad_norm``: relative 1e-5.  The schedule is the same
    float32 arithmetic; the norm sums the same squares in another order
    (per port tensor, not per stacked leaf), a few float32 roundings;
  * parameters: each tensor's update Δ to relative Frobenius distance
    1e-5.  The inputs are bit-equal, so Δ differs only by the last bits of
    ``sqrt`` (PyTorch's vectorised CPU sqrt is not correctly rounded),
    of ``pow`` in the bias corrections and of the clip scale.  With
    bfloat16 states 1e-3: a moment that rounds to the neighbouring
    bfloat16 value (below) moves its element's later updates by up to
    2^-8 of themselves;
  * float32 moments to relative Frobenius 1e-5, for the same reason;
    bfloat16 moments to one bfloat16 step per element (their bits differ by
    at most 1): a float32 value a few ulps from a rounding boundary may
    round either way;
  * int8 states: ``q`` within one quantisation step and ``scale`` to
    relative 1e-6 (the block maxima are the same float32 values up to the
    last bit);
  * the preempted-and-resumed run equals the straight run bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.train import checkpoint as j_ckpt
from repro.train import optim as j_optim

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import params_from_jax, reference_leaves
from repro_torch.models import transformer as t_tf
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import metrics as t_metrics
from repro_torch.train import optim as t_optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher's runs: one thread each, as this module's own (they share the
# CPU with the other test workers; MKL's sums are reproducible at a fixed count)
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
SCALAR_RTOL = 1e-5
DELTA_RTOL = 1e-5
BF16_DELTA_RTOL = 1e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs (the other
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(cfg):
    """The reference's ``ModelConfig`` with the port config's fields."""
    arch = next(a for a in ARCH_IDS if get_config(a).name == cfg.name)
    return dataclasses.replace(j_get_config(arch), **dataclasses.asdict(cfg))


def _ref_params(cfg, seed: int = 0):
    """The reference's init with its zero leaves perturbed; numpy pytree."""
    params, _ = j_init_params(_jcfg(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.asarray(a)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree.map(perturb, params)


def _at(tree, path):
    """The reference pytree's node at ``path`` (a leaf, or an int8 state's
    {"q", "scale"} dict)."""
    for key in path:
        tree = tree[key]
    return tree


def _port_slices(cfg, tree) -> dict:
    """name -> the reference tree's slice for that port tensor, in the
    port's layout (numpy)."""
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        a = np.asarray(_at(tree, leaf.path))
        a = a[leaf.layer] if leaf.layer is not None else a
        out[name] = np.ascontiguousarray(a.T if leaf.transposed else a)
    return out


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _model_cfg(d_model=None):
    cfg = get_config("qwen2_1_5b").reduced()
    if d_model:
        cfg = dataclasses.replace(cfg, d_model=d_model)
    return cfg


def _run_both(cfg, ocfg, grads_seq, tree):
    """STEPS updates of the reference and the port on the same grads;
    returns (reference params, reference state, reference metrics, port
    params, port state, port metrics)."""
    j_init, j_update = j_optim.make_optimizer(ocfg)
    jp = jax.tree.map(jnp.asarray, tree)
    js = j_init(jp)
    j_update = jax.jit(j_update)
    t_init, t_update = t_optim.make_optimizer(ocfg, cfg)
    tp = params_from_jax(cfg, tree, device="cpu")
    ts = t_init(tp)
    jm = tm = None
    for g in grads_seq:
        jp, js, jm = j_update(jp, jax.tree.map(jnp.asarray, g), js)
        grads = {k: torch.from_numpy(v) for k, v in _port_slices(cfg, g).items()}
        tp2, ts2, tm = t_update(tp, grads, ts)
        assert tp2 is tp and ts2 is ts  # updated in place
    return jax.tree.map(np.asarray, jp), js, jm, tp, ts, tm


def _grads(tree, seed: int, n: int = STEPS):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * 0.05).astype(np.float32), tree)
            for _ in range(n)]


def _check_params(cfg, tree, jp, tp, rtol=DELTA_RTOL):
    before = _port_slices(cfg, tree)
    after = _port_slices(cfg, jp)
    for name, p in tp.named_parameters():
        d_t = p.detach().numpy().astype(np.float64) - before[name]
        d_j = after[name].astype(np.float64) - before[name]
        assert _rel_fro(d_t, d_j) <= rtol, f"{name}: update differs by {_rel_fro(d_t, d_j)}"


def _check_scalars(jm, tm):
    for key in ("lr", "grad_norm"):
        want = float(jm[key])
        assert abs(float(tm[key]) - want) <= SCALAR_RTOL * abs(want), (key, float(tm[key]), want)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def test_reference_leaves_map_every_tensor():
    """Each port tensor is its reference leaf's slice: shapes, layers and
    the (in, out) transpose, for every dense config's parameters."""
    for arch in ("qwen2_1_5b", "qwen2_5_14b", "gemma3_4b", "starcoder2_3b"):
        cfg = get_config(arch).reduced()
        tree = _ref_params(cfg)
        leaves = reference_leaves(cfg)
        tp = params_from_jax(cfg, tree, device="cpu")
        assert list(leaves) == [n for n, _ in tp.named_parameters()]
        n_ref = sum(int(np.asarray(a).size) for a in jax.tree.leaves(tree))
        assert sum(p.numel() for p in tp.parameters()) == n_ref
        slices = _port_slices(cfg, tree)
        for name, p in tp.named_parameters():
            leaf = leaves[name]
            assert np.shape(_at(tree, leaf.path)) == leaf.shape, name
            np.testing.assert_array_equal(p.detach().numpy(), slices[name], err_msg=name)
            assert p.requires_grad, name
    assert leaves["layers.1.attn.wq.weight"].path == ("layers", "attn", "wq")
    assert leaves["layers.1.mlp.wo.bias"].path == ("layers", "mlp", "bo")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_the_reference(state_dtype):
    """Three AdamW updates, d_model = 48: the reference's wq (48, 64) is
    q8-compatible although the port's (64, 48) is not, and its wo (64, 48)
    and the embeddings are not though the port's wo is, so rule (b) is
    read off the reference leaf."""
    cfg = _model_cfg(d_model=48)
    tree = _ref_params(cfg)
    ocfg = j_optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    ocfg_t = t_optim.OptConfig(**dataclasses.asdict(ocfg))
    jp, js, jm, tp, ts, tm = _run_both(cfg, ocfg_t, _grads(tree, 1), tree)
    _check_scalars(jm, tm)
    _check_params(cfg, tree, jp, tp, rtol=BF16_DELTA_RTOL if state_dtype == "bfloat16" else DELTA_RTOL)
    assert int(ts["step"]) == int(js["step"]) == STEPS and ts["step"].dtype == torch.int32
    leaves = reference_leaves(cfg)
    for moment in ("m", "v"):
        for name, st in ts[moment].items():
            leaf = leaves[name]
            ref = _at(js[moment], leaf.path)
            if isinstance(ref, dict):  # int8 blocks, in the reference slice's layout
                q_j, s_j = (np.asarray(ref[k]) for k in ("q", "scale"))
                if leaf.layer is not None:
                    q_j, s_j = q_j[leaf.layer], s_j[leaf.layer]
                assert t_optim._is_q8(st) and st["q"].shape == q_j.shape and st["scale"].shape == s_j.shape, name
                assert int(np.max(np.abs(st["q"].numpy().astype(np.int32) - q_j.astype(np.int32)))) <= 1, name
                np.testing.assert_allclose(st["scale"].numpy(), s_j, rtol=1e-6, atol=0, err_msg=name)
                continue
            want = np.asarray(ref, np.float32)
            want = want[leaf.layer] if leaf.layer is not None else want
            want = want.T if leaf.transposed else want
            assert st.shape == want.shape, name
            assert st.dtype == (torch.float32 if state_dtype == "float32" else torch.bfloat16), (name, st.dtype)
            if state_dtype == "float32":
                assert _rel_fro(st.numpy(), want) <= DELTA_RTOL, (moment, name)
            else:  # within one bfloat16 step: their bits, as integers, differ by at most 1
                bits_t = st.view(torch.int16).numpy().astype(np.int32)
                bits_j = torch.from_numpy(np.ascontiguousarray(want)).to(torch.bfloat16).view(torch.int16)
                assert int(np.max(np.abs(bits_t - bits_j.numpy().astype(np.int32)))) <= 1, (moment, name)
    if state_dtype == "int8":
        # rule (b): blocks along the reference's last axis, bf16 where it is not a multiple of 32
        assert ts["m"]["layers.0.attn.wq.weight"]["scale"].shape == (48, 64 // 32)
        assert ts["m"]["layers.0.attn.wo.weight"].dtype == torch.bfloat16
        assert ts["m"]["embed"].dtype == torch.bfloat16
        assert t_optim._is_q8(ts["m"]["layers.0.mlp.wi.weight"])


def test_weight_decay_follows_the_stacked_leaf():
    """Rule (a): with zero gradients only decay moves a tensor.  The
    per-layer ``ln1`` and QKV biases are 1-D in the port but (L, D) in the
    reference, so they decay; ``final_norm`` is (D,) there and does not."""
    cfg = _model_cfg()
    tree = _ref_params(cfg)
    zeros = [jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32), tree)]
    ocfg = t_optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    jp, _, _, tp, _, tm = _run_both(cfg, ocfg, zeros, tree)
    _check_params(cfg, tree, jp, tp)
    before = _port_slices(cfg, tree)
    lr = float(tm["lr"])
    for name in ("layers.0.ln1", "layers.2.attn.wq.bias", "embed"):
        got = dict(tp.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, before[name] * (1 - lr * 0.1), rtol=1e-6, err_msg=name)
    assert dict(tp.named_parameters())["layers.0.ln1"].ndim == 1
    np.testing.assert_array_equal(tp.final_norm.detach().numpy(), before["final_norm"])


def test_adafactor_matches_the_reference_and_couples_the_layers():
    """Rule (c): the stacked (L, D) norms and biases are one factored
    matrix across the layers (``vr`` per layer, ``vc`` the mean across
    them); the (L, in, out) weights factor layer by layer."""
    cfg = _model_cfg()
    tree = _ref_params(cfg)
    ocfg = t_optim.OptConfig(name="adafactor", lr=1e-2, warmup_steps=2, total_steps=10)
    jp, js, jm, tp, ts, tm = _run_both(cfg, ocfg, _grads(tree, 2), tree)
    _check_scalars(jm, tm)
    _check_params(cfg, tree, jp, tp)
    f_j, f_t = js["f"], ts["f"]
    n_layers = cfg.n_layers
    for key, ref in (("layers.*.ln1", f_j["layers"]["ln1"]), ("layers.*.attn.wk.bias", f_j["layers"]["attn"]["bk"])):
        assert f_t[key]["vr"].shape == (n_layers,) and f_t[key]["vc"].shape == ref["vc"].shape
        for part in ("vr", "vc"):
            assert _rel_fro(f_t[key][part].numpy(), ref[part]) <= DELTA_RTOL, (key, part)
    for i in range(n_layers):
        ref = f_j["layers"]["attn"]["wq"]
        got = f_t[f"layers.{i}.attn.wq.weight"]
        for part in ("vr", "vc"):
            assert _rel_fro(got[part].numpy(), np.asarray(ref[part])[i]) <= DELTA_RTOL, (i, part)
    assert _rel_fro(f_t["final_norm"]["v"].numpy(), f_j["final_norm"]["v"]) <= DELTA_RTOL
    assert _rel_fro(f_t["embed"]["vc"].numpy(), f_j["embed"]["vc"]) <= DELTA_RTOL
    # teeth: updated as its own (D,) tensor, unfactored, ln1's first step
    # would be about sign(g) / sqrt(1 - b2), whatever the clip scale
    g1 = _grads(tree, 2, 1)
    _, _, _, tp1, _, tm1 = _run_both(cfg, ocfg, g1, tree)
    before = _port_slices(cfg, tree)["layers.1.ln1"]
    step1 = (before - tp1.layers[1].ln1.detach().numpy()) / float(tm1["lr"])
    unfactored = np.sign(_port_slices(cfg, g1[0])["layers.1.ln1"]) / np.sqrt(1 - ocfg.b2)
    assert _rel_fro(step1, unfactored) > 0.1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4, dtype=torch.bfloat16) / 3},
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "m": {"q": torch.arange(-4, 4, dtype=torch.int8)}},
    }
    t_ckpt.save(str(tmp_path), 7, state, meta={"arch": "x"})
    out, step = t_ckpt.restore(str(tmp_path))
    assert step == 7
    for key in ("params/w", "params/b", "opt/step", "opt/m/q"):
        a, b = t_ckpt._flatten(out)[key], t_ckpt._flatten(state)[key]
        assert a.dtype == b.dtype and torch.equal(a, b), key
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert manifest["arch"] == "x" and manifest["bfloat16_keys"] == ["params/b"]
    assert t_ckpt.latest_step(str(tmp_path)) == 7
    # a staging directory, even one with a manifest, is not a checkpoint
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "manifest.json").write_text("{}")
    assert t_ckpt.latest_step(str(tmp_path)) == 7
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"))


def test_async_save_copies_before_it_returns(tmp_path, monkeypatch):
    """``save(blocking=False)`` then an in-place update: the checkpoint
    holds the values at the call.  The writer thread is held back until
    ``wait_pending``, so a copy made inside it would see the update."""

    class Deferred:
        def __init__(self, target, daemon):
            self.target = target

        def start(self):
            pass

        def join(self):
            self.target()

    monkeypatch.setattr(t_ckpt.threading, "Thread", Deferred)
    p = torch.nn.Parameter(torch.arange(6.0))
    state = {"params": {"w": p}, "opt": {"m": torch.zeros(6, dtype=torch.bfloat16)}}
    t_ckpt.save(str(tmp_path), 1, state, blocking=False)
    assert t_ckpt.latest_step(str(tmp_path)) is None  # not written yet
    with torch.no_grad():
        p.add_(100.0)
        state["opt"]["m"].add_(1.0)
    t_ckpt.wait_pending()
    out, _ = t_ckpt.restore(str(tmp_path))
    assert torch.equal(out["params"]["w"], torch.arange(6.0))
    assert torch.equal(out["opt"]["m"], torch.zeros(6, dtype=torch.bfloat16))


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """A checkpoint written by ``repro.train.checkpoint.save`` restores in
    the port, and its params, through ``params_from_jax``, give the
    reference's forward (max abs 1e-4, as ``tests/test_torch_lm.py``)."""
    cfg = get_config("qwen2_1_5b").reduced()
    jcfg = _jcfg(cfg)
    tree = _ref_params(cfg)
    j_ckpt.save(str(tmp_path), 3, {"params": jax.tree.map(jnp.asarray, tree), "opt": {"step": jnp.int32(3)}})
    out, step = t_ckpt.restore(str(tmp_path))
    assert step == 3 and int(out["opt"]["step"]) == 3
    tp = params_from_jax(cfg, out["params"], device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    h_j, _ = j_get_model(jcfg).forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        h_t, _ = t_tf.forward(tp, cfg, torch.from_numpy(toks))
    assert float(np.max(np.abs(h_t.numpy() - np.asarray(h_j)))) <= 1e-4


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_straggler_detector():
    t = t_metrics.StepTimer(alpha=0.5, slow_factor=2.0)
    for _ in range(4):
        t.observe(0.01)
    assert not t.is_straggler
    t.observe(0.08)
    assert t.is_straggler
    assert t.stragglers == 1
    with t:
        pass
    assert not t.is_straggler and t.last is not None


def test_jsonl_logger(tmp_path):
    path = tmp_path / "log.jsonl"
    log = t_metrics.JsonlLogger(str(path))
    line = log.log(3, loss=torch.tensor(2.5), lr=np.float32(1e-3), straggler=False, note=[1])
    log.log(4, loss=1.0)
    log.close()
    rows = [json.loads(r) for r in path.read_text().splitlines()]
    assert json.loads(line) == rows[0]
    assert rows[0]["step"] == 3 and rows[0]["loss"] == 2.5 and rows[0]["straggler"] == 0.0
    assert rows[0]["note"] == "[1]" and rows[1]["step"] == 4
    assert t_metrics.JsonlLogger(None).log(0, loss=1.0).startswith("{")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_loss_descends():
    from repro_torch.launch.train import main

    losses = main([
        "--arch", "qwen2_1_5b", "--reduced", "--steps", "12",
        "--global-batch", "4", "--seq-len", "64", "--lr", "3e-3", "--device", "cpu",
    ])
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(np.isfinite(losses))
    assert not torch.are_deterministic_algorithms_enabled()  # restored


def test_launcher_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "qwen2_1_5b", "--reduced", "--steps", "1"])


def test_preempt_resume_bit_exact(tmp_path):
    """Run A: 10 steps straight.  Run B: preempted at 5 (hard exit 42),
    then resumed.  The final checkpoints are equal bit for bit, the
    optimizer's moments and step included."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    common = [
        sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2_1_5b",
        "--reduced", "--steps", "10", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-every", "5", "--device", "cpu",
    ]
    subprocess.run(common + ["--ckpt-dir", a_dir], env=ENV, check=True, capture_output=True, timeout=300)
    r = subprocess.run(common + ["--ckpt-dir", b_dir, "--preempt-after", "5"], env=ENV, capture_output=True,
                       timeout=300)
    assert r.returncode == 42, r.stderr.decode()[-500:]
    assert t_ckpt.latest_step(b_dir) == 5
    r = subprocess.run(common + ["--ckpt-dir", b_dir], env=ENV, check=True, capture_output=True, timeout=300)
    assert b"[resume] from step 5" in r.stdout

    sa, step_a = t_ckpt.restore(a_dir)
    sb, step_b = t_ckpt.restore(b_dir)
    assert step_a == step_b == 10
    fa, fb = t_ckpt._flatten(sa), t_ckpt._flatten(sb)
    assert fa.keys() == fb.keys() and any(k.startswith("opt/m/") for k in fa)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key
    assert int(fa["opt/step"]) == 10
