"""The port's recurrent family (griffin, recurrentgemma-2b) against the JAX
package, on the CPU.

Both packages get the same numpy inputs; weights are drawn by the
reference's own init (its zero norms and conv biases perturbed, so that
they count) and carried across with ``repro_torch.models.params_from_jax``.
Everything runs in float32 on the reduced recurrentgemma-2b (d = 64, 4
heads of 16 over one KV head, window 8) at 8 layers: two (R, R, A)
periods and the (R, R) remainder, the published layout's shape (the
reduced config's 4 layers would leave one period and one remainder block).

Tolerances:
  * the parallel prefix (``_scan``) against ``jax.lax.associative_scan``:
    max abs 1e-6 (the same operations in the same order; XLA may fuse
    a2 * b1 + b2 into one rounding); ``_rglru`` against the reference's,
    and its scan against single steps: 1e-5 (float32 rounding);
  * ``forward`` + ``logits_fn``, ``prefill`` and each ``decode_step``
    against the reference's: max abs 1e-4; the port's decode against its
    own forward: 1e-3 (the reference's ``tests/test_models_smoke.py``);
  * greedy tokens: equal;
  * one train step: loss, ``lr`` and ``grad_norm`` relative 1e-5,
    gradients 2e-5 relative Frobenius (the reference's jitted float32
    gradients lie up to 1.1e-5 from a float64 run of the port, the port's
    own float32 ones up to 3.6e-6: the RG-LRU's gates and the conv sum
    every token's term), each tensor's update 1e-3 (int8
    states 1e-2) over the elements whose gradients agree to 1e-3, as
    ``tests/test_torch_moe.py`` holds the transformer's.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import abstract_init as j_abstract_init
from repro.models import get_model as j_get_model
from repro.models import griffin as j_griffin
from repro.models import init_params as j_init_params
from repro.serve import lm as j_lm
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import get_config
from repro_torch.models import RefLeaf, abstract_init, get_model, params_from_jax, reference_leaves
from repro_torch.models import griffin as t_griffin
from repro_torch.serve import lm as t_lm
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ARCH = "recurrentgemma_2b"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
SCAN_TOL = 1e-6
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_TOL = 1e-3
SCALAR_RTOL = 1e-5
GRAD_RTOL = 2e-5
DELTA_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs (the other
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    err = float(np.max(np.abs(got.detach().float().numpy() - np.asarray(want, np.float32))))
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cfg():
    return dataclasses.replace(get_config(ARCH).reduced(), n_layers=8)


def _jcfg(cfg):
    return dataclasses.replace(j_get_config(ARCH), **dataclasses.asdict(cfg))


def _ref_params(cfg, seed: int = 0):
    """The reference's init with its all-zero leaves perturbed; numpy."""
    params = jax.jit(lambda key: j_init_params(_jcfg(cfg), key)[0])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.asarray(a)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree.map(perturb, params)


def _port_view(leaves, tree, name):
    leaf = leaves[name]
    a = tree
    for key in leaf.path:
        a = a[key]
    a = np.asarray(a, np.float32)
    a = a[leaf.layer] if leaf.layer is not None else a
    return a.T if leaf.transposed else a


def _tokens(cfg, b: int, s: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    tree = _ref_params(cfg)
    return cfg, tree, params_from_jax(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_len", [1, 2, 7, 64, 70])
def test_scan_matches_associative_scan(s_len):
    """Odd and even lengths, one level and several."""
    rng = np.random.default_rng(s_len)
    a = rng.uniform(0.5, 1.0, size=(2, s_len, 8)).astype(np.float32)
    b = rng.normal(size=(2, s_len, 8)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    a_j, h_j = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    a_t, h_t = t_griffin._scan(_t(a), _t(b))
    _close(h_t, h_j, SCAN_TOL, "h")
    _close(a_t, a_j, SCAN_TOL, "prod a")


def test_rglru_matches_the_reference_and_single_steps(model):
    """A recurrent block over 70 tokens against the reference's, and
    against 70 single steps from zero states (the reference's own check)."""
    cfg, tree, tp = model
    pl_j = jax.tree.map(lambda v: jnp.asarray(v[1]), tree["period"]["mix0"])
    pl_t = tp.period[1].mix0
    h = np.random.default_rng(3).normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    y_j, (conv_j, lru_j) = jax.jit(j_griffin._rglru)(pl_j, jnp.asarray(h))
    with torch.no_grad():
        y_t, (conv_t, lru_t) = t_griffin._rglru(pl_t, _t(h))
        state = (torch.zeros((2, cfg.d_conv - 1, cfg.d_model)), torch.zeros((2, cfg.d_model)))
        steps = []
        for t in range(70):
            o, state = t_griffin._rglru(pl_t, _t(h[:, t : t + 1]), state, single_step=True)
            steps.append(o)
    for got, want, what in ((y_t, y_j, "y"), (conv_t, conv_j, "conv tail"), (lru_t, lru_j, "LRU state")):
        _close(got, want, LAYER_TOL, what)
    _close(torch.cat(steps, dim=1), y_t.numpy(), LAYER_TOL, "single steps vs the scan")
    _close(state[1], lru_t.numpy(), LAYER_TOL, "the last step's state")


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------


def test_forward_and_logits_match(model):
    """S = 20, past the window of 8."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    toks = _tokens(cfg, 2, 20)
    h_j, _ = jax.jit(lambda p, t: jm.forward(p, jcfg, t))(tree, jnp.asarray(toks))
    with torch.inference_mode():
        h_t, aux = t_griffin.forward(tp, cfg, _t(toks))
        lg_t = t_griffin.logits_fn(tp, cfg, h_t)
    _close(h_t, h_j, MODEL_TOL, "hidden")
    _close(lg_t, jm.logits_fn(tree, jcfg, h_j), MODEL_TOL, "logits")
    assert float(aux) == 0.0 and lg_t.shape == (2, 20, cfg.padded_vocab)


def test_prefill_and_decode_match_the_reference_and_the_forward(model):
    """A 20-token prompt (the ring of 8 slots keeps its last 8) and 7
    decode steps (the ring wraps again): the cache and each step's logits
    against the reference's, and the decode against the port's forward."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    s, t_steps = 20, 8
    toks = _tokens(cfg, 2, s + t_steps, seed=6)
    jp = jax.tree.map(jnp.asarray, tree)
    last_j, cache_j = jm.prefill(jp, jcfg, jnp.asarray(toks[:, :s]), max_len=s + t_steps, cache_dtype=jnp.float32)
    step_j = jax.jit(lambda c, t: jm.decode_step(jp, jcfg, c, t))
    with torch.inference_mode():
        last_t, cache_t = t_griffin.prefill(tp, cfg, _t(toks[:, :s]), max_len=s + t_steps,
                                            cache_dtype=torch.float32)
        _close(last_t, last_j, MODEL_TOL, "prefill logits")
        for key in ("k", "v", "kpos", "conv", "lru"):
            assert cache_t[key].shape == cache_j[key].shape, key
            _close(cache_t[key], cache_j[key], MODEL_TOL, f"cache {key}")
        assert cache_t["k"].shape[0] == 2 and cache_t["conv"].shape[0] == 6  # 2 periods x (R, R, A) + (R, R)
        assert cache_t["pos"] == int(cache_j["pos"]) == s
        outs = [last_t]
        for t in range(t_steps - 1):
            cur = toks[:, s + t : s + t + 1]
            lg_j, cache_j = step_j(cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_griffin.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"decode step {t}")
            outs.append(lg_t)
        for key in ("k", "kpos", "lru"):
            _close(cache_t[key], cache_j[key], MODEL_TOL, f"cache {key} after decoding")
        h, _ = t_griffin.forward(tp, cfg, _t(toks))
        ref = t_griffin.logits_fn(tp, cfg, h)[:, s - 1 : s + t_steps - 1]
    _close(torch.stack(outs, dim=1), ref.numpy(), DECODE_TOL, "decode vs forward")


def test_init_cache_layout(model):
    cfg, _, _ = model
    cache = t_griffin.init_cache(cfg, 3, 5, dtype=torch.float32, device="cpu")
    assert cache["k"].shape == (2, 3, 5, cfg.n_kv, cfg.d_head) and cache["kpos"].tolist() == [-(2**30)] * 5
    assert cache["conv"].shape == (6, 3, cfg.d_conv - 1, cfg.d_model) and cache["lru"].dtype == torch.float32
    assert t_griffin.init_cache(cfg, 1, 100, device="cpu")["k"].shape[2] == cfg.window


def test_greedy_tokens_equal_the_reference(model):
    """``Engine`` on both packages' weights; 12 new tokens after prompts of
    3-9 tokens wrap the ring of 8 slots."""
    cfg, tree, tp = model
    j_eng = j_lm.Engine(_jcfg(cfg), jax.tree.map(jnp.asarray, tree), max_len=64)
    t_eng = t_lm.Engine(cfg, tp, max_len=64, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(prompt=rng.integers(2, 500, size=n).astype(np.int32), max_new_tokens=m, temperature=0.0)
            for n, m in ((3, 8), (9, 12), (5, 4))]
    want = j_eng.generate([j_lm.GenRequest(**r) for r in reqs], seed=0)
    got = t_eng.generate([t_lm.GenRequest(**r) for r in reqs], seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t_eng.last_stats["tokens"] == sum(len(w) for w in want)


def test_cast_for_compute_keeps_the_gates_in_float32(model):
    cfg, _, tp = model
    cast = t_griffin.cast_for_compute(tp, dataclasses.replace(cfg, dtype="bfloat16"))
    dtypes = {name: t.dtype for name, t in cast.named_parameters()}
    for name in ("period.0.mix0.wr.weight", "period.1.mix1.wi.weight", "remainder.mix1.lam", "period.0.mix2.ln",
                 "remainder.mlp0.ln", "final_norm"):
        assert dtypes[name] == torch.float32, name
    for name in ("period.0.mlp0.wi.weight", "period.0.mix0.wx.weight", "period.0.mix2.wq.weight",
                 "remainder.mix0.conv_w", "embed"):
        assert dtypes[name] == torch.bfloat16, name


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, b: int = 4, s: int = 20, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[1, 3] = 0.0
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32), "mask": mask}


@pytest.fixture(scope="module")
def ref_grads(model):
    """The reference's loss and gradients on ``_batch`` (jitted once)."""
    cfg, tree, _ = model
    jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, _), g = jax.jit(jax.value_and_grad(j_step.make_loss_fn(_jcfg(cfg)), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jb)
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("opt,state", [("adamw", "float32"), ("adamw", "bfloat16"), ("adamw", "int8"),
                                       ("adafactor", "float32")])
def test_train_step_matches_the_reference(model, ref_grads, opt, state):
    """The port's ``train_step`` (loss, gradients, one update) against the
    reference's gradients and its optimizer's update on them (the
    reference's step at microbatch 1), the unstacked remainder leaves
    included; under Adafactor the periods' (P, D) ``lam`` is one matrix and
    the remainder's (D,) ``lam`` is not factored."""
    cfg, tree, _ = model
    loss_j, g_j = ref_grads
    leaves = reference_leaves(cfg)
    ocfg = t_optim.OptConfig(name=opt, lr=1e-3, warmup_steps=1, total_steps=10, state_dtype=state)
    j_init, j_update = j_optim.make_optimizer(j_optim.OptConfig(**dataclasses.asdict(ocfg)))
    jp = jax.tree.map(jnp.asarray, tree)
    jp2, js, jm = jax.jit(j_update)(jp, jax.tree.map(jnp.asarray, g_j), j_init(jp))
    jp2 = jax.tree.map(np.asarray, jp2)

    tp = params_from_jax(cfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    names, tensors = zip(*tp.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(t_step.make_loss_fn(cfg)(tp, tb)[0], tensors)))
    ts = t_optim.make_optimizer(ocfg, cfg)[0](tp)
    _, _, tm = t_step.make_train_step(cfg, ocfg)(tp, ts, tb)

    assert _rel(tm["loss"], loss_j) <= SCALAR_RTOL
    for key in ("lr", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= SCALAR_RTOL, key
    for name, g in g_t.items():
        assert _rel_fro(g.numpy(), _port_view(leaves, g_j, name)) <= GRAD_RTOL, name
    tol = 1e-2 if state == "int8" else DELTA_RTOL
    excluded = 0
    for name, p in tp.named_parameters():
        before = _port_view(leaves, tree, name).astype(np.float64)
        d_t, d_j = p.detach().numpy() - before, _port_view(leaves, jp2, name) - before
        g = _port_view(leaves, g_j, name)
        well = np.abs(g_t[name].numpy() - g) <= 1e-3 * np.abs(g)
        excluded += int((~well).sum())
        assert np.isfinite(d_t).all() and _rel_fro(d_t[well], d_j[well]) <= tol, name
    assert excluded <= 1e-2 * sum(p.numel() for p in tp.parameters()), excluded
    if opt == "adafactor":
        f = ts["f"]["period.*.mix0.lam"]
        assert f["vr"].shape == (2,) and f["vc"].shape == (cfg.d_model,)
        for part in ("vr", "vc"):
            assert _rel_fro(f[part].numpy(), js["f"]["period"]["mix0"]["lam"][part]) <= DELTA_RTOL, part
        assert set(ts["f"]["remainder.mix1.lam"]) == {"v"}
        want = js["f"]["remainder"]["mix1"]["lam"]["v"]
        assert _rel_fro(ts["f"]["remainder.mix1.lam"]["v"].numpy(), want) <= DELTA_RTOL


def test_optimizer_rules_on_periods_and_the_remainder(model):
    """Rule (a): with zero gradients only decay moves a tensor.  The
    periods' ``ln`` and ``lam`` are (P, D) leaves in the reference, so they
    decay; the remainder's are (D,), as is ``final_norm``, and do not."""
    cfg, tree, tp0 = model
    leaves = reference_leaves(cfg)
    assert leaves["period.1.mix0.lam"] == RefLeaf(("period", "mix0", "lam"), 1, False, (2, cfg.d_model))
    assert leaves["remainder.mix1.lam"] == RefLeaf(("remainder", "mix1", "lam"), None, False, (cfg.d_model,))
    assert leaves["remainder.mlp0.wi.weight"] == RefLeaf(("remainder", "mlp0", "wi"), None, True,
                                                         (cfg.d_model, 2 * cfg.d_ff))
    tp = params_from_jax(cfg, tree, device="cpu")
    init, update = t_optim.make_optimizer(t_optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10), cfg)
    _, _, m = update(tp, {n: torch.zeros_like(p) for n, p in tp.named_parameters()}, init(tp))
    lr = float(m["lr"])
    got = dict(tp.named_parameters())
    for name in ("period.0.mix0.ln", "period.1.mix1.lam", "period.0.mlp2.ln", "remainder.mix0.conv_w", "embed"):
        np.testing.assert_allclose(got[name].detach().numpy(), _port_view(leaves, tree, name) * (1 - lr * 0.1),
                                   rtol=1e-6, err_msg=name)
    for name in ("remainder.mix0.ln", "remainder.mix1.lam", "remainder.mlp1.ln", "final_norm"):
        assert torch.equal(got[name], dict(tp0.named_parameters())[name]), name


# ---------------------------------------------------------------------------
# the parameters' layout, at the reduced and the published size
# ---------------------------------------------------------------------------


def test_reference_leaves_round_trip(model):
    """Every reference leaf is covered once, element for element (the
    periods' stacked, the remainder's unstacked), and each port tensor is
    its slice."""
    cfg, tree, tp = model
    leaves = reference_leaves(cfg)
    flat = {tuple(k.key for k in path): np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {leaf.path for leaf in leaves.values()} == set(flat)
    for path, a in flat.items():
        covered = [leaf for leaf in leaves.values() if leaf.path == path]
        assert all(leaf.shape == a.shape for leaf in covered), path
        assert sum(int(np.prod(leaf.shape[1:] if leaf.layer is not None else leaf.shape)) for leaf in covered) == a.size
    for name, t in tp.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), _port_view(leaves, tree, name), err_msg=name)


def test_abstract_init_as_published():
    """recurrentgemma-2b at its published size on the meta device: 8
    periods of (R, R, A) and an (R, R) remainder, the reference's count
    (2.894e9 parameters, 11.6 GB as float32 masters)."""
    cfg = get_config(ARCH)
    shapes, _ = j_abstract_init(j_get_config(ARCH))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    p = abstract_init(cfg)
    assert get_model(cfg) is t_griffin and len(p.period) == 8 and p.remainder.kinds == ("R", "R")
    assert all(t.is_meta for t in p.parameters())
    n = sum(t.numel() for t in p.parameters())
    assert n == n_ref and round(n / 1e9, 3) == 2.894
    assert shapes["period"]["mix2"]["wk"].shape == (8, 2560, 256)
    assert shapes["remainder"]["mix1"]["lam"].shape == (2560,)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_and_resumes_bit_exact(tmp_path):
    """``python -m repro_torch.launch.train --arch recurrentgemma_2b
    --reduced --device cpu``: run A takes 8 steps and its loss descends;
    run B is preempted after 4 (exit 42) and resumed; the final
    checkpoints are equal bit for bit."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced", "--steps", "8",
              "--global-batch", "4", "--seq-len", "24", "--lr", "3e-3", "--ckpt-every", "4", "--device", "cpu"]
    runs = [subprocess.Popen(common + ["--ckpt-dir", d, *extra], env=ENV, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for d, extra in ((a_dir, ()), (b_dir, ("--preempt-after", "4")))]
    try:
        outs = [r.communicate(timeout=300) for r in runs]
    finally:
        for r in runs:
            r.kill()
    assert [r.returncode for r in runs] == [0, 42], outs[0][1][-500:] + outs[1][1][-500:]
    final, first = map(float, re.search(r"final loss: ([\d.]+) \(first: ([\d.]+)\)", outs[0][0]).groups())
    assert final < first - 0.1, (first, final)
    r = subprocess.run(common + ["--ckpt-dir", b_dir], env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "[resume] from step 4" in r.stdout, r.stderr[-500:]
    sa, step_a = t_ckpt.restore(a_dir)
    sb, step_b = t_ckpt.restore(b_dir)
    fa, fb = t_ckpt._flatten(sa), t_ckpt._flatten(sb)
    assert step_a == step_b == 8 and fa.keys() == fb.keys() and "opt/m/remainder.mix0.lam" in fa
    for key in fa:
        assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key
