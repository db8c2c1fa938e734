"""The port's SSM family (mamba2) against the JAX package, on the CPU.

Both packages get the same numpy inputs; weights are drawn by the
reference's own init (its zero norms, conv bias and ``dt_bias`` perturbed,
so that they count) and carried across with
``repro_torch.models.params_from_jax``.  Everything runs in float32 on the
reduced mamba2-780m (4 layers, d = 64, 8 SSD heads of 16, chunk 32).

Tolerances:
  * ``ssd_chunked`` and the mixer: max abs 1e-5 (float32 rounding of the
    same operations in another order, on outputs of a few units); the
    naive recurrence 2e-3 relative, 2e-4 absolute (the reference's own
    check); gradients through ``ssd_chunked`` 1e-5 relative Frobenius;
  * ``forward`` + ``logits_fn``, ``prefill`` and each ``decode_step``
    against the reference's: max abs 1e-4 (a few layers of 1e-5 each);
    the port's decode against its own forward: 1e-3 (the reference's
    ``tests/test_models_smoke.py``);
  * greedy tokens: equal;
  * one train step: loss, ``lr`` and ``grad_norm`` relative 1e-5,
    gradients 1e-5 relative Frobenius but 5e-5 for the per-head
    ``a_log``, ``d_skip`` and ``dt_bias`` (each sums every token's and
    channel's term through the decay's exp chain, with cancellations:
    both packages' float32 gradients lie 0.5e-5 to 1.7e-5 from a float64
    run of the port there), each tensor's update 1e-3 (int8
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
from repro.models import init_params as j_init_params
from repro.models import ssm as j_ssm
from repro.serve import lm as j_lm
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import get_config
from repro_torch.models import RefLeaf, abstract_init, get_model, init_params, params_from_jax, reference_leaves
from repro_torch.models import ssm as t_ssm
from repro_torch.serve import lm as t_lm
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ARCH = "mamba2_780m"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_TOL = 1e-3
SCALAR_RTOL = 1e-5
GRAD_RTOL = 1e-5
HEAD_GRAD_RTOL = 5e-5
HEADS = ("a_log", "d_skip", "dt_bias")
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
    cfg = get_config(ARCH).reduced()
    tree = _ref_params(cfg)
    return cfg, tree, params_from_jax(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# the SSD scan and the mixer
# ---------------------------------------------------------------------------


def _ssd_inputs(s: int, s_pad: int, dt_range=(0.01, 0.2), seed: int = 0):
    rng = np.random.default_rng(seed)
    b, h, p, n = 2, 3, 8, 16
    x = rng.normal(size=(b, s_pad, h, p)).astype(np.float32)
    b_in = rng.normal(size=(b, s_pad, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s_pad, n)).astype(np.float32)
    dt = rng.uniform(*dt_range, size=(b, s_pad, h)).astype(np.float32)
    dt[:, s:] = 0.0  # the mixer's padding: decay 1, no input
    a_log = np.log(rng.uniform(0.5, 4.0, size=(h,))).astype(np.float32)
    return x, b_in, c_in, dt, a_log


def test_ssd_chunked_matches_the_reference_and_the_recurrence():
    """S = 70 padded to 3 chunks of 32: the port against the reference's
    ``ssd_chunked`` (outputs and the gradients of a weighted sum), and the
    first 70 positions against the naive per-token recurrence."""
    s, q = 70, 32
    inputs = _ssd_inputs(s, 96)
    ref = jax.jit(j_ssm.ssd_chunked, static_argnums=5)
    want = np.asarray(ref(*map(jnp.asarray, inputs), q))
    args = [_t(v).requires_grad_() for v in inputs]
    got = t_ssm.ssd_chunked(*args, q)
    _close(got, want, LAYER_TOL, "ssd_chunked")
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    g_j = jax.jit(jax.grad(lambda *a: jnp.sum(ref(*a, q) * w), argnums=(0, 1, 2, 3, 4)))(*map(jnp.asarray, inputs))
    g_t = torch.autograd.grad((got * _t(w)).sum(), args)
    for name, g, gj in zip(("x", "b", "c", "dt", "a_log"), g_t, g_j):
        assert _rel_fro(g.numpy(), gj) <= GRAD_RTOL, name

    x, b_in, c_in, dt, a_log = inputs
    a = -np.exp(a_log.astype(np.float64))
    state = np.zeros((2, 3, 16, 8))
    naive = np.zeros((2, s, 3, 8))
    for t in range(s):
        state = state * np.exp(dt[:, t, :, None, None] * a[None, :, None, None]) + np.einsum(
            "bn,bhp->bhnp", b_in[:, t], x[:, t] * dt[:, t][..., None])
        naive[:, t] = np.einsum("bn,bhnp->bhp", c_in[:, t], state)
    np.testing.assert_allclose(got.detach().numpy()[:, :s], naive, rtol=2e-3, atol=2e-4)


def test_ssd_gradients_stay_finite_where_the_anti_causal_decay_overflows():
    """dt up to 8 with A = -16: exp of an anti-causal segment sum overflows
    float32, so the mask must come before the exp, forward and backward."""
    x, b_in, c_in, _, _ = _ssd_inputs(64, 64)
    dt = np.random.default_rng(2).uniform(1.0, 8.0, size=(2, 64, 3)).astype(np.float32)
    a_log = np.log(np.full(3, 16.0, np.float32))
    args = [_t(v).requires_grad_() for v in (x, b_in, c_in, dt, a_log)]
    y = t_ssm.ssd_chunked(*args, 32)
    grads = torch.autograd.grad(y.sum(), args)
    assert bool(torch.isfinite(y).all()) and all(bool(torch.isfinite(g).all()) for g in grads)


def test_mixer_matches_the_reference(model):
    """One layer's mixer over a 70-token sequence (the chunked form,
    padded) and over one token from (conv, ssm) states."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    pl_j = jax.tree.map(lambda v: jnp.asarray(v[1]), tree["layers"])
    pl_t = tp.layers[1]
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    y_j, conv_j, _ = jax.jit(lambda pl, x: j_ssm._mixer(pl, x, jcfg))(pl_j, jnp.asarray(h))
    with torch.no_grad():
        y_t, conv_t, _ = t_ssm._mixer(pl_t, _t(h), cfg)
    _close(y_t, y_j, LAYER_TOL, "mixer over the sequence")
    _close(conv_t, conv_j, LAYER_TOL, "conv tail")
    conv = rng.normal(size=(2, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state)).astype(np.float32)
    ssm = rng.normal(size=(2, cfg.n_ssm_heads, cfg.d_state, cfg.ssm_head)).astype(np.float32)
    y_j, conv_j, ssm_j = jax.jit(lambda pl, x, c, st: j_ssm._mixer(pl, x, jcfg, c, st, single_step=True))(
        pl_j, jnp.asarray(h[:, :1]), jnp.asarray(conv), jnp.asarray(ssm))
    with torch.no_grad():
        y_t, conv_t, ssm_t = t_ssm._mixer(pl_t, _t(h[:, :1]), cfg, _t(conv), _t(ssm), single_step=True)
    for got, want, what in ((y_t, y_j, "step"), (conv_t, conv_j, "step conv"), (ssm_t, ssm_j, "step ssm")):
        _close(got, want, LAYER_TOL, what)


def test_softplus_is_logaddexp_above_twenty():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.5, 20.5, 40.0])
    np.testing.assert_array_equal(t_ssm.softplus(x).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


# ---------------------------------------------------------------------------
# forward, prefill and decode
# ---------------------------------------------------------------------------


def test_forward_and_logits_match(model):
    """S = 70: two full chunks of 32 and a padded third."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    toks = _tokens(cfg, 2, 70)
    h_j, _ = jm.forward(tree, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        h_t, aux = t_ssm.forward(tp, cfg, _t(toks))
        lg_t = t_ssm.logits_fn(tp, cfg, h_t)
    _close(h_t, h_j, MODEL_TOL, "hidden")
    _close(lg_t, jm.logits_fn(tree, jcfg, h_j), MODEL_TOL, "logits")
    assert float(aux) == 0.0 and lg_t.shape == (2, 70, cfg.padded_vocab)


def test_prefill_and_decode_match_the_reference_and_the_forward(model):
    """A 40-token prompt (past the 32-token chunk) and 6 decode steps:
    the caches and each step's logits against the reference's, and the
    decode against the port's own forward over the whole sequence."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    s, t_steps = 40, 7
    toks = _tokens(cfg, 2, s + t_steps, seed=6)
    last_j, cache_j = jm.prefill(tree, jcfg, jnp.asarray(toks[:, :s]), max_len=s + t_steps, cache_dtype=jnp.float32)
    with torch.inference_mode():
        last_t, cache_t = t_ssm.prefill(tp, cfg, _t(toks[:, :s]), max_len=s + t_steps, cache_dtype=torch.float32)
        _close(last_t, last_j, MODEL_TOL, "prefill logits")
        for key in ("conv", "ssm"):
            assert cache_t[key].shape == cache_j[key].shape, key
            _close(cache_t[key], cache_j[key], MODEL_TOL, f"cache {key}")
        assert cache_t["pos"] == int(cache_j["pos"]) == s
        conv, ssm = cache_t["conv"], cache_t["ssm"]
        outs = [last_t]
        for t in range(t_steps - 1):
            cur = toks[:, s + t : s + t + 1]
            lg_j, cache_j = jm.decode_step(tree, jcfg, cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_ssm.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"decode step {t}")
            outs.append(lg_t)
        assert cache_t["conv"] is conv and cache_t["ssm"] is ssm  # written in place
        _close(cache_t["ssm"], cache_j["ssm"], MODEL_TOL, "ssm state after decoding")
        h, _ = t_ssm.forward(tp, cfg, _t(toks))
        ref = t_ssm.logits_fn(tp, cfg, h)[:, s - 1 : s + t_steps - 1]
    _close(torch.stack(outs, dim=1), ref.numpy(), DECODE_TOL, "decode vs forward")


def test_init_cache_and_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch, model):
    cfg, _, tp = model
    cache = t_ssm.init_cache(cfg, 3, 999, dtype=torch.float32, device="cpu")
    assert cache["pos"] == 0 and cache["conv"].shape == (cfg.n_layers, 3, cfg.d_conv - 1, 160)
    assert cache["ssm"].shape == (cfg.n_layers, 3, 8, 16, 16) and cache["ssm"].dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ssm.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lm.Engine(cfg, tp, max_len=32)


def test_greedy_tokens_equal_the_reference(model):
    """``Engine`` on both packages' weights, prompts of 3-9 tokens
    left-padded with BOS (the SSM runs over the padding too)."""
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, b: int = 4, s: int = 40, seed: int = 0) -> dict:
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
    (loss, metrics), g = jax.jit(jax.value_and_grad(j_step.make_loss_fn(_jcfg(cfg)), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jb)
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("opt,state", [("adamw", "float32"), ("adamw", "bfloat16"), ("adamw", "int8"),
                                       ("adafactor", "float32")])
def test_train_step_matches_the_reference(model, ref_grads, opt, state):
    """The port's ``train_step`` (loss, gradients, one update) against the
    reference's gradients and its optimizer's update on them (the
    reference's step at microbatch 1); the stacked (L, H) ``a_log``,
    ``d_skip``, ``dt_bias`` are decayed and, under Adafactor, one matrix
    across the layers."""
    cfg, tree, _ = model
    loss_j, g_j = ref_grads
    leaves = reference_leaves(cfg)
    ocfg = t_optim.OptConfig(name=opt, lr=1e-3, warmup_steps=1, total_steps=10, state_dtype=state)
    j_ocfg = j_optim.OptConfig(**dataclasses.asdict(ocfg))
    j_init, j_update = j_optim.make_optimizer(j_ocfg)
    jp = jax.tree.map(jnp.asarray, tree)
    jp2, js, jm = jax.jit(j_update)(jp, jax.tree.map(jnp.asarray, g_j), j_init(jp))
    jp2 = jax.tree.map(np.asarray, jp2)

    tp = params_from_jax(cfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    names, tensors = zip(*tp.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(t_step.make_loss_fn(cfg)(tp, tb)[0], tensors)))
    t_init, _ = t_optim.make_optimizer(ocfg, cfg)
    ts = t_init(tp)
    _, _, tm = t_step.make_train_step(cfg, ocfg)(tp, ts, tb)

    assert _rel(tm["loss"], loss_j) <= SCALAR_RTOL
    for key in ("lr", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= SCALAR_RTOL, key
    for name, g in g_t.items():
        tol = HEAD_GRAD_RTOL if name.endswith(HEADS) else GRAD_RTOL
        assert _rel_fro(g.numpy(), _port_view(leaves, g_j, name)) <= tol, name
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
        f = ts["f"]["layers.*.a_log"]
        assert f["vr"].shape == (cfg.n_layers,) and f["vc"].shape == (cfg.n_ssm_heads,)
        for part in ("vr", "vc"):
            assert _rel_fro(f[part].numpy(), js["f"]["layers"]["a_log"][part]) <= DELTA_RTOL, part


def test_optimizer_rules_on_the_stacked_head_vectors(model):
    """Rule (a): with zero gradients only decay moves a tensor; the
    per-layer (H,) ``a_log``, ``d_skip`` and ``dt_bias`` are (L, H) leaves in
    the reference, so they decay; ``final_norm`` does not.  Rule (b):
    leaves whose last axis is no multiple of 32 keep bfloat16 int8-states."""
    cfg, tree, tp0 = model
    leaves = reference_leaves(cfg)
    assert leaves["layers.2.a_log"] == RefLeaf(("layers", "a_log"), 2, False, (cfg.n_layers, cfg.n_ssm_heads))
    assert leaves["layers.0.conv_w"].shape == (cfg.n_layers, cfg.d_conv, cfg.d_inner + 2 * cfg.d_state)
    tp = params_from_jax(cfg, tree, device="cpu")
    ocfg = t_optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    init, update = t_optim.make_optimizer(ocfg, cfg)
    zeros = {n: torch.zeros_like(p) for n, p in tp.named_parameters()}
    _, _, m = update(tp, zeros, init(tp))
    lr = float(m["lr"])
    got = dict(tp.named_parameters())
    for name in ("layers.0.a_log", "layers.3.d_skip", "layers.1.dt_bias", "layers.2.norm", "embed"):
        np.testing.assert_allclose(got[name].detach().numpy(), _port_view(leaves, tree, name) * (1 - lr * 0.1),
                                   rtol=1e-6, err_msg=name)
    assert torch.equal(got["final_norm"], tp0.final_norm)
    s8 = t_optim.make_optimizer(t_optim.OptConfig(state_dtype="int8"), cfg)[0](tp)
    assert s8["m"]["layers.0.a_log"].dtype == torch.bfloat16
    assert s8["m"]["layers.0.in_proj.weight"].dtype == torch.bfloat16
    assert t_optim._is_q8(s8["m"]["layers.0.out_proj.weight"])


# ---------------------------------------------------------------------------
# the parameters' layout, at the reduced and the published size
# ---------------------------------------------------------------------------


def test_reference_leaves_round_trip(model):
    """Every reference leaf is covered once, element for element, and each
    port tensor is its slice."""
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
    """mamba2-780m at its published size on the meta device: the
    reference's leaves, shapes and count (about 7.8e8, 3.1 GB as float32
    masters)."""
    cfg = get_config(ARCH)
    shapes, _ = j_abstract_init(j_get_config(ARCH))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    p = abstract_init(cfg)
    assert get_model(cfg) is t_ssm and len(p.layers) == 48 and all(t.is_meta for t in p.parameters())
    n = sum(t.numel() for t in p.parameters())
    assert n == n_ref and round(n / 1e8, 1) == 7.8
    assert shapes["layers"]["a_log"].shape == (48, 48) and reference_leaves(cfg)["layers.47.a_log"].layer == 47


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_and_resumes_bit_exact(tmp_path):
    """``python -m repro_torch.launch.train --arch mamba2_780m --reduced
    --device cpu``: run A takes 8 steps and its loss descends; run B is
    preempted after 4 (exit 42) and resumed; the final checkpoints are
    equal bit for bit."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    common = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced", "--steps", "8",
              "--global-batch", "4", "--seq-len", "48", "--lr", "3e-3", "--ckpt-every", "4", "--device", "cpu"]
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
    assert step_a == step_b == 8 and fa.keys() == fb.keys() and "opt/m/layers.0.a_log" in fa
    for key in fa:
        assert fa[key].dtype == fb[key].dtype and torch.equal(fa[key], fb[key]), key
