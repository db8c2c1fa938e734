"""The port's MoE and MLA transformer and the patch frontend against the JAX
package, on the CPU.

Reduced deepseek-v2-lite (MLA + MoE with shared experts), kimi-k2 (GQA +
MoE) and llava-next-34b (dense, 48-wide patches through ``proj_in`` and
``proj_mid``), in float32, with the reference's weights (zero leaves
perturbed) carried across by ``params_from_jax``.  The reference's
``abstract_init`` is compared for every config at its published size.

Tolerances (max abs, or relative where said):
  * layers (``moe``, ``mla_qkv``, ``mla_expand_kv``): 1e-5, float32
    rounding of the same operations in another order; ``aux`` relative
    1e-5; the experts' token choice ``idx`` equal;
  * ``forward`` + ``logits_fn``, ``prefill`` and each ``decode_step``:
    1e-4 (a few layers of 1e-5 each), as ``test_torch_lm``;
  * greedy tokens: equal;
  * the train step: as ``test_torch_train_step`` (loss, ``aux``, ``xent``,
    ``grad_norm`` relative 1e-5; gradients relative Frobenius 1e-5; the
    update relative Frobenius 1e-3 over the elements whose gradients agree
    to 1e-3, at least 99% of them); the int8 states' update 1e-2, the
    quantisation's step;
  * ``abstract_init``: shapes and dtypes equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import abstract_init as j_abstract_init
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.serve import lm as j_lm
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import abstract_init, get_model, init_params, params_from_jax, reference_leaves
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.serve import lm as t_lm
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
SCALAR_RTOL = 1e-5
GRAD_RTOL = 1e-5
DELTA_RTOL = 1e-3
MOE_ARCHS = ["deepseek_v2_lite_16b", "kimi_k2_1t_a32b", "llava_next_34b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs (the other
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    err = float(np.max(np.abs(got.detach().float().numpy() - np.asarray(want, np.float32))))
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _jcfg(cfg):
    arch = next(a for a in ARCH_IDS if get_config(a).name == cfg.name)
    return dataclasses.replace(j_get_config(arch), **dataclasses.asdict(cfg))


def _cfg(arch: str, **kw):
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _ref_params(cfg, seed: int = 0):
    """The reference's init (in the config's master dtype), its zero
    leaves (norms) perturbed in float32 and cast back; numpy pytree."""
    params, _ = j_init_params(_jcfg(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.asarray(a)
        if a.any():
            return a
        return np.asarray(jnp.asarray(rng.normal(0.0, 0.1, a.shape), jnp.float32).astype(a.dtype))

    return jax.tree.map(perturb, params)


def _patches(cfg, b: int, n: int, seed: int = 3):
    return np.random.default_rng(seed).normal(size=(b, n, cfg.frontend_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """Per arch: (cfg, reference params as jnp, port params)."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = _cfg(arch)
        tree = _ref_params(cfg)
        out[arch] = (cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(cfg, tree, device="cpu"))
    return out


def _tokens(cfg, b: int, s: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _moe_pair(cfg, seed: int = 0, tie_experts: bool = False):
    """Reference MoE params (jnp) and the port's module on them."""
    p, _ = j_layers.init_moe(jax.random.PRNGKey(seed), _jcfg(cfg))
    p = {k: np.array(v) for k, v in p.items()}
    if tie_experts:  # experts 0 and 1 share a router column: their gates tie on every token
        p["router"][:, 1] = p["router"][:, 0]
    mod = t_layers.MoE(cfg, None, torch.device("meta"))
    state = {"router.weight": _t(p["router"].T), "wi": _t(p["wi"]), "wo": _t(p["wo"])}
    if "shared_wi" in p:
        state.update({"shared_wi.weight": _t(p["shared_wi"].T), "shared_wo.weight": _t(p["shared_wo"].T)})
    mod.load_state_dict(state, assign=True, strict=True)
    return {k: jnp.asarray(v) for k, v in p.items()}, mod


@pytest.mark.parametrize("case", ["routed", "cap_below_routed", "tied_gates", "kimi"])
def test_moe_matches_the_reference(case, monkeypatch):
    """Outputs, ``aux`` and each expert's chosen tokens.  ``cap_below_routed``
    sets capacity_factor 0.25 (cap 2 for 24 tokens, 8 experts, top 2: most
    experts are routed more tokens than they take); ``tied_gates`` gives
    two experts one router column (every token's gates tie, so a token
    keeps three experts) and repeats tokens (equal gates down an expert's
    column: the lower token wins)."""
    arch = "kimi_k2_1t_a32b" if case == "kimi" else "deepseek_v2_lite_16b"
    cfg = _cfg(arch, **({"capacity_factor": 0.25} if case == "cap_below_routed" else {}))
    jp, mod = _moe_pair(cfg, tie_experts=case == "tied_gates")
    x = np.random.default_rng(7).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    if case == "tied_gates":
        x[1, 6:] = x[0, :6]
    calls = []
    real_top_k = jax.lax.top_k

    def spy(a, k):
        out = real_top_k(a, k)
        calls.append(out)
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    want, aux_j = j_layers.moe(jp, jnp.asarray(x), _jcfg(cfg))
    gsel_j, idx_j = calls[-1]  # the experts' top-C over the tokens
    got, aux_t = t_layers.moe(mod, _t(x), cfg)
    gsel_t, idx_t, _ = t_layers.moe_route(mod, _t(x).reshape(-1, cfg.d_model), cfg)
    cap = t_layers.moe_capacity(cfg, 24)
    assert idx_t.shape == (cfg.n_experts, cap) == idx_j.shape
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(gsel_t, gsel_j, LAYER_TOL, "gates taken")
    _close(got, want, LAYER_TOL, f"moe {case}")
    assert _rel(aux_t, aux_j) <= SCALAR_RTOL
    if case == "cap_below_routed":
        assert cap == 2 and int((np.asarray(gsel_j) > 0).sum()) < 24 * cfg.top_k
    if case == "tied_gates":
        assert float(gsel_t[:, 0].min()) > 0 and bool((np.asarray(idx_j)[:, 0] < 6).any())


def test_moe_capacity_depends_on_the_call():
    """deepseek-v2-lite as published: a decode step of 8 tokens leaves each
    expert one token (most routed tokens dropped), a 4096-token forward
    takes 480 a expert."""
    cfg = get_config("deepseek_v2_lite_16b")
    assert t_layers.moe_capacity(cfg, 8) == 1 and t_layers.moe_capacity(cfg, 4096) == 480
    assert t_layers.moe_capacity(cfg, 1) == 1


def test_mla_qkv_and_expand_kv_match():
    """``mla_qkv`` (rope on the last qk_rope dims of q and on the shared
    key) and ``mla_expand_kv``, also from a bfloat16 latent cache under
    float32 compute (the product promotes to float32, as in the
    reference)."""
    cfg = _cfg("deepseek_v2_lite_16b")
    p, _ = j_layers.init_mla(jax.random.PRNGKey(4), _jcfg(cfg))
    mod = t_layers.MLA(cfg, None, torch.device("meta"))
    mod.load_state_dict({f"{k}.weight": _t(np.asarray(v).T) for k, v in p.items()}, assign=True, strict=True)
    x = np.random.default_rng(4).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(3, 12, dtype=np.int32)
    q_j, ckv_j, kr_j = j_layers.mla_qkv(p, jnp.asarray(x), jnp.asarray(pos), _jcfg(cfg))
    q_t, ckv_t, kr_t = t_layers.mla_qkv(mod, _t(x), _t(pos), cfg)
    for name, g, w in (("q", q_t, q_j), ("ckv", ckv_t, ckv_j), ("k_rope", kr_t, kr_j)):
        assert g.shape == w.shape, name
        _close(g, w, LAYER_TOL, name)
    for cache_dt, j_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ckv_c, kr_c = ckv_j.astype(j_dt), kr_j.astype(j_dt)
        k_j, v_j = j_layers.mla_expand_kv(p, ckv_c, kr_c, _jcfg(cfg), jnp.float32)
        k_t, v_t = t_layers.mla_expand_kv(mod, _t(ckv_c.astype(jnp.float32)).to(cache_dt),
                                          _t(kr_c.astype(jnp.float32)).to(cache_dt), cfg, torch.float32)
        assert k_t.dtype == v_t.dtype == torch.float32 and k_t.shape == k_j.shape and v_t.shape == v_j.shape
        _close(k_t, k_j, LAYER_TOL, f"K from a {cache_dt} cache")
        _close(v_t, v_j, LAYER_TOL, f"V from a {cache_dt} cache")


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_logits_match(models, arch):
    cfg, jp, tp = models[arch]
    jcfg = _jcfg(cfg)
    toks = _tokens(cfg, 2, 20)
    pe = _patches(cfg, 2, 6) if cfg.frontend else None
    h_j, aux_j = j_get_model(jcfg).forward(jp, jcfg, jnp.asarray(toks), None if pe is None else jnp.asarray(pe))
    with torch.inference_mode():
        h_t, aux_t = t_tf.forward(tp, cfg, _t(toks), None if pe is None else _t(pe))
        lg_t = t_tf.logits_fn(tp, cfg, h_t)
    s = 20 + (6 if cfg.frontend else 0)
    assert h_t.shape == (2, s, cfg.d_model) and lg_t.shape == (2, s, cfg.padded_vocab)
    _close(h_t, h_j, MODEL_TOL, f"{arch} hidden")
    _close(lg_t, j_get_model(jcfg).logits_fn(jp, jcfg, h_j), MODEL_TOL, f"{arch} logits")
    if cfg.n_experts:
        assert float(aux_t) > 0 and _rel(aux_t, aux_j) <= SCALAR_RTOL
    else:
        assert float(aux_t) == float(aux_j) == 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_the_reference(models, arch):
    """Prefill (S = 16, after 6 patches for llava), then 5 decode steps:
    the caches (MLA's latent ``ckv``/``kr``) and every step's logits
    against the reference's, float32 caches."""
    cfg, jp, tp = models[arch]
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    s, t_steps = 16, 6
    toks = _tokens(cfg, 2, s + t_steps, seed=6)
    pe = _patches(cfg, 2, 6) if cfg.frontend else None
    s_all = s + (6 if cfg.frontend else 0)
    max_len = s_all + t_steps
    last_j, cache_j = jm.prefill(jp, jcfg, jnp.asarray(toks[:, :s]), max_len=max_len,
                                 patch_embeds=None if pe is None else jnp.asarray(pe), cache_dtype=jnp.float32)
    with torch.inference_mode():
        last_t, cache_t = t_tf.prefill(tp, cfg, _t(toks[:, :s]), max_len=max_len,
                                       patch_embeds=None if pe is None else _t(pe), cache_dtype=torch.float32)
        _close(last_t, last_j, MODEL_TOL, f"{arch} prefill logits")
        assert set(cache_t) == set(cache_j)
        assert cache_t["pos"] == int(cache_j["pos"]) == s_all
        for key in set(cache_t) - {"pos"}:
            _close(cache_t[key], np.asarray(cache_j[key], np.float32), MODEL_TOL, f"{arch} cache {key}")
        for t in range(t_steps - 1):
            cur = toks[:, s + t : s + t + 1]
            lg_j, cache_j = jm.decode_step(jp, jcfg, cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_tf.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"{arch} decode step {t}")
        if cfg.kv_lora:
            assert cache_t["ckv"].shape == (cfg.n_layers, 2, max_len, cfg.kv_lora)
            _close(cache_t["ckv"], np.asarray(cache_j["ckv"]), MODEL_TOL, f"{arch} latent cache after decoding")


def test_greedy_tokens_equal_the_reference():
    """``serve.lm.Engine`` on reduced deepseek-v2-lite (MLA, MoE): the
    greedy tokens equal the reference engine's.  The prompts have one
    length: left padding would give BOS rows whose hidden states are
    equal but for rounding (the attention over equal keys returns their
    value at every position), so their gates tie to the last bit and an
    expert's top-C among them follows each package's rounding."""
    cfg = get_config("deepseek_v2_lite_16b").reduced()
    jcfg = j_get_config("deepseek_v2_lite_16b").reduced()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    j_eng, t_eng = j_lm.Engine(jcfg, params, max_len=48), t_lm.Engine(cfg, tp, max_len=48, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(prompt=rng.integers(2, 500, size=7).astype(np.int32), max_new_tokens=m, temperature=0.0)
            for m in (8, 12, 4)]
    want = j_eng.generate([j_lm.GenRequest(**r) for r in reqs], seed=0)
    got = t_eng.generate([t_lm.GenRequest(**r) for r in reqs], seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t_eng.last_stats["batch_steps"] == j_eng.last_stats["batch_steps"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, b: int = 4, s: int = 12, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[1, 3] = 0.0
    out = {
        "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "mask": mask,
    }
    if cfg.frontend:
        out["patch_embeds"] = _patches(cfg, b, 5, seed + 1)
    return out


def _port_view(cfg, tree, name):
    leaf = reference_leaves(cfg)[name]
    a = tree
    for key in leaf.path:
        a = a[key]
    a = np.asarray(a, np.float32)
    a = a[leaf.layer] if leaf.layer is not None else a
    return a.T if leaf.transposed else a


def _step_both(cfg, tree, ocfg):
    """One train step in each package from the same parameters and batch:
    (port params after, reference params after (numpy), port metrics,
    reference metrics, port gradients, reference gradients)."""
    jcfg = _jcfg(cfg)
    batch = _batch(cfg)
    j_ocfg = j_optim.OptConfig(**dataclasses.asdict(ocfg))
    jp = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = params_from_jax(cfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g_j = jax.tree.map(np.asarray, jax.jit(jax.grad(lambda p: j_step.make_loss_fn(jcfg)(p, jb)[0]))(jp))
    names, tensors = zip(*tp.named_parameters())
    g_t = dict(zip(names, torch.autograd.grad(t_step.make_loss_fn(cfg)(tp, tb)[0], tensors)))
    j_init, _ = j_optim.make_optimizer(j_ocfg)
    jp2, _, jm = jax.jit(j_step.make_train_step(jcfg, j_ocfg))(jp, j_init(jp), jb)
    t_init, _ = t_optim.make_optimizer(ocfg, cfg)
    tp2, _, tm = t_step.make_train_step(cfg, ocfg)(tp, t_init(tp), tb)
    return tp2, jax.tree.map(np.asarray, jp2), tm, jm, g_t, g_j


@pytest.mark.parametrize("arch,opt,state", [
    ("deepseek_v2_lite_16b", "adamw", "float32"),
    ("deepseek_v2_lite_16b", "adamw", "int8"),
    ("deepseek_v2_lite_16b", "adafactor", "float32"),
    ("kimi_k2_1t_a32b", "adamw", "float32"),
    ("llava_next_34b", "adamw", "float32"),
])
def test_train_step_matches_the_reference(arch, opt, state):
    """Loss (with the MoE ``aux``), ``xent``, ``aux``, gradients and one
    update of AdamW (float32 and int8 states) and Adafactor; the int8
    blocks and Adafactor's factors run along the expert tensors' last two
    axes as in the reference."""
    cfg = _cfg(arch)
    jcfg = _jcfg(cfg)
    tree = _ref_params(cfg)
    batch = _batch(cfg)
    loss_j, m_j = j_step.make_loss_fn(jcfg)(jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    tp0 = params_from_jax(cfg, tree, device="cpu")
    with torch.no_grad():
        loss_t, m_t = t_step.make_loss_fn(cfg)(tp0, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(loss_t, loss_j) <= SCALAR_RTOL and _rel(m_t["xent"], m_j["xent"]) <= SCALAR_RTOL
    if cfg.n_experts:
        assert float(m_t["aux"]) > 0 and _rel(m_t["aux"], m_j["aux"]) <= SCALAR_RTOL
    ocfg = t_optim.OptConfig(name=opt, lr=1e-3, warmup_steps=1, total_steps=10, state_dtype=state)
    tp, jp2, tm, jm, g_t, g_j = _step_both(cfg, tree, ocfg)
    for name, g in g_t.items():
        assert _rel_fro(g.numpy(), _port_view(cfg, g_j, name)) <= GRAD_RTOL, name
    for key in ("loss", "lr", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= SCALAR_RTOL, key
    tol = 1e-2 if state == "int8" else DELTA_RTOL
    excluded = 0
    for name, p in tp.named_parameters():
        before = _port_view(cfg, tree, name).astype(np.float64)
        d_t, d_j = p.detach().numpy() - before, _port_view(cfg, jp2, name) - before
        g = _port_view(cfg, g_j, name)
        well = np.abs(g_t[name].numpy() - g) <= 1e-3 * np.abs(g)
        excluded += int((~well).sum())
        assert np.isfinite(d_t).all() and _rel_fro(d_t[well], d_j[well]) <= tol, name
    assert excluded <= 1e-2 * sum(p.numel() for p in tp.parameters()), excluded


def test_patch_loss_runs_over_the_text_positions(models):
    """llava: the hidden states cover [patches | text]; the loss is the
    cross entropy of the text positions only, as the reference's."""
    cfg, jp, tp = models["llava_next_34b"]
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss, metrics = t_step.make_loss_fn(cfg)(tp, tb)
        h, _ = t_tf.forward(tp, cfg, tb["tokens"], tb["patch_embeds"])
        assert h.shape[1] == 5 + 12
        lg = t_tf.logits_fn(tp, cfg, h[:, 5:]).double()
        nll = torch.logsumexp(lg, -1) - torch.gather(lg, -1, tb["labels"][..., None].long())[..., 0]
        want = float((nll * tb["mask"]).sum() / tb["mask"].sum())
    assert abs(float(loss) - want) <= 1e-5 * want and float(metrics["aux"]) == 0.0
    loss_j, _ = j_step.make_loss_fn(_jcfg(cfg))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert _rel(loss, loss_j) <= SCALAR_RTOL


def test_optimizer_rules_on_the_expert_tensors():
    """The expert tensors are (E, d, 2f) and (E, f, d) slices of the
    reference's (L, E, d, 2f) leaves: weight decay applies, int8 blocks of
    32 run along their last axis, Adafactor factors their last two axes
    per expert."""
    cfg = _cfg("deepseek_v2_lite_16b")
    tp = params_from_jax(cfg, _ref_params(cfg), device="cpu")
    leaves = reference_leaves(cfg)
    wi = leaves["layers.0.moe.wi"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    assert wi.shape == (cfg.n_layers, e, d, 2 * f) and not wi.transposed and wi.path == ("layers", "moe", "wi")
    assert leaves["layers.1.moe.router.weight"].shape == (cfg.n_layers, d, e)
    s8 = t_optim.make_optimizer(t_optim.OptConfig(state_dtype="int8"), cfg)[0](tp)
    assert s8["m"]["layers.0.moe.wi"]["q"].shape == (e, d, 2 * f)
    assert s8["m"]["layers.0.moe.wi"]["scale"].shape == (e, d, 2 * f // 32)
    af = t_optim.make_optimizer(t_optim.OptConfig(name="adafactor"), cfg)[0](tp)
    assert af["f"]["layers.0.moe.wo"]["vr"].shape == (e, f) and af["f"]["layers.0.moe.wo"]["vc"].shape == (e, d)


# ---------------------------------------------------------------------------
# sizes at the published configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_init_matches_the_reference(arch):
    """The meta-device parameters of every config at its published size
    have the reference's leaves, shapes and master dtypes (kimi-k2:
    1.045e12 parameters in bfloat16; the SSM and recurrent families and
    the encoder-decoder's two stacks too: seamless's 1633724416)."""
    cfg = get_config(arch)
    shapes, _ = j_abstract_init(j_get_config(arch))
    p = abstract_init(cfg)
    leaves = reference_leaves(cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        want[tuple(k.key for k in path)] = leaf
    got = {}
    for name, t in p.named_parameters():
        assert t.is_meta and t.dtype == getattr(torch, cfg.param_dtype), name
        leaf = leaves[name]
        got.setdefault(leaf.path, []).append((leaf, t))
    assert set(got) == set(want)
    for path, items in got.items():
        leaf = items[0][0]
        assert leaf.shape == tuple(want[path].shape) and str(want[path].dtype) == cfg.param_dtype, path
        sl = leaf.shape[1:] if leaf.layer is not None else leaf.shape
        for _, t in items:
            assert tuple(t.shape) == (sl[::-1] if leaf.transposed else sl), path
    n = sum(t.numel() for t in p.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in want.values())
    if arch == "deepseek_v2_lite_16b":
        assert round(n / 1e10, 3) == 1.621
    if arch == "kimi_k2_1t_a32b":
        assert round(n / 1e12, 3) == 1.045
    if arch == "seamless_m4t_large_v2":
        assert n == 1633724416


# ---------------------------------------------------------------------------
# bfloat16 masters (cfg.param_dtype)
# ---------------------------------------------------------------------------


def _kimi_bf16():
    """kimi-k2 reduced with its own bfloat16 masters restored (``reduced``
    sets float32)."""
    return _cfg("kimi_k2_1t_a32b", param_dtype="bfloat16")


def test_init_params_honours_param_dtype():
    cfg = _kimi_bf16()
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j_tree, _ = j_init_params(_jcfg(cfg), jax.random.PRNGKey(0))
    j_leaves = {tuple(k.key for k in path): v for path, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    leaves = reference_leaves(cfg)
    for name, t in p.named_parameters():
        leaf = leaves[name]
        assert t.dtype == torch.bfloat16 and str(j_leaves[leaf.path].dtype) == "bfloat16", name
        assert tuple(j_leaves[leaf.path].shape) == leaf.shape, name
    std = float(p.layers[0].moe.wi.float().std())
    assert abs(std * cfg.n_experts**0.5 - 1.0) < 0.1  # the reference's 1/sqrt(E) expert scale
    assert all(t.dtype == torch.float32 for t in init_params(_cfg("kimi_k2_1t_a32b"), torch.Generator(),
                                                               device="cpu").parameters())


def test_params_from_jax_keeps_bfloat16():
    cfg = _kimi_bf16()
    tree = _ref_params(cfg)
    tp = params_from_jax(cfg, tree, device="cpu")
    for name, t in tp.named_parameters():
        assert t.dtype == torch.bfloat16, name
        want = _port_view(cfg, tree, name)  # float32 view of the bfloat16 leaf: exact
        np.testing.assert_array_equal(t.detach().float().numpy(), want, err_msg=name)


def test_bfloat16_master_step_matches_the_reference():
    """One AdamW step on bfloat16 masters: the update is computed in
    float32 and cast back, as the reference does; the new masters equal
    the reference's but where the float32 update sits on a bfloat16
    rounding boundary (at most 1%), and no master stays unmoved where the
    reference's moved."""
    cfg = _kimi_bf16()
    tree = _ref_params(cfg)
    ocfg = t_optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tp, jp2, tm, jm, g_t, g_j = _step_both(cfg, tree, ocfg)
    for key in ("loss", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= SCALAR_RTOL, key
    total = differ = 0
    for name, p in tp.named_parameters():
        assert p.dtype == torch.bfloat16
        got, want = p.detach().float().numpy(), _port_view(cfg, jp2, name)
        assert _rel_fro(g_t[name].float().numpy(), _port_view(cfg, g_j, name)) <= 1e-2, name
        total += got.size
        differ += int((got != want).sum())
    assert differ <= 1e-2 * total, (differ, total)


def test_bfloat16_master_checkpoint_roundtrip(tmp_path):
    from repro_torch.train import checkpoint as ckpt

    cfg = _kimi_bf16()
    tp = params_from_jax(cfg, _ref_params(cfg), device="cpu")
    state = t_optim.make_optimizer(t_optim.OptConfig(state_dtype="int8"), cfg)[0](tp)
    ckpt.save(str(tmp_path), 3, {"params": dict(tp.named_parameters()), "opt": state})
    back, step = ckpt.restore(str(tmp_path))
    assert step == 3
    p2 = get_model(cfg).skeleton(cfg)
    p2.load_state_dict(back["params"], assign=True, strict=True)
    for (name, a), (_, b) in zip(tp.named_parameters(), p2.named_parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a.detach(), b), name
    assert back["opt"]["m"]["layers.0.moe.wi"]["q"].dtype == torch.int8
