"""The port's encoder-decoder family (seamless-m4t) against the JAX
package, on the CPU.

Both packages get the same numpy inputs; weights are drawn by the
reference's own init (its zero norms and MLP biases perturbed, so that
they count) and carried across with ``repro_torch.models.params_from_jax``.
Everything runs in float32 on the reduced seamless-m4t-large-v2 (2 + 2
layers, d = 64, 4 heads and 2 KV heads: GQA, vocab 512, frames of 48),
and one forward at the published width (d = 1024, 16 heads and 16 KV
heads, d_ff 8192, frames of 1024) with 1 + 1 layers and vocab 512.

Tolerances:
  * ``encode``, ``forward`` + ``logits_fn``, ``prefill`` and each
    ``decode_step`` against the reference's, and the caches: max abs 1e-4
    (float32 rounding of the same operations in another order, a few
    layers of 1e-5 each); at the published width 2e-4 (1024- and
    8192-deep sums);
  * the port's decode against its own teacher-forced forward: 1e-3 (the
    reference's ``tests/test_models_smoke.py``);
  * the write at ``pos >= dec_len``: the other slots bit-equal, the last
    slot holding the new key to 1e-5;
  * one train step: loss, ``lr`` and ``grad_norm`` relative 1e-5,
    gradients 1e-5 relative Frobenius, each tensor's update 1e-3 over the
    elements whose gradients agree to 1e-3, as ``tests/test_torch_ssm.py``
    holds mamba2's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import get_config
from repro_torch.models import RefLeaf, abstract_init, get_model, init_params, params_from_jax, reference_leaves
from repro_torch.models import encdec as t_ed
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ARCH = "seamless_m4t_large_v2"
MODEL_TOL = 1e-4
WIDE_TOL = 2e-4
DECODE_TOL = 1e-3
SCALAR_RTOL = 1e-5
GRAD_RTOL = 1e-5
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


def _frames(cfg, b: int, s: int, seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)


def _tokens(cfg, b: int, s: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).reduced()
    assert (cfg.n_enc_layers, cfg.n_dec_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.vocab) == (2, 2, 64, 4, 2, 512)
    tree = _ref_params(cfg)
    return cfg, tree, params_from_jax(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# encode, forward, logits and the cache
# ---------------------------------------------------------------------------


def test_encode_forward_and_logits_match(model):
    """30 frames into the encoder, 12 decoder tokens: GQA (4 heads over 2
    KV heads), bidirectional encoder attention, causal decoder attention
    and cross-attention without rope."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    frames, toks = _frames(cfg, 2, 30), _tokens(cfg, 2, 12)
    jt = jax.tree.map(jnp.asarray, tree)
    enc_j = jax.jit(lambda p, f: jm.encode(p, jcfg, f))(jt, jnp.asarray(frames))
    h_j, aux_j = jax.jit(lambda p, t, f: jm.forward(p, jcfg, t, f))(jt, jnp.asarray(toks), jnp.asarray(frames))
    with torch.inference_mode():
        enc_t = t_ed.encode(tp, cfg, _t(frames))
        h_t, aux = t_ed.forward(tp, cfg, _t(toks), _t(frames))
        lg_t = t_ed.logits_fn(tp, cfg, h_t)
    _close(enc_t, enc_j, MODEL_TOL, "encoder output")
    _close(h_t, h_j, MODEL_TOL, "decoder hidden")
    _close(lg_t, jm.logits_fn(jt, jcfg, h_j), MODEL_TOL, "logits")
    assert float(aux) == float(aux_j) == 0.0 and lg_t.shape == (2, 12, cfg.padded_vocab)


def test_init_cache_shapes_and_dtypes(monkeypatch, model):
    """``dec_len = max(1, int(max_len * dec_seq_frac))`` self slots, the
    encoder's K/V per decoder layer, as the reference's ``init_cache``."""
    cfg, _, _ = model
    jcfg = _jcfg(cfg)
    for max_len, enc_len in ((64, None), (10, 37), (3, 5)):
        want = j_get_model(jcfg).init_cache(jcfg, 3, max_len, enc_len=enc_len, dtype=jnp.bfloat16)
        got = t_ed.init_cache(cfg, 3, max_len, enc_len=enc_len, device="cpu")
        for key in ("k", "v", "xk", "xv"):
            assert tuple(got[key].shape) == want[key].shape and got[key].dtype == torch.bfloat16, key
        assert got["pos"] == int(want["pos"]) == 0
    assert t_ed.init_cache(cfg, 1, 3, device="cpu")["k"].shape[2] == 1  # int(0.75) -> at least one slot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ed.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_the_reference_and_the_forward(model):
    """Prefill over 26 frames (BOS = 0 decoded), then 9 decode steps
    inside ``dec_len`` = 12: the caches and each step's logits against the
    reference's, and the decode against the port's own forward over
    [BOS, tokens] (teacher forcing)."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    jt = jax.tree.map(jnp.asarray, tree)
    frames, toks = _frames(cfg, 2, 26, seed=6), _tokens(cfg, 2, 9, seed=7)
    max_len = 48  # dec_len 12
    last_j, cache_j = jm.prefill(jt, jcfg, jnp.asarray(frames), max_len, cache_dtype=jnp.float32)
    with torch.inference_mode():
        last_t, cache_t = t_ed.prefill(tp, cfg, _t(frames), max_len, cache_dtype=torch.float32)
        _close(last_t, last_j, MODEL_TOL, "prefill logits")
        for key in ("k", "v", "xk", "xv"):
            assert tuple(cache_t[key].shape) == cache_j[key].shape, key
            _close(cache_t[key], cache_j[key], MODEL_TOL, f"cache {key}")
        assert cache_t["pos"] == int(cache_j["pos"]) == 1
        k_cache = cache_t["k"]
        outs = [last_t]
        for t in range(toks.shape[1]):
            cur = toks[:, t : t + 1]
            lg_j, cache_j = jm.decode_step(jt, jcfg, cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_ed.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"decode step {t}")
            outs.append(lg_t)
        assert cache_t["k"] is k_cache and cache_t["pos"] == int(cache_j["pos"]) == 10  # written in place
        _close(cache_t["k"], cache_j["k"], MODEL_TOL, "self K after decoding")
        dec_in = np.concatenate([np.zeros((2, 1), np.int32), toks], axis=1)
        h, _ = t_ed.forward(tp, cfg, _t(dec_in), _t(frames))
        ref = t_ed.logits_fn(tp, cfg, h)
    _close(torch.stack(outs, dim=1), ref.numpy(), DECODE_TOL, "decode vs forward")


def test_the_write_at_dec_len_lands_in_the_last_slot(model):
    """``max_len`` = 16 gives 4 decoder slots: prefill takes slot 0, three
    steps slots 1-3, and the steps at ``pos`` = 4 and 5 write the last slot
    again (JAX's ``dynamic_update_slice`` clamps its start), attending over
    all 4 slots; logits and caches as the reference's."""
    cfg, tree, tp = model
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    jt = jax.tree.map(jnp.asarray, tree)
    frames, toks = _frames(cfg, 2, 8, seed=8), _tokens(cfg, 2, 5, seed=9)
    _, cache_j = jm.prefill(jt, jcfg, jnp.asarray(frames), 16, cache_dtype=jnp.float32)
    with torch.inference_mode():
        _, cache_t = t_ed.prefill(tp, cfg, _t(frames), 16, cache_dtype=torch.float32)
        assert cache_t["k"].shape[2] == 4
        for t in range(toks.shape[1]):
            before = cache_t["k"].clone()
            cur = toks[:, t : t + 1]
            lg_j, cache_j = jm.decode_step(jt, jcfg, cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_ed.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"step at pos {t + 1}")
            for key in ("k", "v"):
                _close(cache_t[key], cache_j[key], MODEL_TOL, f"{key} after the step at pos {t + 1}")
            slot = min(t + 1, 3)
            kept = [s for s in range(4) if s != slot]
            assert torch.equal(cache_t["k"][:, :, kept], before[:, :, kept])
            assert not torch.equal(cache_t["k"][:, :, slot], before[:, :, slot])
        assert cache_t["pos"] == int(cache_j["pos"]) == 6
        # the last write is the new token's key roped at pos 5
        h = t_ed.L.rmsnorm(tp.embed[_t(toks[:, -1:])], tp.dec[0].ln1)
        k_new, _ = t_ed._kv(tp.dec[0].self_attn, h, cfg, torch.tensor([5], dtype=torch.int32))
    _close(cache_t["k"][0, :, 3], k_new[:, 0].numpy(), 1e-5, "the last slot's key")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, b: int = 4, s_enc: int = 20, s_dec: int = 10, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s_dec), np.float32)
    mask[1, 3] = 0.0
    return {"frames": rng.normal(size=(b, s_enc, cfg.frontend_dim)).astype(np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab, (b, s_dec)).astype(np.int32),
            "dec_labels": rng.integers(0, cfg.vocab, (b, s_dec)).astype(np.int32), "dec_mask": mask}


@pytest.fixture(scope="module")
def ref_grads(model):
    """The reference's loss and gradients on ``_batch`` (jitted once)."""
    cfg, tree, _ = model
    jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    (loss, _), g = jax.jit(jax.value_and_grad(j_step.make_loss_fn(_jcfg(cfg)), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jb)
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_train_step_matches_the_reference(model, ref_grads, opt):
    """The port's ``train_step`` (loss, gradients, one update) against the
    reference's gradients and its optimizer's update on them; the ``enc``
    and ``dec`` stacks decay and factor as the reference's stacked leaves
    (Adafactor: one unit a stacked leaf, ``dec.*.mlp.wi.bias`` an (L, f)
    matrix)."""
    cfg, tree, _ = model
    loss_j, g_j = ref_grads
    leaves = reference_leaves(cfg)
    ocfg = t_optim.OptConfig(name=opt, lr=1e-3, warmup_steps=1, total_steps=10)
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
    excluded = 0
    for name, p in tp.named_parameters():
        before = _port_view(leaves, tree, name).astype(np.float64)
        d_t, d_j = p.detach().numpy() - before, _port_view(leaves, jp2, name) - before
        g = _port_view(leaves, g_j, name)
        well = np.abs(g_t[name].numpy() - g) <= 1e-3 * np.abs(g)
        excluded += int((~well).sum())
        assert np.isfinite(d_t).all() and _rel_fro(d_t[well], d_j[well]) <= DELTA_RTOL, name
    assert excluded <= 1e-2 * sum(p.numel() for p in tp.parameters()), excluded
    if opt == "adafactor":
        f = ts["f"]["dec.*.mlp.wi.bias"]
        assert f["vr"].shape == (cfg.n_dec_layers,) and f["vc"].shape == (cfg.d_ff,)
        for part in ("vr", "vc"):
            assert _rel_fro(f[part].numpy(), js["f"]["dec"]["mlp"]["bi"][part]) <= DELTA_RTOL, part


def test_reference_leaves_of_both_stacks(model):
    cfg, _, tp = model
    leaves = reference_leaves(cfg)
    d, f = cfg.d_model, cfg.d_ff
    hkv = cfg.n_kv * cfg.d_head
    assert leaves["enc.1.attn.wk.weight"] == RefLeaf(("enc", "attn", "wk"), 1, True, (2, d, hkv))
    assert leaves["dec.0.cross_attn.wq.weight"].path == ("dec", "cross_attn", "wq")
    assert leaves["dec.1.mlp.wi.bias"] == RefLeaf(("dec", "mlp", "bi"), 1, False, (2, f))
    assert leaves["dec.1.ln_x"] == RefLeaf(("dec", "ln_x"), 1, False, (2, d))
    assert leaves["proj_in.weight"] == RefLeaf(("proj_in",), None, True, (cfg.frontend_dim, d))
    assert leaves["unembed"] == RefLeaf(("unembed",), None, False, (cfg.padded_vocab, d))
    assert get_model(cfg) is t_ed and len(tp.enc) == len(tp.dec) == 2
    assert sum(t.numel() for t in abstract_init(cfg).parameters()) == sum(t.numel() for t in tp.parameters())


# ---------------------------------------------------------------------------
# the published width
# ---------------------------------------------------------------------------


def test_forward_at_the_published_width():
    """d = 1024, 16 heads and 16 KV heads, d_ff 8192, frames of 1024, at
    1 + 1 layers and vocab 512: encode and the decoder's logits over 16
    frames and 6 tokens, and prefill + 2 decode steps."""
    pub = get_config(ARCH)
    assert (pub.d_model, pub.n_heads, pub.n_kv, pub.d_ff, pub.frontend_dim) == (1024, 16, 16, 8192, 1024)
    cfg = dataclasses.replace(pub, n_layers=2, n_enc_layers=1, n_dec_layers=1, vocab=512, dtype="float32")
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    tree = _ref_params(cfg, seed=1)
    tp = params_from_jax(cfg, tree, device="cpu")
    jt = jax.tree.map(jnp.asarray, tree)
    frames, toks = _frames(cfg, 1, 16, seed=10), _tokens(cfg, 1, 6, seed=11)
    h_j, _ = jax.jit(lambda p, t, f: jm.forward(p, jcfg, t, f))(jt, jnp.asarray(toks), jnp.asarray(frames))
    last_j, cache_j = jm.prefill(jt, jcfg, jnp.asarray(frames), 24, cache_dtype=jnp.float32)
    steps_j = [last_j]
    for t in range(2):
        lg, cache_j = jm.decode_step(jt, jcfg, cache_j, jnp.asarray(toks[:, t : t + 1]))
        steps_j.append(lg)
    with torch.inference_mode():
        h_t, _ = t_ed.forward(tp, cfg, _t(toks), _t(frames))
        _close(t_ed.logits_fn(tp, cfg, h_t), jm.logits_fn(jt, jcfg, h_j), WIDE_TOL, "full-width logits")
        last_t, cache_t = t_ed.prefill(tp, cfg, _t(frames), 24, cache_dtype=torch.float32)
        steps_t = [last_t]
        for t in range(2):
            lg, cache_t = t_ed.decode_step(tp, cfg, cache_t, _t(toks[:, t : t + 1]))
            steps_t.append(lg)
    _close(torch.stack(steps_t, 1), np.stack([np.asarray(s) for s in steps_j], 1), WIDE_TOL, "full-width decode")
