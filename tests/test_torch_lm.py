"""The port's LM serving path against the JAX package, on the CPU.

Both packages get the same numpy inputs; weights are drawn by the
reference's own init (with its zero norms and biases perturbed, so that
``(1 + w)`` and the biases count) and carried across with
``repro_torch.models.params_from_jax``.  Everything runs in float32.

Tolerances (max abs):
  * layers (``rmsnorm``, ``rope``, ``attention``, ``mlp``): 1e-5, float32
    rounding of the same operations in another order;
  * ``forward`` + ``logits_fn``, ``prefill`` and each ``decode_step``
    against the reference's: 1e-4 (a few layers of 1e-5 each);
  * the port's decode against its own forward: 1e-3, the reference's
    own check (``tests/test_models_smoke.py``);
  * greedy tokens and the curation labels: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import dbcv as j_dbcv
from repro.core import multi as j_multi
from repro.models import get_model as j_get_model
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.serve import lm as j_lm
from repro.train import data as j_data

from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.core import dbcv as t_dbcv
from repro_torch.core import multi as t_multi
from repro_torch.models import get_model, init_params, params_from_jax
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.serve import lm as t_lm
from repro_torch.train import data as t_data

CPU = torch.device("cpu")
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
DECODE_TOL = 1e-3
DENSE = ["qwen2_1_5b", "qwen2_5_14b", "gemma3_4b", "starcoder2_3b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs: the plain
    versions are long chains of small elementwise ops, which torch's thread
    pool slows several times over on a CPU shared with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    err = float(np.max(np.abs(got.detach().numpy() - np.asarray(want)))) if got.numel() else 0.0
    assert err <= tol, f"{what}: max abs {err} > {tol}"


def _cfg(arch: str):
    cfg = get_config(arch).reduced()
    if arch == "gemma3_4b":
        cfg = dataclasses.replace(cfg, window=8)  # S = 24 > window
    return cfg


def _ref_params(cfg, seed: int = 0):
    """The reference's init, with its zero-initialised leaves (norms and
    biases) perturbed; numpy pytree."""
    params, _ = j_init_params(_jcfg(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.asarray(a)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree.map(perturb, params)


def _jcfg(cfg):
    """The reference's ``ModelConfig`` with the port config's fields."""
    arch = next(a for a in ARCH_IDS if get_config(a).name == cfg.name)
    return dataclasses.replace(j_get_config(arch), **dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference():
    ports = all_configs()
    assert list(ports) == ARCH_IDS
    for arch, cfg in ports.items():
        ref = j_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert cfg.padded_vocab == ref.padded_vocab
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced()), arch
    assert get_config("qwen2_1_5b").padded_vocab == 152064 and get_config("gemma3-4b").name == "gemma3-4b"
    with pytest.raises(KeyError):
        get_config("gpt2")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    _close(t_layers.rmsnorm(_t(x), _t(w)), j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w)), LAYER_TOL, "rmsnorm")
    pos = np.array([[0, 1, 2, 5, 9, 40, 1000]], np.int32)
    for theta in (1e4, 1e6):
        want = j_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(t_layers.rope(_t(x), _t(pos), theta), want, LAYER_TOL, f"rope theta={theta}")
    want = j_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, rotary_dim=8)
    _close(t_layers.rope(_t(x), _t(pos), 1e4, rotary_dim=8), want, LAYER_TOL, "partial rope")


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_attention_matches_ragged_chunks_windows_gqa(window, softcap):
    """Ragged chunks both ways (13 queries in chunks of 5, 17 keys in 7),
    GQA with g = 2, a window, a softcap and a kv_valid mask (including a
    query row whose keys are all masked)."""
    rng = np.random.default_rng(1 + window)
    b, sq, sk, hq, hkv, dh = 2, 13, 17, 4, 2, 8
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    q_pos = np.arange(4, 4 + sq, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    valid = rng.random(sk) > 0.3
    valid[:5] = False  # the first query sees keys 0..4 only: all masked
    kw = dict(window=window, softcap=softcap, q_chunk=5, kv_chunk=7)
    for kv_valid in (None, valid):
        want = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                                  k_pos=jnp.asarray(k_pos),
                                  kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
        got = t_layers.attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos), k_pos=_t(k_pos),
                                 kv_valid=None if kv_valid is None else _t(kv_valid), **kw)
        _close(got, want, LAYER_TOL, f"attention window={window} softcap={softcap}")
    # the default chunks (one chunk each way here)
    want = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
                              k_pos=jnp.asarray(k_pos), window=window)
    _close(t_layers.attention(_t(q), _t(k), _t(v), q_pos=_t(q_pos), k_pos=_t(k_pos), window=window), want,
           LAYER_TOL, "attention, default chunks")


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "gemma3_4b", "starcoder2_3b"])
def test_mlp_matches(arch):
    """swiglu (qwen2), geglu with tanh gelu (gemma3), gelu with biases
    (starcoder2)."""
    cfg = _cfg(arch)
    p, _ = j_layers.init_mlp(jax.random.PRNGKey(3), _jcfg(cfg), cfg.d_ff)
    rng = np.random.default_rng(3)
    p = {k: np.asarray(v) + (rng.normal(0, 0.1, np.shape(v)) if not np.asarray(v).any() else 0) for k, v in p.items()}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    mod = t_layers.MLP(cfg, cfg.d_ff, None, torch.device("meta"))
    state = {"wi.weight": _t(p["wi"].T), "wo.weight": _t(p["wo"].T)}
    if "bi" in p:
        state.update({"wi.bias": _t(p["bi"]), "wo.bias": _t(p["bo"])})
    mod.load_state_dict(state, assign=True)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = j_layers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), _jcfg(cfg), cfg.d_ff)
    _close(t_layers.mlp(mod, _t(x), cfg, cfg.d_ff), want, LAYER_TOL, f"mlp {cfg.act}")


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """Per dense arch: (cfg, reference params as jnp, port params)."""
    out = {}
    for arch in DENSE:
        cfg = _cfg(arch)
        tree = _ref_params(cfg)
        out[arch] = (cfg, jax.tree.map(jnp.asarray, tree), params_from_jax(cfg, tree, device="cpu"))
    return out


def _tokens(cfg, b: int, s: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_logits_match(models, arch):
    cfg, jp, tp = models[arch]
    jm = j_get_model(_jcfg(cfg))
    toks = _tokens(cfg, 2, 24)
    h_j, _ = jm.forward(jp, _jcfg(cfg), jnp.asarray(toks))
    with torch.inference_mode():
        h_t, aux = t_tf.forward(tp, cfg, _t(toks))
        lg_t = t_tf.logits_fn(tp, cfg, h_t)
    _close(h_t, h_j, MODEL_TOL, f"{arch} hidden")
    _close(lg_t, jm.logits_fn(jp, _jcfg(cfg), h_j), MODEL_TOL, f"{arch} logits")
    assert float(aux) == 0.0 and lg_t.shape == (2, 24, cfg.padded_vocab)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference_and_the_forward(models, arch):
    """Prefill S = 24, then 5 decode steps (gemma3's ring buffers wrap):
    each step's logits against the reference's, and the decode against
    the port's own forward over the whole sequence."""
    cfg, jp, tp = models[arch]
    jcfg = _jcfg(cfg)
    jm = j_get_model(jcfg)
    s, t_steps = 24, 6
    toks = _tokens(cfg, 2, s + t_steps, seed=6)
    last_j, cache_j = jm.prefill(jp, jcfg, jnp.asarray(toks[:, :s]), max_len=s + t_steps, cache_dtype=jnp.float32)
    with torch.inference_mode():
        last_t, cache_t = t_tf.prefill(tp, cfg, _t(toks[:, :s]), max_len=s + t_steps, cache_dtype=torch.float32)
        _close(last_t, last_j, MODEL_TOL, f"{arch} prefill logits")
        for key in ("k", "v", "k_loc", "v_loc", "kpos_loc"):
            assert (key in cache_t) == (key in cache_j), key
            if key in cache_t:
                _close(cache_t[key].float(), np.asarray(cache_j[key], np.float32), MODEL_TOL, f"{arch} cache {key}")
        assert cache_t["pos"] == int(cache_j["pos"]) == s
        outs = [last_t]
        for t in range(t_steps - 1):
            cur = toks[:, s + t : s + t + 1]
            lg_j, cache_j = jm.decode_step(jp, jcfg, cache_j, jnp.asarray(cur))
            lg_t, cache_t = t_tf.decode_step(tp, cfg, cache_t, _t(cur))
            _close(lg_t, lg_j, MODEL_TOL, f"{arch} decode step {t}")
            outs.append(lg_t)
        serve = torch.stack(outs, dim=1)
        h, _ = t_tf.forward(tp, cfg, _t(toks))
        ref = t_tf.logits_fn(tp, cfg, h)[:, s - 1 : s + t_steps - 1]
    _close(serve, ref.numpy(), DECODE_TOL, f"{arch} decode vs forward")


def test_init_is_seeded_and_shaped():
    cfg = _cfg("qwen2_5_14b")
    a = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert a.embed.shape == a.unembed.shape == (cfg.padded_vocab, cfg.d_model)
    assert a.layers[0].attn.wq.weight.shape == (cfg.n_heads * cfg.d_head, cfg.d_model)
    assert float(a.layers[0].ln1.abs().sum()) == 0.0 and float(a.layers[0].attn.wq.bias.abs().sum()) == 0.0
    std = float(a.layers[0].mlp.wi.weight.std())
    assert abs(std * cfg.d_model**0.5 - 1.0) < 0.1 and abs(float(a.embed.std()) - 0.02) < 0.002


def test_later_families_raise_and_name_their_item():
    """Every arch builds: the encoder-decoder family, the SSM and recurrent
    families report their modules (their parity with the reference is
    ``test_torch_encdec``, ``test_torch_ssm`` and ``test_torch_griffin``),
    and so do the MoE, MLA and frontend transformers (``test_torch_moe``);
    an unknown arch raises and names the registered ones."""
    from repro_torch.models import encdec as t_encdec, griffin as t_griffin, ssm as t_ssm

    cfg = get_config("seamless_m4t_large_v2").reduced()
    p = init_params(cfg, torch.Generator(), device="cpu")
    assert get_model(cfg) is t_encdec and len(p.enc) == cfg.n_enc_layers and len(p.dec) == cfg.n_dec_layers
    assert {get_model(c).__name__.rsplit(".", 1)[1] for c in all_configs().values()} == {
        "transformer", "ssm", "griffin", "encdec"}
    with pytest.raises(ValueError, match="encdec"):
        get_model(dataclasses.replace(cfg, arch="nope"))

    for arch, module, stack in (("mamba2_780m", t_ssm, "layers"), ("recurrentgemma_2b", t_griffin, "period")):
        cfg = get_config(arch).reduced()
        p = init_params(cfg, torch.Generator(), device="cpu")
        assert get_model(cfg) is module and cfg.family in ("ssm", "hybrid") and hasattr(p, stack)
    for arch in ("deepseek_v2_lite_16b", "kimi_k2_1t_a32b", "llava_next_34b"):
        cfg = get_config(arch).reduced()
        p = init_params(cfg, torch.Generator(), device="cpu")
        assert get_model(cfg) is t_tf and len(p.layers) == cfg.n_layers
        assert (cfg.kv_lora > 0) == isinstance(p.layers[0].attn, t_layers.MLA)
        assert (cfg.n_experts > 0) == isinstance(getattr(p.layers[0], "moe", None), t_layers.MoE)
        assert bool(cfg.frontend) == hasattr(p, "proj_in")
    cfg = get_config("deepseek_v2_lite_16b").reduced()
    gen = torch.Generator().manual_seed(0)
    moe, mla = t_layers.init_moe(cfg, gen, CPU), t_layers.init_mla(cfg, gen, CPU)
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    with torch.inference_mode():
        out, aux = t_layers.moe(moe, x, cfg)
        q, ckv, kr = t_layers.mla_qkv(mla, x, torch.arange(5), cfg)
    assert out.shape == x.shape and float(aux) > 0
    assert q.shape == (2, 5, cfg.n_heads, cfg.qk_nope + cfg.qk_rope) and ckv.shape == (2, 5, cfg.kv_lora)
    assert kr.shape == (2, 5, cfg.qk_rope)


def test_lm_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch, models):
    cfg, _, tp = models["qwen2_1_5b"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_lm.Engine(cfg, tp, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(cfg, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_tf.init_cache(cfg, 2, 16)
    assert t_lm.Engine(cfg, tp, max_len=32, device="cpu").device == CPU
    cache = t_tf.init_cache(cfg, 2, 16, device="cpu")
    assert cache["pos"] == 0 and cache["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv, cfg.d_head)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The reference's serving fixture (reduced qwen2-1.5b, max_len 64)
    and the port's engine on the same weights."""
    cfg = get_config("qwen2_1_5b").reduced()
    jcfg = j_get_config("qwen2_1_5b").reduced()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    return j_lm.Engine(jcfg, params, max_len=64), t_lm.Engine(cfg, tp, max_len=64, device="cpu")


def test_greedy_tokens_equal_the_reference(engines):
    j_eng, t_eng = engines
    rng = np.random.default_rng(2)
    reqs = [dict(prompt=rng.integers(2, 500, size=n).astype(np.int32), max_new_tokens=m, temperature=0.0)
            for n, m in ((3, 8), (9, 12), (5, 4))]
    want = j_eng.generate([j_lm.GenRequest(**r) for r in reqs], seed=0)
    got = t_eng.generate([t_lm.GenRequest(**r) for r in reqs], seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t_eng.last_stats["tokens"] == sum(len(w) for w in want)
    assert t_eng.last_stats["batch_steps"] == j_eng.last_stats["batch_steps"]


def test_lm_mixed_temperature_batch(engines):
    """A batch applies each request's own temperature: a greedy row is
    the same alone and behind a hot row under two seeds."""
    _, eng = engines
    greedy = t_lm.GenRequest(prompt=np.array([0, 5, 9], np.int32), max_new_tokens=8, temperature=0.0)
    hot = t_lm.GenRequest(prompt=np.array([0, 7], np.int32), max_new_tokens=8, temperature=1.5)
    solo = eng.generate([greedy], seed=0)[0]
    m1 = eng.generate([hot, greedy], seed=1)
    m2 = eng.generate([hot, greedy], seed=2)
    np.testing.assert_array_equal(m1[1], solo)
    np.testing.assert_array_equal(m2[1], solo)
    assert not np.array_equal(m1[0], m2[0])


def test_lm_eos_masking_and_stats(engines):
    """Rows that hit EOS keep emitting EOS, and the stats count only the
    real tokens."""
    _, eng = engines
    base = t_lm.GenRequest(prompt=np.array([0, 5, 9], np.int32), max_new_tokens=8, temperature=0.0)
    eos_tok = int(eng.generate([base], seed=0)[0][0])
    early = t_lm.GenRequest(prompt=np.array([0, 5, 9], np.int32), max_new_tokens=8, temperature=0.0, eos_id=eos_tok)
    other = t_lm.GenRequest(prompt=np.array([0, 7, 4], np.int32), max_new_tokens=8, temperature=0.0)
    outs = eng.generate([early, other], seed=0)
    stats = eng.last_stats
    assert len(outs[0]) == 1 and outs[0][0] == eos_tok
    assert stats["tokens"] == len(outs[0]) + len(outs[1])
    assert stats["tok_per_s"] > 0
    np.testing.assert_array_equal(outs[1], eng.generate([other], seed=0)[0])


# ---------------------------------------------------------------------------
# the slice as a whole: embedding curation
# ---------------------------------------------------------------------------


def _curate(multi, dbcv, x):
    """Steps 3-4 of the curation example: labels per mpts, the DBCV
    choice and the keep list."""
    res = multi.multi_hdbscan(x, 24, variant="rng_star", **({"device": "cpu"} if multi is t_multi else {}))
    scores = {h.mpts: dbcv.dbcv_relative_validity(h.mst_ea, h.mst_eb, h.mst_w, h.labels) for h in res.hierarchies}
    best = max(scores, key=lambda k: scores[k])
    h = [hh for hh in res.hierarchies if hh.mpts == best][0]
    dup = h.mst_w < max(np.quantile(h.mst_w, 0.01), 1e-6)
    keep = np.ones(len(x), bool)
    keep[h.mst_eb[dup]] = False
    return {hh.mpts: hh.labels for hh in res.hierarchies}, best, keep


def test_embedding_curation_matches_the_reference():
    """The example's corpus (reduced qwen2-1.5b, 1200 documents of 48
    tokens, mean-pooled, 40 injected near-duplicates): embeddings agree to
    1e-4; fed the same (reference) embeddings, both packages give equal
    labels for every mpts, the same DBCV-chosen mpts and the same keep
    list."""
    cfg = get_config("qwen2_1_5b").reduced()
    jcfg = j_get_config("qwen2_1_5b").reduced()
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")
    jm = j_get_model(jcfg)
    dcfg_j = j_data.DataConfig(seed=9, vocab=cfg.vocab, seq_len=48, global_batch=8)
    dcfg_t = t_data.DataConfig(seed=9, vocab=cfg.vocab, seq_len=48, global_batch=8)
    embed = jax.jit(lambda p, toks: jnp.mean(jm.forward(p, jcfg, toks)[0], axis=1))
    e_j, e_t = [], []
    with torch.inference_mode():
        for step in range(150):
            bj, bt = j_data.train_batch(dcfg_j, step), t_data.train_batch(dcfg_t, step)
            np.testing.assert_array_equal(bt["tokens"].numpy(), np.asarray(bj["tokens"]))
            e_j.append(np.asarray(embed(params, bj["tokens"])))
            e_t.append(t_tf.forward(tp, cfg, bt["tokens"])[0].mean(dim=1).float().numpy())
    x_j, x_t = np.concatenate(e_j), np.concatenate(e_t)
    assert x_j.shape == (1200, cfg.d_model)
    assert float(np.max(np.abs(x_t - x_j))) <= MODEL_TOL
    x = x_j.astype(np.float32)
    x[-40:] = x[:40] + np.random.default_rng(0).normal(0, 1e-3, x[:40].shape)
    labels_j, best_j, keep_j = _curate(j_multi, j_dbcv, x)
    labels_t, best_t, keep_t = _curate(t_multi, t_dbcv, x)
    assert labels_t.keys() == labels_j.keys() == set(range(2, 25))
    for mpts in labels_j:
        np.testing.assert_array_equal(labels_t[mpts], labels_j[mpts], err_msg=f"mpts={mpts}")
    assert best_t == best_j
    np.testing.assert_array_equal(keep_t, keep_j)
