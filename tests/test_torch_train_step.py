"""The port's train step (``repro_torch.train.step``) and the backward pass
through its transformer, against the JAX package on the CPU.

The dense configs (qwen2, gemma3 with a window of 8 under S = 24,
starcoder2, qwen2.5), reduced, with the reference's weights carried across
by ``params_from_jax``; one AdamW step (float32 states) on the same batch:
4 rows of 24 tokens, two mask entries zero, ``xent_chunk`` 10, so the
cross entropy runs over chunks of 10, 10 and 4; ``microbatch`` 1 and 2.

Tolerances:
  * loss, ``xent``, ``grad_norm`` and ``lr``: relative 1e-5 (float32
    rounding of the same sums in other orders, over a few layers);
  * each tensor's gradient (of the mean of the slices' losses, as the
    step accumulates it): relative Frobenius distance 1e-5, every element
    counted (2e-6 is typical: float32 sums in other orders);
  * each tensor's update Δ: relative Frobenius distance 1e-3, over the
    elements whose two gradients agree to 1e-3 relative (all but 71-165
    of 149312-214080, under 0.1%; the test asks for 99%).  At step 1
    Adam's update is g / (|g| + eps) per element, about lr·sign(g): where
    the gradient element is a cancellation (the key biases' reach 5e-9:
    rope leaves them almost softmax-invariant), its rounding in another
    summation order is a large part of it, and the update can flip sign
    or move by O(lr); so a max-abs limit, or a Frobenius one over those
    elements, would measure the summation order.  Those elements are held
    by the gradients' distance above; on the rest an optimizer that
    differs shows at once;
  * attention gradients: max abs 1e-5, as the forward (``test_torch_lm``);
  * remat on and off: bit-equal (the recomputation runs the same ops).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.train import optim as j_optim
from repro.train import step as j_step

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import layers as t_layers
from repro_torch.models import params_from_jax, reference_leaves
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

DENSE = ["qwen2_1_5b", "gemma3_4b", "starcoder2_3b", "qwen2_5_14b"]
SCALAR_RTOL = 1e-5
DELTA_RTOL = 1e-3
GRAD_RTOL = 1e-5
LAYER_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker while this module runs (the other
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(cfg):
    arch = next(a for a in ARCH_IDS if get_config(a).name == cfg.name)
    return dataclasses.replace(j_get_config(arch), **dataclasses.asdict(cfg))


def _cfg(arch: str, micro: int = 1):
    kw = dict(microbatch=micro, xent_chunk=10)
    if arch == "gemma3_4b":
        kw["window"] = 8  # S = 24 > window: local layers mask whole tiles of some rows
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _ref_params(cfg, seed: int = 0):
    params, _ = j_init_params(_jcfg(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(a):
        a = np.asarray(a)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32) if not a.any() else a

    return jax.tree.map(perturb, params)


def _batch(cfg, b: int = 4, s: int = 24, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[1, 7] = mask[3, s - 1] = 0.0
    return {
        "tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
        "mask": mask,
    }


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_view(cfg, tree, name):
    leaf = reference_leaves(cfg)[name]
    a = tree
    for key in leaf.path:
        a = a[key]
    a = np.asarray(a)
    a = a[leaf.layer] if leaf.layer is not None else a
    return a.T if leaf.transposed else a


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_the_reference(arch, micro):
    cfg = _cfg(arch, micro)
    jcfg = _jcfg(cfg)
    tree = _ref_params(cfg)
    batch = _batch(cfg)
    ocfg = t_optim.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    j_ocfg = j_optim.OptConfig(**dataclasses.asdict(ocfg))
    jp = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tp = params_from_jax(cfg, tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    if micro == 1:  # the loss function alone: loss and xent over the whole batch
        loss_j, aux_j = j_step.make_loss_fn(jcfg)(jp, jb)
        loss_t, aux_t = t_step.make_loss_fn(cfg)(tp, tb)
        assert _rel(loss_t, loss_j) <= SCALAR_RTOL and _rel(aux_t["xent"], aux_j["xent"]) <= SCALAR_RTOL
        assert float(aux_t["aux"]) == 0.0

    # the gradient the step accumulates: the mean of the slices' losses
    per = batch["tokens"].shape[0] // micro
    slices = [slice(i * per, (i + 1) * per) for i in range(micro)]
    j_loss = j_step.make_loss_fn(jcfg)
    g_j = jax.jit(jax.grad(lambda p: sum(j_loss(p, {k: v[s] for k, v in jb.items()})[0] for s in slices) / micro))(jp)
    t_loss = t_step.make_loss_fn(cfg)
    names, tensors = zip(*tp.named_parameters())
    g_t = torch.autograd.grad(sum(t_loss(tp, {k: v[s] for k, v in tb.items()})[0] for s in slices) / micro, tensors)
    g_j = jax.tree.map(np.asarray, g_j)
    for name, g in zip(names, g_t):
        assert _rel_fro(g.numpy(), _port_view(cfg, g_j, name)) <= GRAD_RTOL, name

    j_init, _ = j_optim.make_optimizer(j_ocfg)
    jp2, _, jm = jax.jit(j_step.make_train_step(jcfg, j_ocfg))(jp, j_init(jp), jb)
    t_init, _ = t_optim.make_optimizer(ocfg, cfg)
    ts = t_init(tp)
    tp2, ts2, tm = t_step.make_train_step(cfg, ocfg)(tp, ts, tb)
    assert tp2 is tp and ts2 is ts and int(ts["step"]) == 1
    for key in ("loss", "lr", "grad_norm"):
        assert _rel(tm[key], jm[key]) <= SCALAR_RTOL, (key, float(tm[key]), float(jm[key]))
    excluded = 0
    for name, p in tp.named_parameters():
        before = _port_view(cfg, tree, name).astype(np.float64)
        d_t = p.detach().numpy() - before
        d_j = _port_view(cfg, jax.tree.map(np.asarray, jp2), name) - before
        g = _port_view(cfg, g_j, name)
        well = np.abs(g_t[names.index(name)].numpy() - g) <= 1e-3 * np.abs(g)
        excluded += int((~well).sum())
        assert np.isfinite(d_t).all()
        assert _rel_fro(d_t[well], d_j[well]) <= DELTA_RTOL, (name, _rel_fro(d_t[well], d_j[well]))
    assert excluded <= 1e-2 * sum(p.numel() for p in tp.parameters()), excluded


def test_masked_mean_and_ragged_chunks():
    """``xent_chunked`` is ``tot / max(cnt, 1)`` whatever the chunk: the
    same loss with chunks of 5, 7 and the whole sequence, and a fully
    masked batch gives 0, not NaN."""
    cfg = _cfg("qwen2_1_5b")
    tp = params_from_jax(cfg, _ref_params(cfg), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    losses = [t_step.make_loss_fn(dataclasses.replace(cfg, xent_chunk=c))(tp, tb)[0] for c in (5, 7, 24, 512)]
    for loss in losses[1:]:
        assert _rel(loss, losses[0]) <= SCALAR_RTOL
    tb["mask"] = torch.zeros_like(tb["mask"])
    assert float(t_step.make_loss_fn(cfg)(tp, tb)[0]) == 0.0
    del tb["mask"]  # no mask: every position counts
    want = j_step.make_loss_fn(_jcfg(cfg))(jax.tree.map(jnp.asarray, _ref_params(cfg)),
                                           {k: jnp.asarray(v.numpy()) for k, v in tb.items()})[0]
    assert _rel(t_step.make_loss_fn(cfg)(tp, tb)[0], want) <= SCALAR_RTOL


def test_microbatches_must_divide_the_batch():
    cfg = _cfg("qwen2_1_5b", micro=3)
    tp = params_from_jax(cfg, _ref_params(cfg), device="cpu")
    ocfg = t_optim.OptConfig()
    state = t_optim.make_optimizer(ocfg, cfg)[0](tp)
    with pytest.raises(ValueError, match="microbatches"):
        t_step.make_train_step(cfg, ocfg)(tp, state, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "gemma3_4b"])
def test_remat_is_bit_equal(arch):
    """``cfg.remat`` checkpoints each layer: the loss and every gradient
    are the same bits with it on and off."""
    base = _cfg(arch)
    tp = params_from_jax(base, _ref_params(base), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(base).items()}
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        loss, _ = t_step.make_loss_fn(cfg)(tp, tb)
        out[remat] = (loss, torch.autograd.grad(loss, list(tp.parameters())))
    assert torch.equal(out[True][0], out[False][0])
    for (name, _), a, b in zip(tp.named_parameters(), out[True][1], out[False][1]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("window", [0, 4])
def test_attention_gradients_match_the_reference(window):
    """The backward of the chunked online softmax: ragged chunks both ways,
    GQA, a window (gemma3's local layers) and a kv_valid mask, with query
    rows whose keys are all masked in a tile and in every tile; the
    gradients are finite and equal the reference's vjp."""
    rng = np.random.default_rng(11 + window)
    b, sq, sk, hq, hkv, dh = 2, 13, 17, 4, 2, 8
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, dh)).astype(np.float32)
    ct = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    q_pos = np.arange(4, 4 + sq, dtype=np.int32)
    k_pos = np.arange(sk, dtype=np.int32)
    valid = rng.random(sk) > 0.3
    valid[:5] = False  # the first query sees keys 0..4 only: all masked
    kw = dict(window=window, softcap=0.0, q_chunk=5, kv_chunk=7)

    def ref(q_, k_, v_):
        return j_layers.attention(q_, k_, v_, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                  kv_valid=jnp.asarray(valid), **kw)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_layers.attention(qt, kt, vt, q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
                             kv_valid=torch.from_numpy(valid), **kw)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(ct))
    for name, g, w in zip("qkv", got, want):
        assert torch.isfinite(g).all(), name
        err = float(np.max(np.abs(g.numpy() - np.asarray(w))))
        assert err <= LAYER_TOL, (name, err)
    assert float(got[0][:, 0].abs().max()) == 0.0  # the fully masked row takes no gradient
