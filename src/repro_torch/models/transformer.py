"""Decoder-only transformer, the port of ``repro/models/transformer.py``:
the dense configurations (qwen2-1.5b, qwen2.5-14b, gemma3-4b,
starcoder2-3b), MLA and MoE (deepseek-v2-lite; kimi-k2 with GQA and
MoE) and the patch frontend (llava-next-34b).  The SSM and recurrent
families are ``ssm`` and ``griffin``; the encoder-decoder family is still
to come.

The reference scans one layer body over stacked parameters; here the
layers are an ``nn.ModuleList`` walked in a Python loop, with the same
per-layer data:
  * mixed local:global attention (gemma3): per-layer windows and rope
    thetas (``_layer_windows_py``, ``_layer_thetas``); window <= 0 is
    unbounded;
  * GQA: query head h reads kv head h // g (``layers.attention``);
  * MLA (``cfg.kv_lora > 0``) and MoE (``cfg.n_experts > 0``), chosen per
    config; an MoE layer's ``aux`` loss is summed over the layers;
  * patches (``cfg.frontend == "patches"``): ``proj_in`` and ``proj_mid``
    map (B, P, frontend_dim) patch embeddings into the stream ahead of the
    text tokens, with tanh GELU between them (``jax.nn.gelu``'s default).

Training: the parameters are masters in ``cfg.param_dtype`` that require
gradients, and ``forward`` runs under autograd (``train.step`` takes the
gradient).  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` while a graph is being recorded, which
recomputes its activations in the backward pass, as
``jax.checkpoint(body)`` does in the reference.  The reference's
``_residual_barrier`` only steers XLA's scheduling (it keeps the float32
upcast of the residual stream inside the backward loop) and has no
counterpart: eager PyTorch hoists nothing.

KV cache (decode): a dict of stacked tensors, (L, B, Smax, Hkv, Dh) for
the global layers and (L, B, window, Hkv, Dh) ring buffers for the local
ones (slot = pos % window, ``kpos_loc`` starts at -2^30), or for MLA the
latent cache ``ckv`` (L, B, Smax, kv_lora) and ``kr`` (L, B, Smax,
qk_rope); and ``pos`` as a Python int.  ``decode_step`` writes the new
entries into the cache's tensors in place and returns the same dict,
where the reference returns a new pytree: a cache is never read again
after the step that advanced it.  Serving runs under
``torch.inference_mode()``, which records no graph.  An MoE layer's
expert capacity depends on the tokens of the call (``layers.moe_capacity``),
so a decode step of an MoE model drops more routed tokens than a forward
over the whole sequence and does not reproduce it, in the reference too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain, reshape, unflatten
from ..engine.plan import resolve_device
from . import layers as L

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _layer_windows_py(cfg) -> list[int]:
    """Per-layer window sizes: 0 => full causal."""
    w = []
    for i in range(cfg.n_layers):
        if cfg.window and cfg.window_period and (i + 1) % cfg.window_period == 0:
            w.append(0)  # global layer
        elif cfg.window:
            w.append(cfg.window)
        else:
            w.append(0)
    return w


def _layer_thetas(cfg) -> list[float]:
    t = []
    for i in range(cfg.n_layers):
        if cfg.rope_theta_global and cfg.window_period and (i + 1) % cfg.window_period == 0:
            t.append(cfg.rope_theta_global)
        else:
            t.append(cfg.rope_theta)
    return t


class Attention(nn.Module):
    def __init__(self, cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
        self.wq = L.linear(d, hq, generator, device, bias=cfg.qkv_bias, dtype=dtype)
        self.wk = L.linear(d, hkv, generator, device, bias=cfg.qkv_bias, dtype=dtype)
        self.wv = L.linear(d, hkv, generator, device, bias=cfg.qkv_bias, dtype=dtype)
        self.wo = L.linear(hq, d, generator, device, bias=False, dtype=dtype)


class Block(nn.Module):
    """``attn`` is MLA where ``cfg.kv_lora > 0``; ``moe`` replaces ``mlp``
    where ``cfg.n_experts > 0``."""

    def __init__(self, cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device, dtype)
        if cfg.kv_lora > 0:
            self.attn = L.init_mla(cfg, generator, device, dtype)
        else:
            self.attn = Attention(cfg, generator, device, dtype)
        if cfg.n_experts > 0:
            self.moe = L.init_moe(cfg, generator, device, dtype)
        else:
            self.mlp = L.init_mlp(cfg, cfg.d_ff, generator, device, dtype)


class Transformer(nn.Module):
    """The parameters: ``embed`` (padded_vocab, d), ``unembed`` when the
    embeddings are untied, ``final_norm``, the frontend's ``proj_in`` and
    ``proj_mid`` where there is one, and the ``layers``."""

    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.embed = nn.Parameter(
            L.dense_init((cfg.padded_vocab, d), generator, device, scale=0.02, dtype=dtype))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                L.dense_init((cfg.padded_vocab, d), generator, device, scale=0.02, dtype=dtype))
        self.final_norm = L.rmsnorm_init(d, device, dtype)
        if cfg.frontend:
            self.proj_in = L.linear(cfg.frontend_dim, d, generator, device, bias=False, dtype=dtype)
            self.proj_mid = L.linear(d, d, generator, device, bias=False, dtype=dtype)
        self.layers = nn.ModuleList(Block(cfg, generator, device, dtype) for _ in range(cfg.n_layers))


def init(cfg, generator: torch.Generator, device: torch.device) -> Transformer:
    """Random master parameters in ``cfg.param_dtype`` on ``device`` from
    ``generator`` (which lies on that device): embeddings normal * 0.02
    (``padded_vocab`` rows), dense weights normal / sqrt(fan_in) (the
    experts / sqrt(E)), norms and biases zero; each drawn in float32 and
    cast, as the reference casts its float32 init."""
    return Transformer(cfg, generator, torch.device(device), _dtype(cfg.param_dtype))


def skeleton(cfg) -> Transformer:
    """The parameter structure on the meta device in the master dtype,
    with no memory behind it: to load a state into
    (``load_state_dict(state, assign=True)``) or to reckon sizes."""
    return Transformer(cfg, None, torch.device("meta"), _dtype(cfg.param_dtype))


def ref_location(cfg, name: str):
    """(reference path, layer index or None, stacked count or None) of a
    port tensor: ``layers.3.attn.wq.bias`` -> (layers, attn, bq), 3, L."""
    if name.startswith("layers."):
        _, i, local = name.split(".", 2)
        return ("layers", *L.ref_path(local)), int(i), cfg.n_layers
    return L.ref_path(name), None, None


_ATTN_SPECS = {
    "wq": ("embed", "heads_dim"), "wk": ("embed", "kv_dim"), "wv": ("embed", "kv_dim"), "wo": ("heads_dim", "embed"),
    "bq": ("heads_dim",), "bk": ("kv_dim",), "bv": ("kv_dim",),
}
_TOP_SPECS = {"embed": L.EMBED_SPEC, "unembed": L.EMBED_SPEC, "final_norm": L.NORM_SPEC,
              "proj_in": ("frontend", "embed"), "proj_mid": ("embed", "embed2")}


def leaf_spec(cfg, path: tuple[str, ...]) -> tuple:
    """The reference's logical axis names of the leaf at ``path``, a layer's
    slice for a stacked leaf (no ``layers`` axis), in the reference's
    (in, out) order."""
    if path[0] != "layers":
        return _TOP_SPECS[path[0]]
    if len(path) == 2:  # ln1, ln2
        return L.NORM_SPEC
    group, leaf = path[1], path[2]
    if group == "attn":
        return (L.MLA_SPECS if cfg.kv_lora > 0 else _ATTN_SPECS)[leaf]
    return (L.MOE_SPECS if group == "moe" else L.mlp_specs(cfg))[leaf]


# tensors the reference uses in float32 whatever the compute dtype
_KEPT = ("ln1", "ln2", "final_norm", "router.weight")


def cast_for_compute(p: Transformer, cfg) -> Transformer:
    """A copy of ``p`` with every tensor the reference casts with
    ``.astype(cfg.dtype)`` (embeddings, dense and expert weights, biases)
    cast once, and the norms and the MoE router kept as they are (the
    router runs in float32 from its master).  The layers then use the
    cast tensors as they are, so the result is bit for bit that of casting
    at each use; a tensor already in ``cfg.dtype`` is shared, not copied."""
    dt = _dtype(cfg.dtype)
    state = {k: v if k.endswith(_KEPT) else v.to(dt) for k, v in p.state_dict().items()}
    out = skeleton(cfg)
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _qkv(pl: Block, h: torch.Tensor, cfg, positions: torch.Tensor, theta: float):
    """q (B, S, Hq, D) and k, v (B, S, Hkv, D) in h's dtype, rope applied."""
    ap = pl.attn
    q = unflatten(L.dense(ap.wq, h), -1, (cfg.n_heads, cfg.d_head))
    k = unflatten(L.dense(ap.wk, h), -1, (cfg.n_kv, cfg.d_head))
    v = unflatten(L.dense(ap.wv, h), -1, (cfg.n_kv, cfg.d_head))
    q = L.rope(q, positions[None, :], theta)
    k = L.rope(k, positions[None, :], theta)
    return q, k, v


def _attn_out(pl: Block, q, k_all, v_all, cfg, positions, window, k_pos, kv_valid) -> torch.Tensor:
    b, sq = q.shape[:2]
    o = L.attention(q, k_all, v_all, q_pos=positions, k_pos=k_pos, window=window, softcap=0.0, kv_valid=kv_valid)
    return reshape(o, (b, sq, cfg.n_heads * cfg.d_head)) @ pl.attn.wo.weight.to(q.dtype).T


def _mla_out(pl: Block, q, ckv_all, kr_all, cfg, positions, k_pos, kv_valid) -> torch.Tensor:
    """MLA attention over the latent ``ckv_all``/``kr_all``: V is padded
    up to the qk head dim for the shared ``attention`` and sliced back to
    ``v_head`` (the reference's way)."""
    b, sq = q.shape[:2]
    dt = q.dtype
    k, v = L.mla_expand_kv(pl.attn, ckv_all, kr_all, cfg, dt)
    v = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
    o = L.attention(q, k, v, q_pos=positions, k_pos=k_pos, window=0, kv_valid=kv_valid)[..., : cfg.v_head]
    return reshape(o, (b, sq, cfg.n_heads * cfg.v_head)) @ pl.attn.wo.weight.to(dt).T


def embed_inputs(p: Transformer, cfg, tokens: torch.Tensor, patch_embeds=None) -> torch.Tensor:
    """Token embeddings in the compute dtype; with a frontend and
    ``patch_embeds`` (B, P, frontend_dim), the projected patches come
    first: ``gelu_tanh(pe @ proj_in) @ proj_mid``."""
    dt = _dtype(cfg.dtype)
    x = L.embed_lookup(p.embed.to(dt), tokens)
    if cfg.frontend and patch_embeds is not None:
        pe = patch_embeds.to(dt) @ p.proj_in.weight.to(dt).T
        pe = F.gelu(pe, approximate="tanh") @ p.proj_mid.weight.to(dt).T
        x = torch.cat([pe, x], dim=1)
    return x


def _ffn(pl: Block, x: torch.Tensor, cfg):
    """The second half of a layer: x + MLP or MoE of rmsnorm(x), and the
    layer's aux loss (None without experts)."""
    h2 = L.rmsnorm(x, pl.ln2)
    if cfg.n_experts > 0:
        mo, aux = L.moe(pl.moe, h2, cfg)
        return x + mo, aux
    return x + L.mlp(pl.mlp, h2, cfg, cfg.d_ff), None


def _block(pl: Block, x: torch.Tensor, cfg, positions: torch.Tensor, window: int, theta: float):
    """One layer over a full sequence -> (x, its cache entries, aux): the
    cache entries are (k, v), or (ckv, k_rope) for MLA."""
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    h = L.rmsnorm(x, pl.ln1)
    if cfg.kv_lora > 0:
        q, ckv, kr = L.mla_qkv(pl.attn, h, positions, cfg)
        x = x + _mla_out(pl, q, ckv, kr, cfg, positions, positions, None)
        kv = (ckv, kr)
    else:
        q, k, v = _qkv(pl, h, cfg, positions, theta)
        x = x + _attn_out(pl, q, k, v, cfg, positions, window, positions, None)
        kv = (k, v)
    x, aux = _ffn(pl, x, cfg)
    return x, kv, aux


def _layers(p: Transformer, cfg, x: torch.Tensor, collect_kv: bool):
    """The layer stack over a full sequence -> (normed x, each layer's
    cache entries if ``collect_kv``, the summed aux loss).  Under
    ``cfg.remat``, while autograd records, each layer is checkpointed (its
    activations recomputed in the backward)."""
    s_len = x.shape[1]
    positions = torch.arange(s_len, dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for pl, w, th in zip(p.layers, _layer_windows_py(cfg), _layer_thetas(cfg)):
        if remat:
            # the layer goes in as an argument, not a closure over the loop
            # variable: the recomputation runs after the loop has moved on
            x, kv, a = checkpoint(_block, pl, x, cfg, positions, w, th, use_reentrant=False)
        else:
            x, kv, a = _block(pl, x, cfg, positions, w, th)
        if a is not None:
            aux = aux + a
        if collect_kv:
            kvs.append(kv)
    return L.rmsnorm(x, p.final_norm), kvs, aux


def forward(p: Transformer, cfg, tokens: torch.Tensor, patch_embeds=None):
    """Full-sequence forward -> final hidden states (B, S, D), S counting
    the patch positions first where there are patches, and the aux loss
    summed over the MoE layers (0 without experts)."""
    x = embed_inputs(p, cfg, tokens, patch_embeds)
    x, _, aux = _layers(p, cfg, x, collect_kv=False)
    return x, aux


def logits_fn(p: Transformer, cfg, x: torch.Tensor) -> torch.Tensor:
    emb = p.embed if cfg.tie_embeddings else p.unembed
    logits = x @ emb.to(x.dtype).T
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _cache_layout(cfg, max_len: int):
    """Static split of layers into ring-buffer (local window) and
    full-length (global) cache groups."""
    windows = _layer_windows_py(cfg)
    is_local = [0 < w < max_len for w in windows]
    loc_idx, glob_idx = [], []
    nl = ng = 0
    for ll in is_local:
        loc_idx.append(nl if ll else 0)
        glob_idx.append(0 if ll else ng)
        nl += int(ll)
        ng += int(not ll)
    win = min(cfg.window if cfg.window else max_len, max_len)
    return is_local, loc_idx, glob_idx, nl, ng, max(win, 1)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty cache on ``device`` (default the card, which raises without
    one unless ``device="cpu"``): the latent cache for MLA, else KV with
    ring buffers for the local layers."""
    device = resolve_device(device)
    if cfg.kv_lora > 0:
        return {
            "ckv": torch.zeros((cfg.n_layers, batch, max_len, cfg.kv_lora), dtype=dtype, device=device),
            "kr": torch.zeros((cfg.n_layers, batch, max_len, cfg.qk_rope), dtype=dtype, device=device),
            "pos": 0,
        }
    _, _, _, nl, ng, win = _cache_layout(cfg, max_len)
    hkv, dh = cfg.n_kv, cfg.d_head
    cache: dict = {"pos": 0}
    if nl:
        cache["k_loc"] = torch.zeros((nl, batch, win, hkv, dh), dtype=dtype, device=device)
        cache["v_loc"] = torch.zeros((nl, batch, win, hkv, dh), dtype=dtype, device=device)
        cache["kpos_loc"] = torch.full((win,), -(2**30), dtype=torch.int32, device=device)
    if ng:
        cache["k"] = torch.zeros((ng, batch, max_len, hkv, dh), dtype=dtype, device=device)
        cache["v"] = torch.zeros((ng, batch, max_len, hkv, dh), dtype=dtype, device=device)
    return cache


def _decode_mla(p: Transformer, cfg, cache: dict, x: torch.Tensor, positions: torch.Tensor, pos: int):
    """The layers of one MLA decode step over the latent cache."""
    max_len = cache["ckv"].shape[2]
    k_pos = torch.arange(max_len, dtype=torch.int32, device=x.device)
    valid = k_pos <= pos
    for i, pl in enumerate(p.layers):
        h = L.rmsnorm(x, pl.ln1)
        q, ckv_new, kr_new = L.mla_qkv(pl.attn, h, positions, cfg)
        ckv, kr = cache["ckv"][i], cache["kr"][i]
        ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
        kr[:, pos] = kr_new[:, 0].to(kr.dtype)
        x = x + _mla_out(pl, q, ckv, kr, cfg, positions, k_pos, valid)
        x, _ = _ffn(pl, x, cfg)
    return x


def decode_step(p: Transformer, cfg, cache: dict, cur_tokens: torch.Tensor):
    """One decode step.  cur_tokens: (B, 1).  Returns (logits (B, V), cache).

    Local-window layers read and write a ring buffer (slot = pos % window);
    global layers keep the full-length cache; MLA layers the latent one.
    The cache's tensors are updated in place.
    """
    dt = _dtype(cfg.dtype)
    pos = int(cache["pos"])
    x = L.embed_lookup(p.embed.to(dt), cur_tokens)  # (B, 1, D)
    dev = x.device
    # a fill, not a copy from host memory: a step makes no host sync of its own
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    if cfg.kv_lora > 0:
        x = _decode_mla(p, cfg, cache, x, positions, pos)
        x = L.rmsnorm(x, p.final_norm)
        cache["pos"] = pos + 1
        return logits_fn(p, cfg, x)[:, 0], cache
    if "k" in cache:
        max_len = cache["k"].shape[2]
    else:
        # ring-only cache: any max_len above the window reproduces the layout
        max_len = cache["k_loc"].shape[2] + 1
    is_local, loc_idx, glob_idx, nl, ng, win = _cache_layout(cfg, max_len)
    if nl:
        slot = pos % win
        cache["kpos_loc"][slot] = pos
        loc_valid = cache["kpos_loc"] >= 0
    if ng:
        k_pos_g = torch.arange(max_len, dtype=torch.int32, device=dev)
        g_valid = k_pos_g <= pos

    for i, (pl, w, th) in enumerate(zip(p.layers, _layer_windows_py(cfg), _layer_thetas(cfg))):
        h = L.rmsnorm(x, pl.ln1)
        q, k_new, v_new = _qkv(pl, h, cfg, positions, th)
        if is_local[i]:
            kc, vc, at = cache["k_loc"][loc_idx[i]], cache["v_loc"][loc_idx[i]], slot
            k_pos, valid = cache["kpos_loc"], loc_valid
        else:
            kc, vc, at = cache["k"][glob_idx[i]], cache["v"][glob_idx[i]], pos
            k_pos, valid = k_pos_g, g_valid
        kc[:, at] = k_new[:, 0].to(kc.dtype)
        vc[:, at] = v_new[:, 0].to(vc.dtype)
        x = x + _attn_out(pl, q, kc.to(dt), vc.to(dt), cfg, positions, w, k_pos, valid)
        x, _ = _ffn(pl, x, cfg)
    x = L.rmsnorm(x, p.final_norm)
    cache["pos"] = pos + 1
    return logits_fn(p, cfg, x)[:, 0], cache


def prefill(p: Transformer, cfg, tokens: torch.Tensor, max_len: int, patch_embeds=None,
            cache_dtype=torch.bfloat16):
    """Prefill a cache from a full prompt (patches first where given).
    Returns (last logits (B, V), cache)."""
    x = embed_inputs(p, cfg, tokens, patch_embeds)
    b, s_len, _ = x.shape
    x, kvs, _ = _layers(p, cfg, x, collect_kv=True)
    logits = logits_fn(p, cfg, x[:, -1:])
    dev = x.device
    cache: dict = {"pos": s_len}
    # the caches are the stacked entries padded to max_len (or put in their
    # ring slots), which keeps them placed like the entries on a mesh
    if cfg.kv_lora > 0:
        for key, j in (("ckv", 0), ("kr", 1)):
            c = torch.stack([kv[j] for kv in kvs]).to(cache_dtype)
            cache[key] = F.pad(c, (0, 0, 0, max_len - s_len))
        return logits[:, 0], cache
    is_local, _, _, nl, ng, win = _cache_layout(cfg, max_len)
    if ng:
        glob = [i for i, ll in enumerate(is_local) if not ll]
        for key, j in (("k", 0), ("v", 1)):
            c = torch.stack([kvs[i][j] for i in glob]).to(cache_dtype)
            cache[key] = F.pad(c, (0, 0, 0, 0, 0, max_len - s_len))
    if nl:
        loc = [i for i, ll in enumerate(is_local) if ll]
        keep = min(win, s_len)
        p_sel = torch.arange(s_len - keep, s_len, device=dev)
        slots = p_sel % win
        for key, j in (("k_loc", 0), ("v_loc", 1)):
            cache[key] = L.ring(torch.stack([kvs[i][j] for i in loc]).to(cache_dtype), 2, win)
        kpos = torch.full((win,), -(2**30), dtype=torch.int32, device=dev)
        kpos[slots] = p_sel.to(torch.int32)
        cache["kpos_loc"] = kpos
    return logits[:, 0], cache
