"""Encoder-decoder transformer, the port of ``repro/models/encdec.py``:
the seamless-m4t backbone.

The encoder takes STUB audio-frame embeddings (B, S_enc, frontend_dim),
as the reference does: the modality frontend is out of scope, and
``proj_in`` maps the frames into the stream.  The decoder is a causal
text stack with cross-attention over the encoder's output.  The reference
scans one body over each stack's stacked parameters; here each stack is
an ``nn.ModuleList`` walked in a Python loop (``enc`` and ``dec``), with
each layer checkpointed under ``cfg.remat`` while autograd records.

Parameters: ``embed`` and an untied ``unembed`` (padded_vocab, d),
``proj_in`` (an ``nn.Linear``, frontend_dim -> d), ``enc_norm``,
``dec_norm``; an encoder layer has ``ln1``, ``attn``, ``ln2``, ``mlp``, a
decoder layer ``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``,
``mlp``.  Attention projections are bias-free; the MLP is tanh GELU with
biases (``cfg.mlp_bias``).  ``ref_location`` says where each tensor lives
in the reference's ``enc/...`` and ``dec/...`` stacks.

Attention is ``layers.attention`` (the reference's chunked online
softmax).  The encoder's bidirectional attention ropes q and k at their
real positions, then runs the kernel with every query at 2^29 and every
key at 0, so the causal mask never bites; cross-attention has no rope.

Serving: ``prefill`` encodes the frames, keeps every decoder layer's
cross K/V in the cache dtype (cast back to the compute dtype at each
step) and runs one decode step on BOS = 0; ``decode_step`` writes the
self-attention K/V at ``pos`` in place.  The decoder cache holds
``dec_len = max(1, int(max_len * cfg.dec_seq_frac))`` slots, and a write
at ``pos >= dec_len`` lands in the last slot, as the reference's clamped
``dynamic_update_slice`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain, reshape, unflatten
from ..engine.plan import resolve_device
from . import layers as L

# the bidirectional trick: queries at 2^29, keys at 0 (diff >= 0 everywhere)
_BIDI_POS = 2**29


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class Attention(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
        kw = dict(bias=False, dtype=dtype)
        self.wq = L.linear(d, hq, generator, device, **kw)
        self.wk = L.linear(d, hkv, generator, device, **kw)
        self.wv = L.linear(d, hkv, generator, device, **kw)
        self.wo = L.linear(hq, d, generator, device, **kw)


class EncLayer(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.attn = Attention(cfg, generator, device, dtype)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.mlp = L.init_mlp(cfg, cfg.d_ff, generator, device, dtype)


class DecLayer(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.ln1 = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.self_attn = Attention(cfg, generator, device, dtype)
        self.ln_x = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.cross_attn = Attention(cfg, generator, device, dtype)
        self.ln2 = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.mlp = L.init_mlp(cfg, cfg.d_ff, generator, device, dtype)


class EncDec(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.embed = nn.Parameter(
            L.dense_init((cfg.padded_vocab, d), generator, device, scale=0.02, dtype=dtype))
        self.unembed = nn.Parameter(
            L.dense_init((cfg.padded_vocab, d), generator, device, scale=0.02, dtype=dtype))
        self.proj_in = L.linear(cfg.frontend_dim, d, generator, device, bias=False, dtype=dtype)
        self.enc_norm = L.rmsnorm_init(d, device, dtype)
        self.dec_norm = L.rmsnorm_init(d, device, dtype)
        self.enc = nn.ModuleList(EncLayer(cfg, generator, device, dtype) for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(DecLayer(cfg, generator, device, dtype) for _ in range(cfg.n_dec_layers))


def init(cfg, generator: torch.Generator, device: torch.device) -> EncDec:
    """Random master parameters in ``cfg.param_dtype`` on ``device`` from
    ``generator``: embeddings normal * 0.02, dense weights normal /
    sqrt(fan_in), norms and MLP biases zero, as the reference."""
    return EncDec(cfg, generator, torch.device(device), _dtype(cfg.param_dtype))


def skeleton(cfg) -> EncDec:
    """The parameter structure on the meta device in the master dtype."""
    return EncDec(cfg, None, torch.device("meta"), _dtype(cfg.param_dtype))


def ref_location(cfg, name: str):
    """(reference path, layer index or None, stacked count or None) of a
    port tensor: ``dec.3.mlp.wi.bias`` -> (dec, mlp, bi), 3, n_dec_layers."""
    stack, _, rest = name.partition(".")
    if stack in ("enc", "dec"):
        i, local = rest.split(".", 1)
        count = cfg.n_enc_layers if stack == "enc" else cfg.n_dec_layers
        return (stack, *L.ref_path(local)), int(i), count
    return L.ref_path(name), None, None


_ATTN_SPECS = {"wq": ("embed", "heads_dim"), "wk": ("embed", "kv_dim"), "wv": ("embed", "kv_dim"),
               "wo": ("heads_dim", "embed")}
_TOP_SPECS = {"embed": L.EMBED_SPEC, "unembed": L.EMBED_SPEC, "proj_in": ("frontend", "embed"),
              "enc_norm": L.NORM_SPEC, "dec_norm": L.NORM_SPEC}


def leaf_spec(cfg, path: tuple[str, ...]) -> tuple:
    """The reference's logical axis names of the leaf at ``path`` (a
    layer's slice for the ``enc``/``dec`` stacks), in its (in, out) order."""
    if path[0] not in ("enc", "dec"):
        return _TOP_SPECS[path[0]]
    if len(path) == 2:  # ln1, ln_x, ln2
        return L.NORM_SPEC
    group, leaf = path[1], path[2]
    return L.mlp_specs(cfg)[leaf] if group == "mlp" else _ATTN_SPECS[leaf]


# tensors the reference uses in float32 whatever the compute dtype: the norms
_KEPT = ("ln1", "ln2", "ln_x", "enc_norm", "dec_norm")


def cast_for_compute(p: EncDec, cfg) -> EncDec:
    """A copy of ``p`` with the tensors the reference casts with
    ``.astype(cfg.dtype)`` (embeddings, projections, MLP weights and
    biases) cast once and the norms kept; a tensor already in
    ``cfg.dtype`` is shared."""
    dt = _dtype(cfg.dtype)
    state = {k: v if k.endswith(_KEPT) else v.to(dt) for k, v in p.state_dict().items()}
    out = skeleton(cfg)
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _heads(lin: nn.Linear, x: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """``x @ W`` in x's dtype as (B, S, n, d_head)."""
    return unflatten(x @ lin.weight.to(x.dtype).T, -1, (n, d_head))


def _kv(pa: Attention, h: torch.Tensor, cfg, k_pos: torch.Tensor | None):
    """k (roped at ``k_pos`` unless it is None) and v of ``h``."""
    k = _heads(pa.wk, h, cfg.n_kv, cfg.d_head)
    v = _heads(pa.wv, h, cfg.n_kv, cfg.d_head)
    if k_pos is not None:
        k = L.rope(k, k_pos[None, :], cfg.rope_theta)
    return k, v


def _attend(pa: Attention, hq: torch.Tensor, k, v, cfg, q_pos, k_pos, causal: bool, kv_valid=None,
            use_rope: bool = True) -> torch.Tensor:
    """The reference's ``_attn`` once k and v are known: q of ``hq`` (roped
    at ``q_pos`` where ``use_rope``), attention, then ``@ wo``.  Not
    ``causal``: every query at 2^29 and every key at 0."""
    b, sq, _ = hq.shape
    q = _heads(pa.wq, hq, cfg.n_heads, cfg.d_head)
    if use_rope:
        q = L.rope(q, q_pos[None, :], cfg.rope_theta)
    if not causal:
        q_pos, k_pos = torch.full_like(q_pos, _BIDI_POS), torch.zeros_like(k_pos)
    o = L.attention(q, k, v, q_pos=q_pos, k_pos=k_pos, window=0, kv_valid=kv_valid)
    return reshape(o, (b, sq, -1)) @ pa.wo.weight.to(hq.dtype).T


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _enc_block(pl: EncLayer, x: torch.Tensor, cfg, pos: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    h = L.rmsnorm(x, pl.ln1)
    k, v = _kv(pl.attn, h, cfg, pos)
    x = x + _attend(pl.attn, h, k, v, cfg, pos, pos, causal=False)
    return x + L.mlp(pl.mlp, L.rmsnorm(x, pl.ln2), cfg, cfg.d_ff)


def encode(p: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over (B, S_enc, frontend_dim) frames -> (B, S_enc, D)."""
    dt = _dtype(cfg.dtype)
    x = frames.to(dt) @ p.proj_in.weight.to(dt).T
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for pl in p.enc:
        x = checkpoint(_enc_block, pl, x, cfg, pos, use_reentrant=False) if remat else _enc_block(pl, x, cfg, pos)
    return L.rmsnorm(x, p.enc_norm)


def _dec_block(pl: DecLayer, x: torch.Tensor, enc_out: torch.Tensor, cfg, dpos: torch.Tensor,
               epos: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    h = L.rmsnorm(x, pl.ln1)
    k, v = _kv(pl.self_attn, h, cfg, dpos)
    x = x + _attend(pl.self_attn, h, k, v, cfg, dpos, dpos, causal=True)
    hx = L.rmsnorm(x, pl.ln_x)
    k, v = _kv(pl.cross_attn, enc_out, cfg, None)
    x = x + _attend(pl.cross_attn, hx, k, v, cfg, dpos, epos, causal=False, use_rope=False)
    return x + L.mlp(pl.mlp, L.rmsnorm(x, pl.ln2), cfg, cfg.d_ff)


def forward(p: EncDec, cfg, dec_tokens: torch.Tensor, frames: torch.Tensor):
    """Training forward -> (decoder hidden states (B, S_dec, D), aux 0)."""
    enc_out = encode(p, cfg, frames)
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), dec_tokens)
    dev = x.device
    dpos = torch.arange(dec_tokens.shape[1], dtype=torch.int32, device=dev)
    epos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for pl in p.dec:
        if remat:
            x = checkpoint(_dec_block, pl, x, enc_out, cfg, dpos, epos, use_reentrant=False)
        else:
            x = _dec_block(pl, x, enc_out, cfg, dpos, epos)
    return L.rmsnorm(x, p.dec_norm), torch.zeros((), dtype=torch.float32, device=dev)


def logits_fn(p: EncDec, cfg, x: torch.Tensor) -> torch.Tensor:
    return x @ p.unembed.to(x.dtype).T


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, enc_len: int | None = None, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """An empty cache on ``device`` (default the card, which raises without
    one unless ``device="cpu"``): decoder K/V of ``dec_len`` slots and the
    encoder's K/V of ``enc_len`` (default ``max_len``) positions, a
    (n_dec_layers, B, len, n_kv, d_head) tensor each, and ``pos``."""
    device = resolve_device(device)
    enc_len = enc_len or max_len
    dec_len = max(1, int(max_len * cfg.dec_seq_frac))
    shape = (cfg.n_dec_layers, batch)
    tail = (cfg.n_kv, cfg.d_head)
    z = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((*shape, dec_len, *tail), **z),
        "v": torch.zeros((*shape, dec_len, *tail), **z),
        "xk": torch.zeros((*shape, enc_len, *tail), **z),
        "xv": torch.zeros((*shape, enc_len, *tail), **z),
        "pos": 0,
    }


def prefill(p: EncDec, cfg, frames: torch.Tensor, max_len: int, cache_dtype=torch.bfloat16):
    """Encode, keep every decoder layer's cross K/V in ``cache_dtype``, then
    one decode step on BOS = 0.  Returns (logits (B, V), cache)."""
    enc_out = encode(p, cfg, frames)
    ks, vs = [], []
    for pl in p.dec:
        k, v = _kv(pl.cross_attn, enc_out, cfg, None)
        ks.append(k.to(cache_dtype))
        vs.append(v.to(cache_dtype))
    # init_cache's layout, made from the stacked cross K/V, placed on a mesh
    # as a decode step's cache is (the reference's cache_shardings: the batch
    # over data); the decoder's slots are the encoder's cut to none and
    # padded with zeros to dec_len
    rows = (None, "act_batch", None, None, None)
    xk, xv = constrain(torch.stack(ks), rows), constrain(torch.stack(vs), rows)
    del ks, vs
    dec_len = max(1, int(max_len * cfg.dec_seq_frac))
    cache = {"k": F.pad(xk[:, :, :0], (0, 0, 0, 0, 0, dec_len)), "v": F.pad(xv[:, :, :0], (0, 0, 0, 0, 0, dec_len)),
             "xk": xk, "xv": xv, "pos": 0}
    bos = torch.zeros_like(frames[:, :1, 0], dtype=torch.int32)
    return decode_step(p, cfg, cache, bos)


def decode_step(p: EncDec, cfg, cache: dict, cur_tokens: torch.Tensor):
    """One decode step.  cur_tokens: (B, 1).  Returns (logits (B, V),
    cache), the cache's self-attention K/V written in place.

    The reference's first ``_attn`` of a step computes an attention output
    it throws away and keeps only the new k (roped at ``pos``) and v; here
    only those are computed.
    """
    dt = _dtype(cfg.dtype)
    pos = int(cache["pos"])
    x = L.embed_lookup(p.embed.to(dt), cur_tokens)
    dev = x.device
    dec_len, s_enc = cache["k"].shape[2], cache["xk"].shape[2]
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    k_pos = torch.arange(dec_len, dtype=torch.int32, device=dev)
    epos = torch.arange(s_enc, dtype=torch.int32, device=dev)
    kv_valid = k_pos <= pos
    at = min(pos, dec_len - 1)  # the clamped write of dynamic_update_slice
    for li, pl in enumerate(p.dec):
        h = L.rmsnorm(x, pl.ln1)
        k_new, v_new = _kv(pl.self_attn, h, cfg, positions)
        kc, vc = cache["k"][li], cache["v"][li]
        kc[:, at] = k_new[:, 0].to(kc.dtype)
        vc[:, at] = v_new[:, 0].to(vc.dtype)
        x = x + _attend(pl.self_attn, h, kc.to(dt), vc.to(dt), cfg, positions, k_pos, True, kv_valid)
        hx = L.rmsnorm(x, pl.ln_x)
        xk, xv = cache["xk"][li].to(dt), cache["xv"][li].to(dt)
        x = x + _attend(pl.cross_attn, hx, xk, xv, cfg, positions, epos, False, use_rope=False)
        x = x + L.mlp(pl.mlp, L.rmsnorm(x, pl.ln2), cfg, cfg.d_ff)
    x = L.rmsnorm(x, p.dec_norm)
    cache["pos"] = pos + 1
    return logits_fn(p, cfg, x)[:, 0], cache
