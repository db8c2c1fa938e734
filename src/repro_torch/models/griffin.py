"""Griffin / RecurrentGemma, the port of ``repro/models/griffin.py``:
RG-LRU recurrent blocks and local MQA blocks, 2:1 (recurrentgemma-2b).

The block pattern ``cfg.block_pattern`` (R, R, A) repeats ``n_periods``
times, then a remainder of its first slots ((R, R) for 26 layers); every
mixing block is followed by a GeGLU MLP block.  The parameters mirror the
reference's tree: ``period`` holds the ``n_periods`` periods (the
reference stacks them, leaf by leaf, under ``period/mix{slot}/...`` and
``period/mlp{slot}/...``) and ``remainder`` its blocks unstacked.
``ref_location`` says where each tensor lives there.

The RG-LRU recurrence h_t = a_t h_{t-1} + b_t runs over the sequence as a
parallel prefix (``_scan``): the odd/even recursion of
``jax.lax.associative_scan``, about log2(S) levels of torch ops, not S
steps.  With ``cfg.remat`` each period runs under
``torch.utils.checkpoint`` while a graph is being recorded, the
remainder's blocks as they are, as the reference checkpoints its scan
body.  No hand-written kernel lies on this path.

Decode: O(1) recurrent states and one ring of ``min(window, max_len)``
attention slots shared by every attention block (slot = pos % window,
``kpos`` starts at -2^30).  The cache's ``conv`` (conv tails) and ``lru``
(float32 states) stack the recurrent blocks in the order they run: period
by period, then the remainder; ``k`` and ``v`` stack the attention blocks
the same way.  ``decode_step`` writes them in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain, reshape, rowwise, unflatten
from ..engine.plan import resolve_device
from . import layers as L
from .ssm import softplus

_C_RGLRU = 8.0


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _pattern(cfg):
    pat = cfg.block_pattern or ("R", "R", "A")
    n_periods = cfg.n_layers // len(pat)
    remainder = tuple(pat[: cfg.n_layers - n_periods * len(pat)])
    return pat, n_periods, remainder


class RGLRU(nn.Module):
    """``wx`` and ``wy`` (d -> w, w = d), the conv (K, w) and its bias, the
    gates ``wr`` and ``wi`` (w -> w), ``lam`` (w,) and ``wo`` (w -> d)."""

    def __init__(self, cfg, generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d = w = cfg.d_model
        kw = dict(bias=False, dtype=dtype)
        f32 = dict(dtype=torch.float32, device=device)
        self.ln = L.rmsnorm_init(d, device, dtype)
        self.wx = L.linear(d, w, generator, device, **kw)
        self.wy = L.linear(d, w, generator, device, **kw)
        self.conv_w = nn.Parameter((torch.randn((cfg.d_conv, w), generator=generator, **f32) * 0.2).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros(w, device=device, dtype=dtype))
        self.wr = L.linear(w, w, generator, device, **kw)
        self.wi = L.linear(w, w, generator, device, **kw)
        self.lam = nn.Parameter(torch.linspace(-4.0, -9.0, w, **f32).to(dtype))
        self.wo = L.linear(w, d, generator, device, **kw)


class LocalAttention(nn.Module):
    def __init__(self, cfg, generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv * cfg.d_head
        kw = dict(bias=False, dtype=dtype)
        self.ln = L.rmsnorm_init(d, device, dtype)
        self.wq = L.linear(d, hq, generator, device, **kw)
        self.wk = L.linear(d, hkv, generator, device, **kw)
        self.wv = L.linear(d, hkv, generator, device, **kw)
        self.wo = L.linear(hq, d, generator, device, **kw)


class MLPBlock(L.MLP):
    """The GeGLU MLP with its own pre-norm ``ln``."""

    def __init__(self, cfg, generator, device: torch.device, dtype: torch.dtype):
        super().__init__(cfg, cfg.d_ff, generator, device, dtype)
        self.ln = L.rmsnorm_init(cfg.d_model, device, dtype)


class Blocks(nn.Module):
    """A period (or the remainder): ``mix{slot}`` and ``mlp{slot}`` a slot."""

    def __init__(self, cfg, kinds, generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.kinds = tuple(kinds)
        for slot, kind in enumerate(self.kinds):
            mix = RGLRU if kind == "R" else LocalAttention
            self.add_module(f"mix{slot}", mix(cfg, generator, device, dtype))
            self.add_module(f"mlp{slot}", MLPBlock(cfg, generator, device, dtype))

    def slots(self):
        return [(kind, getattr(self, f"mix{s}"), getattr(self, f"mlp{s}")) for s, kind in enumerate(self.kinds)]


class Griffin(nn.Module):
    def __init__(self, cfg, generator, device: torch.device, dtype: torch.dtype):
        super().__init__()
        pat, n_periods, remainder = _pattern(cfg)
        self.embed = nn.Parameter(
            L.dense_init((cfg.padded_vocab, cfg.d_model), generator, device, scale=0.02, dtype=dtype))
        self.final_norm = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.period = nn.ModuleList(Blocks(cfg, pat, generator, device, dtype) for _ in range(n_periods))
        self.remainder = Blocks(cfg, remainder, generator, device, dtype)

    def blocks(self):
        """Every (kind, mix, mlp) in the order the blocks run."""
        return [b for blocks in (*self.period, self.remainder) for b in blocks.slots()]


def init(cfg, generator: torch.Generator, device: torch.device) -> Griffin:
    """Random master parameters in ``cfg.param_dtype`` on ``device`` from
    ``generator``: embeddings normal * 0.02, dense weights normal /
    sqrt(fan_in), the conv normal * 0.2, ``lam`` = linspace(-4, -9), norms
    and biases zero, as the reference."""
    return Griffin(cfg, generator, torch.device(device), _dtype(cfg.param_dtype))


def skeleton(cfg) -> Griffin:
    """The parameter structure on the meta device in the master dtype."""
    return Griffin(cfg, None, torch.device("meta"), _dtype(cfg.param_dtype))


def ref_location(cfg, name: str):
    """(reference path, period index or None, stacked count or None) of a
    port tensor: ``period.3.mix0.wx.weight`` -> (period, mix0, wx), 3,
    n_periods; ``remainder.mlp1.ln`` -> (remainder, mlp1, ln), unstacked."""
    return L.stacked_ref_location(name, "period", _pattern(cfg)[1])


_RGLRU_SPECS = {
    "ln": L.NORM_SPEC, "wx": ("embed", "lru"), "wy": ("embed", "lru"), "conv_w": ("conv", "lru"),
    "conv_b": ("lru",), "wr": ("lru", "lru2"), "wi": ("lru", "lru2"), "lam": ("lru",), "wo": ("lru", "embed"),
}
_ATTN_SPECS = {
    "ln": L.NORM_SPEC, "wq": ("embed", "heads_dim"), "wk": ("embed", "kv_dim"), "wv": ("embed", "kv_dim"),
    "wo": ("heads_dim", "embed"),
}


def leaf_spec(cfg, path: tuple[str, ...]) -> tuple:
    """The reference's logical axis names of the leaf at ``path``
    (``period/...`` a period's slice, ``remainder/...`` unstacked), in its
    (in, out) order."""
    if path[0] not in ("period", "remainder"):
        return {"embed": L.EMBED_SPEC, "final_norm": L.NORM_SPEC}[path[0]]
    block, leaf = path[1], path[2]
    if block.startswith("mlp"):
        return L.NORM_SPEC if leaf == "ln" else L.mlp_specs(cfg)[leaf]
    kind = _pattern(cfg)[0][int(block[3:])]
    return (_RGLRU_SPECS if kind == "R" else _ATTN_SPECS)[leaf]


def _kept(name: str) -> bool:
    """The reference uses the norms, the RG-LRU's gates ``wr``, ``wi`` and
    ``lam`` in float32 (or their master dtype) whatever the compute dtype."""
    parts = name.split(".")
    return parts[-1] in ("ln", "final_norm", "lam") or (
        parts[-1] == "weight" and parts[-2] in ("wr", "wi") and parts[-3].startswith("mix"))


def cast_for_compute(p: Griffin, cfg) -> Griffin:
    """A copy of ``p`` with every tensor the reference casts with
    ``.astype(cfg.dtype)`` cast once, and the rest (``_kept``) kept; a
    tensor already in ``cfg.dtype`` is shared."""
    dt = _dtype(cfg.dtype)
    state = {k: v if _kept(k) else v.to(dt) for k, v in p.state_dict().items()}
    out = skeleton(cfg)
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# the RG-LRU
# ---------------------------------------------------------------------------


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... along
    dim 1 (``even`` may hold one row more)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = F.pad(odd, (0, 0, 0, 1))
    return torch.stack([even, odd], dim=2).flatten(1, 2)[:, :n]


def _scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 (h_{-1} =
    0): (prod a, h), in ``jax.lax.associative_scan``'s order of operations.
    Adjacent pairs combine, the half-length sequence scans recursively
    (the odd positions), and each even position combines the odd result
    before it with its own element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru(pl: RGLRU, h: torch.Tensor, state=None, single_step: bool = False):
    """The gated linear recurrence.  h: (B, S, D); ``state`` (conv tail,
    float32 LRU state) or None (zeros).  Returns (y, (conv state, LRU
    state)).  The gates run in float32 from ``wr``, ``wi`` and ``lam`` as
    they are."""
    dt = h.dtype
    x = h @ pl.wx.weight.to(dt).T
    y_gate = F.gelu(h @ pl.wy.weight.to(dt).T, approximate="tanh")
    x, conv_new = L.causal_conv(x, pl.conv_w, pl.conv_b, state[0] if state is not None else None)
    xf = x.float()
    r = torch.sigmoid(xf @ pl.wr.weight.float().T)
    i = torch.sigmoid(xf @ pl.wi.weight.float().T)
    a = torch.exp(-_C_RGLRU * softplus(pl.lam.float()) * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xf)
    if single_step:
        lru_new = a[:, 0] * state[1] + b[:, 0]
        out = lru_new[:, None]
    else:
        _, out = rowwise(_scan, (a, b), dims=(0, 2))
        lru_new = out[:, -1]
    out = (out * y_gate.float()).to(dt)
    return out @ pl.wo.weight.to(dt).T, (conv_new, lru_new)


# ---------------------------------------------------------------------------
# local attention
# ---------------------------------------------------------------------------


def _qkv(pl: LocalAttention, h: torch.Tensor, cfg, positions: torch.Tensor):
    dt = h.dtype
    q = unflatten(h @ pl.wq.weight.to(dt).T, -1, (cfg.n_heads, cfg.d_head))
    k = unflatten(h @ pl.wk.weight.to(dt).T, -1, (cfg.n_kv, cfg.d_head))
    v = unflatten(h @ pl.wv.weight.to(dt).T, -1, (cfg.n_kv, cfg.d_head))
    return L.rope(q, positions[None, :], cfg.rope_theta), L.rope(k, positions[None, :], cfg.rope_theta), v


def _attn_out(pl: LocalAttention, q, k_all, v_all, cfg, positions, k_pos, kv_valid) -> torch.Tensor:
    b, sq = q.shape[:2]
    o = L.attention(q, k_all, v_all, q_pos=positions, k_pos=k_pos, window=cfg.window, kv_valid=kv_valid)
    return reshape(o, (b, sq, -1)) @ pl.wo.weight.to(q.dtype).T


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _mlp(mlp: MLPBlock, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + L.mlp(mlp, L.rmsnorm(x, mlp.ln), cfg, cfg.d_ff)


def _block(kind: str, mix, mlp: MLPBlock, x: torch.Tensor, cfg, positions: torch.Tensor):
    """A mixing block and its MLP over a full sequence -> (x, state): the
    (conv tail, final LRU state) of a recurrent block, (k, v) of an
    attention block."""
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    h = L.rmsnorm(x, mix.ln)
    if kind == "R":
        out, state = _rglru(mix, h)
    else:
        q, k, v = _qkv(mix, h, cfg, positions)
        out, state = _attn_out(mix, q, k, v, cfg, positions, positions, None), (k, v)
    return _mlp(mlp, x + out, cfg), state


def _period(blocks: Blocks, x: torch.Tensor, cfg, positions: torch.Tensor) -> torch.Tensor:
    for kind, mix, mlp in blocks.slots():
        x, _ = _block(kind, mix, mlp, x, cfg, positions)
    return x


def forward(p: Griffin, cfg, tokens: torch.Tensor, patch_embeds=None):
    """Full-sequence forward -> (final hidden states (B, S, D), aux 0)."""
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for blocks in p.period:
        if remat:
            x = checkpoint(_period, blocks, x, cfg, positions, use_reentrant=False)
        else:
            x = _period(blocks, x, cfg, positions)
    x = _period(p.remainder, x, cfg, positions)
    return L.rmsnorm(x, p.final_norm), torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(p: Griffin, cfg, x: torch.Tensor) -> torch.Tensor:
    return x @ p.embed.to(x.dtype).T


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _counts(cfg) -> tuple[int, int]:
    """(recurrent blocks, attention blocks) of the whole stack."""
    pat, n_periods, remainder = _pattern(cfg)
    kinds = pat * n_periods + remainder
    return kinds.count("R"), kinds.count("A")


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """A ring of ``min(window, max_len)`` attention slots and O(1)
    recurrent states on ``device`` (default the card, which raises without
    one unless ``device="cpu"``)."""
    device = resolve_device(device)
    n_r, n_a = _counts(cfg)
    win = min(cfg.window, max_len)
    kv = (n_a, batch, win, cfg.n_kv, cfg.d_head)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "kpos": torch.full((win,), -(2**30), dtype=torch.int32, device=device),
        "conv": torch.zeros((n_r, batch, cfg.d_conv - 1, cfg.d_model), dtype=dtype, device=device),
        "lru": torch.zeros((n_r, batch, cfg.d_model), dtype=torch.float32, device=device),
        "pos": 0,
    }


def decode_step(p: Griffin, cfg, cache: dict, cur_tokens: torch.Tensor):
    """One decode step.  cur_tokens: (B, 1).  Returns (logits (B, V),
    cache), its tensors updated in place.  An attention block computes
    q, k and v once, writes k and v into its ring slot, and attends over
    the ring."""
    dt = _dtype(cfg.dtype)
    pos = int(cache["pos"])
    x = L.embed_lookup(p.embed.to(dt), cur_tokens)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    slot = pos % cache["k"].shape[2]
    kpos = cache["kpos"]
    kpos[slot : slot + 1].fill_(pos)  # a fill, not a copy from host memory
    valid = kpos >= 0
    ri = ai = 0
    for kind, mix, mlp in p.blocks():
        h = L.rmsnorm(x, mix.ln)
        if kind == "R":
            conv, lru = cache["conv"][ri], cache["lru"][ri]
            out, (conv_new, lru_new) = _rglru(mix, h, (conv, lru), single_step=True)
            conv.copy_(conv_new)
            lru.copy_(lru_new)
            ri += 1
        else:
            q, k_new, v_new = _qkv(mix, h, cfg, positions)
            kc, vc = cache["k"][ai], cache["v"][ai]
            kc[:, slot] = k_new[:, 0].to(kc.dtype)
            vc[:, slot] = v_new[:, 0].to(vc.dtype)
            out = _attn_out(mix, q, kc.to(dt), vc.to(dt), cfg, positions, kpos, valid)
            ai += 1
        x = _mlp(mlp, x + out, cfg)
    x = L.rmsnorm(x, p.final_norm)
    cache["pos"] = pos + 1
    return logits_fn(p, cfg, x)[:, 0], cache


def prefill(p: Griffin, cfg, tokens: torch.Tensor, max_len: int, patch_embeds=None, cache_dtype=torch.bfloat16):
    """One forward pass that also collects the decode states: each
    recurrent block's conv tail and final LRU state, each attention
    block's last ``window`` keys and values in their ring slots.  Returns
    (last logits (B, V), cache)."""
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), tokens)
    s_len = tokens.shape[1]
    dev = x.device
    positions = torch.arange(s_len, dtype=torch.int32, device=dev)
    win = min(cfg.window, max_len)
    keep = min(win, s_len)
    p_sel = torch.arange(s_len - keep, s_len, device=dev)
    slots = p_sel % win
    conv, lru, ks, vs = [], [], [], []
    for kind, mix, mlp in p.blocks():
        x, state = _block(kind, mix, mlp, x, cfg, positions)
        if kind == "R":
            conv.append(state[0].to(cache_dtype))
            lru.append(state[1])
        else:
            ks.append(L.ring(state[0].to(cache_dtype), 1, win))
            vs.append(L.ring(state[1].to(cache_dtype), 1, win))
    x = L.rmsnorm(x, p.final_norm)
    kpos = torch.full((win,), -(2**30), dtype=torch.int32, device=dev)
    kpos[slots] = p_sel.to(torch.int32)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "kpos": kpos, "conv": torch.stack(conv),
             "lru": torch.stack(lru), "pos": s_len}
    return logits_fn(p, cfg, x[:, -1:])[:, 0], cache
