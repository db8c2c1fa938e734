"""Shared model layers, the port of ``repro/models/layers.py``.

Conventions, as in the reference:
  * weights are masters in ``cfg.param_dtype`` (drawn in float32 and cast
    once), cast to the compute dtype where they are used (``W.to(dt)``,
    the reference's ``.astype(dt)``); a weight already in that dtype is
    used as it is, so a copy cast once gives the same bits;
  * the compute dtype comes from the input; normalisation, rotary
    embeddings, the attention softmax and the MoE router run in float32;
  * attention is the double-chunked online softmax of the reference, in the
    reference's order of operations (no ``scaled_dot_product_attention``,
    which sums in its own order).

Dense weights live in ``nn.Linear`` modules, (out, in) as PyTorch keeps
them; the reference keeps (in, out) and computes ``x @ W``, so
``models.params_from_jax`` transposes them.  The MoE's expert tensors,
(E, d, 2f) and (E, f, d), are no ``nn.Linear`` and keep the reference's
layout.

Logical-axis specs: each family module names the axes of every tensor as
the reference's ``init`` does (``leaf_spec``, from the tables here and in
the family module), and ``models.param_specs`` turns them into the port
tensor's own dimension order; ``dist.sharding`` maps them to a mesh.
``constrain`` sits at the reference's call sites on the activations: the
identity outside an ``activation_context`` or on a plain tensor, so the
models on one device run as before, bit for bit; on DTensor parameters
inside a context it redistributes to the rule's placements, and the
sharded train step (``train.step``) runs these same functions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..dist.sharding import constrain, index_add_rows, reshape, unflatten

# ---------------------------------------------------------------------------
# logical-axis specs of the shared layers (the reference's, in its (in, out)
# order; ``models.param_specs`` reverses an ``nn.Linear`` weight's)
# ---------------------------------------------------------------------------

EMBED_SPEC = ("vocab", "embed")
NORM_SPEC = ("embed",)
MLA_SPECS = {
    "wq": ("embed", "heads_dim"), "wdkv": ("embed", "lora"), "wkr": ("embed", "lora"),
    "wuk": ("lora", "heads_dim"), "wuv": ("lora", "heads_dim"), "wo": ("heads_dim", "embed"),
}
MOE_SPECS = {
    "router": ("embed", "experts"), "wi": ("experts", "embed", "ff2"), "wo": ("experts", "ff", "embed"),
    "shared_wi": ("embed", "ff2"), "shared_wo": ("ff", "embed"),
}


def mlp_specs(cfg) -> dict:
    """A gated MLP's ``wi`` holds [u | g] (``ff2``); a gelu MLP's is ``ff``."""
    gated = cfg.act in ("swiglu", "geglu")
    return {"wi": ("embed", "ff2" if gated else "ff"), "wo": ("ff", "embed"), "bi": ("ff",), "bo": ("embed",)}

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(
    shape: tuple[int, ...], generator: torch.Generator | None, device: torch.device, scale: float | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in float32 and cast to ``dtype`` (the
    master dtype), scale 1/sqrt(fan_in) by default.

    ``shape`` is PyTorch's (out, in) for a matrix, so fan_in is its last
    axis (the reference draws (in, out) and scales by 1/sqrt(shape[0])).
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
    return (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale).to(dtype)


def linear(d_in: int, d_out: int, generator: torch.Generator, device: torch.device, *, bias: bool,
           dtype: torch.dtype = torch.float32) -> nn.Linear:
    """An ``nn.Linear`` with ``dense_init`` weights and a zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device="meta")
    lin.weight = nn.Parameter(dense_init((d_out, d_in), generator, device, dtype=dtype))
    if bias:
        lin.bias = nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
    return lin


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in x's dtype, then ``+ b``: the reference's two steps."""
    dt = x.dtype
    out = x @ lin.weight.to(dt).T
    if lin.bias is not None:
        out = out + lin.bias.to(dt)
    return out


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Where a mesh shards the table's rows (the
    vocabulary), ``F.embedding``, which DTensor runs as a masked lookup of
    each rank's own rows and a sum across them; indexing would gather the
    table whole on every rank."""
    if isinstance(table, DTensor) and any(isinstance(p, Shard) and p.dim == 0 for p in table.placements):
        out = F.embedding(tokens, table)
        # the masked partial sums reduced at once: a recomputed layer reads
        # its input again, and a masked partial reduces only once
        return out.redistribute(out.device_mesh, [Replicate() if p.is_partial() else p for p in out.placements])
    return table[tokens]


def rmsnorm_init(d: int, device: torch.device, dtype: torch.dtype = torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, device=device, dtype=dtype))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``(1 + w)`` (w starts at zero).

    ``1 + w`` is taken in float32 also for a bfloat16 master ``w``: XLA
    keeps that bfloat16 sum unrounded inside the reference's fusion (its
    default excess precision), so rounding it here would differ."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def ref_path(local: str) -> tuple[str, ...]:
    """A tensor's path in the reference: ``attn.wq.weight`` -> (attn, wq),
    ``attn.wq.bias`` -> (attn, bq), ``ln1`` -> (ln1,)."""
    parts = local.split(".")
    if parts[-1] == "weight":
        return tuple(parts[:-1])
    if parts[-1] == "bias":
        return (*parts[:-2], "b" + parts[-2][1:])
    return tuple(parts)


def stacked_ref_location(name: str, stack: str, count: int):
    """(reference path, index or None, stacked count or None) of a tensor
    of a family whose dense weights are bias-free ``nn.Linear``s (mamba2,
    griffin): ``<stack>.<i>.<rest>`` is slice i of the reference's stacked
    leaf (stack, *rest), any other name an unstacked leaf; ``.weight``
    drops from the path."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    if parts[0] == stack:
        return (stack, *parts[2:]), int(parts[1]), count
    return tuple(parts), None, None


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv over the sequence, in x's dtype, as the
    reference sums it (tap by tap, then the bias).  x: (B, S, C), w: (K, C),
    state: (B, K - 1, C) or None (zeros).  Returns (out, the last K - 1
    inputs as the next state)."""
    k = w.shape[0]
    dt = x.dtype
    # zeros ahead of x by a pad, not a cat with a tensor of zeros: a pad keeps
    # a DTensor's placements, and the values are the same
    xp = F.pad(x, (0, 0, k - 1, 0)) if state is None else torch.cat([state.to(dt), x], dim=1)
    s_len = x.shape[1]
    out = xp[:, :s_len] * w[0].to(dt)
    for i in range(1, k):
        out = out + xp[:, i:i + s_len] * w[i].to(dt)
    return out + b.to(dt), xp[:, s_len:]


def ring(t: torch.Tensor, dim: int, win: int) -> torch.Tensor:
    """A ring buffer of ``win`` slots along ``dim`` holding t's last
    ``min(win, S)`` positions p at slot p % win, zeros elsewhere: a gather
    of t in slot order, or t padded (placed like t on a mesh)."""
    s_len = t.shape[dim]
    if s_len < win:  # positions 0..S-1 at their own slots
        return F.pad(t, [0, 0] * (t.ndim - 1 - dim) + [0, win - s_len])
    p_sel = torch.arange(s_len - win, s_len, device=t.device)
    return t.index_select(dim, p_sel[torch.argsort(p_sel % win)])


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, rotary_dim: int | None = None) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Half-split rotation
    (not interleaved) in float32, with
    ``freqs = exp(-arange(half) * ln(theta) / half)``."""
    d = rotary_dim or x.shape[-1]
    half = d // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    # ln(theta) in float32, from a fill on x's device (no copy from host memory)
    log_theta = torch.log(torch.full((), theta, **f32))
    freqs = torch.exp(-torch.arange(0, half, **f32) * (log_theta / half))
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:d].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2, x[..., d:].float()], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (double-chunked online softmax; GQA; window; softcap)
# ---------------------------------------------------------------------------


def _attn_inner(q, k, v, q_pos, k_pos, window: int, softcap: float, kv_valid):
    """One (q-chunk x kv-chunk) tile.  q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).
    Query head h reads kv head h // g (heads grouped (hkv, g))."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qf = reshape(q.float(), (b, sq, hkv, hq // hkv, dh))
    if isinstance(qf, DTensor):
        return _attn_tile_local(qf, k, v, q_pos, k_pos, window, softcap, kv_valid)
    return _attn_tile(qf, k, v, q_pos, k_pos, window, softcap, kv_valid)


def _attn_tile_local(qf: DTensor, k, v, q_pos, k_pos, window: int, softcap: float, kv_valid):
    """``_attn_tile`` on a mesh: every (batch, kv head) is its own problem,
    so each rank runs the plain tile on its own rows and kv heads (q's
    shards of dims 0 and 2 kept, k and v placed alike, anything else
    gathered) and the outputs are those shards.  DTensor's own einsum
    merges the batch with a sharded head dimension, which older DTensor
    releases refuse, and a rank's values are the unsharded tile's."""
    mesh = qf.device_mesh
    placed = [p if type(p) is Shard and p.dim in (0, 2) else Replicate() for p in qf.placements]
    local = [t.redistribute(mesh, placed).to_local() if isinstance(t, DTensor) else t for t in (qf, k, v)]
    aux = [t.full_tensor() if isinstance(t, DTensor) else t for t in (q_pos, k_pos, kv_valid)]
    outs = _attn_tile(*local, aux[0], aux[1], window, softcap, aux[2])
    # (b, hkv, g, q, d) and (b, hkv, g, q): the kv heads are dim 1 there
    out_placed = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in placed]
    b, sq, hkv, g, dh = qf.shape
    shapes = ((b, hkv, g, sq, dh), *[(b, hkv, g, sq)] * 3)
    return tuple(DTensor.from_local(t.contiguous(), mesh, out_placed, shape=torch.Size(shape),
                                    stride=torch.empty(shape, device="meta").stride())
                 for t, shape in zip(outs, shapes))


def _attn_tile(qf, k, v, q_pos, k_pos, window: int, softcap: float, kv_valid):
    """The tile's arithmetic: qf (B, Sq, Hkv, g, D) float32 against k, v
    (B, Sk, Hkv, D)."""
    dh = qf.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    diff = q_pos[:, None] - k_pos[None, :]  # (Sq, Sk)
    mask = (diff >= 0) & (diff < window) & kv_valid[None, :]
    s = torch.where(mask, s, -torch.inf)
    m = torch.amax(s, dim=-1)  # (b, h, g, q)
    # guard fully masked rows
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o, m_safe, l, finite


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: int | None = None,
    softcap: float = 0.0,
    kv_valid: torch.Tensor | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention, chunked both ways.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); q_pos: (Sq,), k_pos: (Sk,).
    ``window <= 0`` (or None) means unbounded (full causal).  kv_valid:
    optional (Sk,) bool (cache slots already written).  Both sequences are
    padded to chunk multiples: padded keys sit at position 2^30 and are
    invalid, padded queries at position 0.  Returns (B, Sq, Hq, D) in
    q.dtype.
    """
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    window = int(window or 0)
    window = 2**30 if window <= 0 else window
    q = constrain(q, ("act_batch", "act_seq", "act_heads", None))
    k = constrain(k, ("act_batch", "act_seq", None, None))
    v = constrain(v, ("act_batch", "act_seq", None, None))
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    pad_q, pad_k = nq * q_chunk - sq, nk * kv_chunk - sk
    # no pad where the chunks divide the sequences (the same values; and
    # older DTensor releases place a pad wrongly on a mesh of 2 dimensions)
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    qpp = F.pad(q_pos, (0, pad_q))
    kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad_k)) if pad_k else t for t in (k, v))
    kpp = F.pad(k_pos, (0, pad_k), value=2**30)
    valid = kv_valid if kv_valid is not None else torch.ones((sk,), dtype=torch.bool, device=q.device)
    validp = F.pad(valid, (0, pad_k), value=False)

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc, qpos_c = qp[:, qs], qpp[qs]
        acc = m_run = l_run = None
        for kj in range(nk):
            ks = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            o, m, l, any_valid = _attn_inner(qc, kp[:, ks], vp[:, ks], qpos_c, kpp[ks], window, softcap, validp[ks])
            if acc is None:
                # (b, hkv, g, qc, d) float32 zeros and (b, hkv, g, qc) -inf and
                # zeros, made like the tile's own outputs (placed like them on
                # a mesh)
                acc, m_run, l_run = torch.zeros_like(o), torch.full_like(m, -torch.inf), torch.zeros_like(l)
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)
            beta = torch.where(any_valid, torch.exp(m - m_new), 0.0)
            acc = acc * alpha[..., None] + o * beta[..., None]
            l_run = l_run * alpha + l * beta
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        # (b, hkv, g, qc, d) -> (b, qc, hq, d)
        out = reshape(out.permute(0, 3, 1, 2, 4), (b, q_chunk, hq, dh))
        outs.append(constrain(out, ("act_batch", "act_seq", "act_heads", None)))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """swiglu / geglu (``wi`` holds [u | g], 2 d_ff wide) or gelu with
    optional biases.  Weights (out, in), as ``nn.Linear`` keeps them."""

    def __init__(self, cfg, d_ff: int, generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.d_model
        gated = cfg.act in ("swiglu", "geglu")
        bias = not gated and cfg.mlp_bias
        self.wi = linear(d, 2 * d_ff if gated else d_ff, generator, device, bias=bias, dtype=dtype)
        self.wo = linear(d_ff, d, generator, device, bias=bias, dtype=dtype)


def init_mlp(cfg, d_ff: int, generator: torch.Generator, device: torch.device,
             dtype: torch.dtype = torch.float32) -> MLP:
    return MLP(cfg, d_ff, generator, device, dtype)


def mlp(p: MLP, x: torch.Tensor, cfg, d_ff: int) -> torch.Tensor:
    dt = x.dtype
    h = constrain(x @ p.wi.weight.to(dt).T, ("act_batch", "act_seq", "act_ff"))
    if cfg.act in ("swiglu", "geglu"):
        u, g = torch.chunk(h, 2, dim=-1)
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        return (act * u) @ p.wo.weight.to(dt).T
    if p.wi.bias is not None:
        h = h + p.wi.bias.to(dt)
    h = F.gelu(h, approximate="tanh")
    return dense(p.wo, h)




# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, per-expert top-C capacity)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """``router`` (d -> E) and the shared SwiGLU (``shared_wi``/``shared_wo``,
    ``d_ff_expert * n_shared`` wide) are ``nn.Linear``; the routed experts'
    ``wi`` (E, d, 2f) and ``wo`` (E, f, d) keep the reference's layout."""

    def __init__(self, cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        self.router = linear(d, e, generator, device, bias=False, dtype=dtype)
        # the reference scales every dense_init by 1/sqrt(shape[0]), which for
        # the stacked experts is 1/sqrt(E), not 1/sqrt(d): kept as it is
        scale = 1.0 / math.sqrt(e)
        self.wi = nn.Parameter(dense_init((e, d, 2 * f), generator, device, scale, dtype))
        self.wo = nn.Parameter(dense_init((e, f, d), generator, device, scale, dtype))
        if cfg.n_shared:
            fs = f * cfg.n_shared
            self.shared_wi = linear(d, 2 * fs, generator, device, bias=False, dtype=dtype)
            self.shared_wo = linear(fs, d, generator, device, bias=False, dtype=dtype)


def init_moe(cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype = torch.float32) -> MoE:
    return MoE(cfg, generator, device, dtype)


def moe_capacity(cfg, t: int) -> int:
    """Tokens an expert takes from a call of ``t`` tokens:
    ``min(ceil(t * top_k * capacity_factor / E), t)``, at least 1.  It
    depends on the call, so a decode step of B tokens keeps far fewer
    than a forward over the sequence (deepseek-v2-lite at B = 8: one)."""
    return min(max(1, math.ceil(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts)), t)


def moe_route(p: MoE, xf: torch.Tensor, cfg):
    """The router over (T, d) tokens -> (gsel (E, C), idx (E, C), aux).

    Gates are a float32 softmax (full float32 on the card too: the package
    turns TF32 off when it is imported, or the top-k choice would move);
    a token keeps every expert whose gate
    reaches its k-th largest (ties kept, so possibly more than k).  Each
    expert takes its top C kept gates over the tokens, the lower token
    first among equal gates (a stable descending sort: ``jax.lax.top_k``'s
    order, and most of an expert's column is exact zeros).  ``aux`` is the
    Switch load-balance loss ``sum(mean gate * mean kept) * E * weight``.
    """
    e = cfg.n_experts
    gates = torch.softmax(xf.float() @ p.router.weight.float().T, dim=-1)  # (T, E) float32
    topv = torch.topk(gates, cfg.top_k, dim=-1).values
    keep = gates >= topv[:, -1:]
    gk = torch.where(keep, gates, 0.0)
    aux = torch.sum(gates.mean(dim=0) * keep.float().mean(dim=0)) * e * cfg.router_aux_weight
    cap = moe_capacity(cfg, xf.shape[0])
    gsel, idx = torch.sort(gk.T, dim=1, descending=True, stable=True)
    return gsel[:, :cap], idx[:, :cap], aux


def moe(p: MoE, x: torch.Tensor, cfg):
    """x: (B, S, D) -> ((B, S, D), aux loss).

    Capacity-bounded dispatch (a token an expert does not take is dropped
    for that expert): gathers, one batched product per expert matrix
    (plain matrix products, which the reference also computes outside any
    Pallas kernel), SwiGLU, the gate-weighted outputs scattered back with
    ``index_add_``, then the shared experts.
    """
    b, s_len, d = x.shape
    dt = x.dtype
    xf = reshape(x, (b * s_len, d))
    gsel, idx, aux = moe_route(p, xf, cfg)
    xe = constrain(xf[idx], ("act_experts", None, "act_embed"))  # (E, C, D)
    h = constrain(torch.bmm(xe, p.wi.to(dt)), ("act_experts", None, None))
    u, g = torch.chunk(h, 2, dim=-1)
    y = constrain(torch.bmm(F.silu(g) * u, p.wo.to(dt)), ("act_experts", None, "act_embed"))
    y = y * gsel[..., None].to(dt)
    out = constrain(index_add_rows(xf.shape[0], idx, y), ("act_batch", "act_embed"))
    if cfg.n_shared:
        us, gs = torch.chunk(xf @ p.shared_wi.weight.to(dt).T, 2, dim=-1)
        out = out + (F.silu(gs) * us) @ p.shared_wo.weight.to(dt).T
    return reshape(out, (b, s_len, d)), aux


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2 style)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """``wq`` (d -> H (qk_nope + qk_rope)), the latent down-projection
    ``wdkv`` (d -> kv_lora), the shared rope key ``wkr`` (d -> qk_rope),
    the up-projections ``wuk`` and ``wuv`` and ``wo``; no q compression
    (V2-Lite)."""

    def __init__(self, cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype = torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        kw = dict(bias=False, dtype=dtype)
        self.wq = linear(d, h * (cfg.qk_nope + cfg.qk_rope), generator, device, **kw)
        self.wdkv = linear(d, cfg.kv_lora, generator, device, **kw)
        self.wkr = linear(d, cfg.qk_rope, generator, device, **kw)
        self.wuk = linear(cfg.kv_lora, h * cfg.qk_nope, generator, device, **kw)
        self.wuv = linear(cfg.kv_lora, h * cfg.v_head, generator, device, **kw)
        self.wo = linear(h * cfg.v_head, d, generator, device, **kw)


def init_mla(cfg, generator: torch.Generator, device: torch.device, dtype: torch.dtype = torch.float32) -> MLA:
    return MLA(cfg, generator, device, dtype)


def mla_expand_kv(p: MLA, ckv: torch.Tensor, k_rope: torch.Tensor, cfg, dt: torch.dtype):
    """Latent cache -> full K (B, S, H, qk_nope + qk_rope), V (B, S, H, v_head).

    ckv: (B, S, kv_lora); k_rope: (B, S, qk_rope).  K is ``[k_nope |
    k_rope broadcast over the heads]``.  The products run in the promoted
    type of the cache and ``dt``, as ``ckv @ W.astype(dt)`` promotes in
    the reference (a float32 cache under bfloat16 compute expands in
    float32).
    """
    b, s_len, _ = ckv.shape
    h = cfg.n_heads
    ct = torch.promote_types(ckv.dtype, dt)
    c = ckv.to(ct)
    k_nope = unflatten(c @ p.wuk.weight.to(dt).to(ct).T, -1, (h, cfg.qk_nope))
    v = unflatten(c @ p.wuv.weight.to(dt).to(ct).T, -1, (h, cfg.v_head))
    kr = k_rope[:, :, None, :].to(dt).expand(b, s_len, h, cfg.qk_rope)
    kt = torch.promote_types(k_nope.dtype, dt)
    return torch.cat([k_nope.to(kt), kr.to(kt)], dim=-1), v


def mla_qkv(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg):
    """x: (B, S, d) -> (q (B, S, H, qk_nope + qk_rope) with rope on its
    last qk_rope dims, ckv (B, S, kv_lora), k_rope (B, S, qk_rope) with
    rope): the latent parts are what the cache keeps."""
    dt = x.dtype
    q = unflatten(x @ p.wq.weight.to(dt).T, -1, (cfg.n_heads, cfg.qk_nope + cfg.qk_rope))
    q_nope, q_rope = q[..., : cfg.qk_nope], q[..., cfg.qk_nope :]
    q = torch.cat([q_nope, rope(q_rope, positions[None, :], cfg.rope_theta)], dim=-1)
    ckv = x @ p.wdkv.weight.to(dt).T
    k_rope = rope((x @ p.wkr.weight.to(dt).T)[:, :, None, :], positions[None, :], cfg.rope_theta)[:, :, 0, :]
    return q, ckv, k_rope
