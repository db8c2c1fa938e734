"""Shared model layers, the port of ``repro/models/layers.py`` (the dense
parts).

Conventions, as in the reference:
  * weights are float32 masters, cast to the compute dtype where they are
    used (``W.to(dt)``, the reference's ``.astype(dt)``); a weight already
    in that dtype is used as it is, so a copy cast once gives the same bits;
  * the compute dtype comes from the input; normalisation, rotary
    embeddings and the attention softmax run in float32;
  * attention is the double-chunked online softmax of the reference, in the
    reference's order of operations (no ``scaled_dot_product_attention``,
    which sums in its own order).

Dense weights live in ``nn.Linear`` modules, (out, in) as PyTorch keeps
them; the reference keeps (in, out) and computes ``x @ W``, so
``models.params_from_jax`` transposes them.  The reference's logical-axis
specs and ``dist.sharding.constrain`` (the identity outside a mesh) have no
counterpart here: multi-GPU placement is a later item (``ROADMAP.md`` §1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_MOE_MLA = "the MoE and MLA transformer (ROADMAP.md §1, the LM stack)"


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(
    shape: tuple[int, ...], generator: torch.Generator | None, device: torch.device, scale: float | None = None
) -> torch.Tensor:
    """Normal(0, 1) * scale in float32, scale 1/sqrt(fan_in) by default.

    ``shape`` is PyTorch's (out, in) for a matrix, so fan_in is its last
    axis (the reference draws (in, out) and scales by 1/sqrt(shape[0])).
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-1])
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale


def linear(d_in: int, d_out: int, generator: torch.Generator, device: torch.device, *, bias: bool) -> nn.Linear:
    """An ``nn.Linear`` with ``dense_init`` weights and a zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias, device="meta")
    lin.weight = nn.Parameter(dense_init((d_out, d_in), generator, device))
    if bias:
        lin.bias = nn.Parameter(torch.zeros(d_out, device=device))
    return lin


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in x's dtype, then ``+ b``: the reference's two steps."""
    dt = x.dtype
    out = x @ lin.weight.to(dt).T
    if lin.bias is not None:
        out = out + lin.bias.to(dt)
    return out


def rmsnorm_init(d: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, device=device))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``(1 + w)`` (w starts at zero)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


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
    g = hq // hkv
    qf = q.float().reshape(b, sq, hkv, g, dh)
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
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    pad_q, pad_k = nq * q_chunk - sq, nk * kv_chunk - sk
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    qpp = F.pad(q_pos, (0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    kpp = F.pad(k_pos, (0, pad_k), value=2**30)
    valid = kv_valid if kv_valid is not None else torch.ones((sk,), dtype=torch.bool, device=q.device)
    validp = F.pad(valid, (0, pad_k), value=False)

    outs = []
    for qi in range(nq):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc, qpos_c = qp[:, qs], qpp[qs]
        acc = torch.zeros((b, hkv, g, q_chunk, dh), dtype=torch.float32, device=q.device)
        m_run = torch.full((b, hkv, g, q_chunk), -torch.inf, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            ks = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            o, m, l, any_valid = _attn_inner(qc, kp[:, ks], vp[:, ks], qpos_c, kpp[ks], window, softcap, validp[ks])
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)
            beta = torch.where(any_valid, torch.exp(m - m_new), 0.0)
            acc = acc * alpha[..., None] + o * beta[..., None]
            l_run = l_run * alpha + l * beta
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        # (b, hkv, g, qc, d) -> (b, qc, hq, d)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, dh))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """swiglu / geglu (``wi`` holds [u | g], 2 d_ff wide) or gelu with
    optional biases.  Weights (out, in), as ``nn.Linear`` keeps them."""

    def __init__(self, cfg, d_ff: int, generator: torch.Generator, device: torch.device):
        super().__init__()
        d = cfg.d_model
        gated = cfg.act in ("swiglu", "geglu")
        bias = not gated and cfg.mlp_bias
        self.wi = linear(d, 2 * d_ff if gated else d_ff, generator, device, bias=bias)
        self.wo = linear(d_ff, d, generator, device, bias=bias)


def init_mlp(cfg, d_ff: int, generator: torch.Generator, device: torch.device) -> MLP:
    return MLP(cfg, d_ff, generator, device)


def mlp(p: MLP, x: torch.Tensor, cfg, d_ff: int) -> torch.Tensor:
    dt = x.dtype
    if cfg.act in ("swiglu", "geglu"):
        h = x @ p.wi.weight.to(dt).T
        u, g = torch.chunk(h, 2, dim=-1)
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        return (act * u) @ p.wo.weight.to(dt).T
    h = dense(p.wi, x)
    h = F.gelu(h, approximate="tanh")
    return dense(p.wo, h)


# ---------------------------------------------------------------------------
# Mixture of Experts and Multi-head Latent Attention: a later item
# ---------------------------------------------------------------------------


def init_moe(*args, **kwargs):
    raise NotImplementedError(f"MoE layers come with {_MOE_MLA}")


def moe(*args, **kwargs):
    raise NotImplementedError(f"MoE layers come with {_MOE_MLA}")


def init_mla(*args, **kwargs):
    raise NotImplementedError(f"MLA comes with {_MOE_MLA}")


def mla_expand_kv(*args, **kwargs):
    raise NotImplementedError(f"MLA comes with {_MOE_MLA}")


def mla_qkv(*args, **kwargs):
    raise NotImplementedError(f"MLA comes with {_MOE_MLA}")
