"""Mamba-2 (SSD, state-space duality), the port of ``repro/models/ssm.py``:
the attention-free LM of mamba2-780m.

Chunked SSD (Dao & Gu 2024, §6), as in the reference: within a chunk of
``cfg.ssd_chunk`` tokens the mixing is the masked quadratic form (batched
(Q x Q) products); chunk states carry across chunks through a loop of
S / Q steps over (B, H, N, P) tensors.  Everything runs in torch ops
under autograd; no hand-written kernel lies on this path.

Parameters live in an ``nn.Module``: ``embed`` (tied with the output),
``final_norm`` and ``layers``, each with ``ln``, ``in_proj`` (an
``nn.Linear``, d -> [z | xBC | dt]), the depthwise causal conv ``conv_w``
(K, C) and ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias`` (one per SSD
head), the gated norm ``norm`` and ``out_proj``.  The reference stacks
the layers under ``layers/...``; ``ref_location`` says where each tensor
lives there.

Decode carries (conv, ssm) states, O(1) in the sequence length: ``conv``
(L, B, K - 1, C) in the cache dtype and ``ssm`` (L, B, H, N, P) in
float32, with ``pos`` as a Python int.  ``decode_step`` writes them in
place and returns the same dict.  ``prefill`` takes the final SSM state
from a second reduction over the prompt, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain, reshape, rowwise, unflatten
from ..engine.plan import resolve_device
from . import layers as L


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


class Layer(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
        conv_dim = di + 2 * n
        f32 = dict(dtype=torch.float32, device=device)
        self.ln = L.rmsnorm_init(d, device, dtype)
        self.in_proj = L.linear(d, 2 * di + 2 * n + h, generator, device, bias=False, dtype=dtype)
        self.conv_w = nn.Parameter((torch.randn((cfg.d_conv, conv_dim), generator=generator, **f32) * 0.2).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=device, dtype=dtype))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h, **f32)).to(dtype))
        self.d_skip = nn.Parameter(torch.ones(h, device=device, dtype=dtype))
        self.dt_bias = nn.Parameter(torch.zeros(h, device=device, dtype=dtype))
        self.norm = L.rmsnorm_init(di, device, dtype)
        self.out_proj = L.linear(di, d, generator, device, bias=False, dtype=dtype)


class Mamba2(nn.Module):
    def __init__(self, cfg, generator: torch.Generator | None, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.embed = nn.Parameter(
            L.dense_init((cfg.padded_vocab, cfg.d_model), generator, device, scale=0.02, dtype=dtype))
        self.final_norm = L.rmsnorm_init(cfg.d_model, device, dtype)
        self.layers = nn.ModuleList(Layer(cfg, generator, device, dtype) for _ in range(cfg.n_layers))


def init(cfg, generator: torch.Generator, device: torch.device) -> Mamba2:
    """Random master parameters in ``cfg.param_dtype`` on ``device`` from
    ``generator``: embeddings normal * 0.02, dense weights normal /
    sqrt(fan_in), the conv normal * 0.2, ``a_log`` = log(linspace(1, 16)),
    ``d_skip`` ones, norms, biases and ``dt_bias`` zero, as the reference."""
    return Mamba2(cfg, generator, torch.device(device), _dtype(cfg.param_dtype))


def skeleton(cfg) -> Mamba2:
    """The parameter structure on the meta device in the master dtype."""
    return Mamba2(cfg, None, torch.device("meta"), _dtype(cfg.param_dtype))


def ref_location(cfg, name: str):
    """(reference path, layer index or None, stacked count or None) of a
    port tensor: ``layers.3.in_proj.weight`` -> (layers, in_proj), 3, L."""
    return L.stacked_ref_location(name, "layers", cfg.n_layers)


_LAYER_SPECS = {
    "ln": L.NORM_SPEC, "in_proj": ("embed", "inner_all"), "conv_w": ("conv", "inner"), "conv_b": ("inner",),
    "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",), "dt_bias": ("ssm_heads",), "norm": ("inner",),
    "out_proj": ("inner", "embed"),
}


def leaf_spec(cfg, path: tuple[str, ...]) -> tuple:
    """The reference's logical axis names of the leaf at ``path`` (a
    layer's slice for a stacked leaf), in its (in, out) order."""
    if path[0] == "layers":
        return _LAYER_SPECS[path[1]]
    return {"embed": L.EMBED_SPEC, "final_norm": L.NORM_SPEC}[path[0]]


# tensors the reference uses in float32 (or their master dtype) whatever the
# compute dtype: the norms and the SSM's per-head scalars
_KEPT = ("ln", "final_norm", "norm", "a_log", "d_skip", "dt_bias")


def cast_for_compute(p: Mamba2, cfg) -> Mamba2:
    """A copy of ``p`` with the tensors the reference casts with
    ``.astype(cfg.dtype)`` (embeddings, projections, the conv) cast once and
    the rest kept; a tensor already in ``cfg.dtype`` is shared."""
    dt = _dtype(cfg.dtype)
    state = {k: v if k.split(".")[-1] in _KEPT else v.to(dt) for k, v in p.state_dict().items()}
    out = skeleton(cfg)
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def _split_proj(cfg, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.d_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """The depthwise causal conv over xBC (``layers.causal_conv``), then
    SiLU -> (out, the next conv state)."""
    out, new_state = L.causal_conv(xbc, w, b, state)
    return F.silu(out), new_state


def ssd_chunked(x, b_in, c_in, dt, a_log, chunk: int) -> torch.Tensor:
    """Chunked SSD.  x: (B, S, H, P); b_in, c_in: (B, S, N); dt: (B, S, H)
    (after softplus); S a multiple of ``chunk``.  Returns y (B, S, H, P) in
    float32.  One group (B and C shared across heads).

    The reference's three-operand ``einsum("bcij,bcijh,bcjhp->bcihp")``
    runs as scores x decay (B, C, Q, Q, H) first, then a batched product
    with x dt over j: the (B, C, Q, Q, H, P) product never exists.
    """
    bsz, s_len, h, p_dim = x.shape
    n = b_in.shape[-1]
    q = chunk
    nc = s_len // q
    a = -torch.exp(a_log.float())                                # (H,)
    da = dt.float() * a                                          # (B, S, H)
    xc = x.reshape(bsz, nc, q, h, p_dim)
    bc = b_in.reshape(bsz, nc, q, n).float()
    cc = c_in.reshape(bsz, nc, q, n).float()
    dac = da.reshape(bsz, nc, q, h)
    dtc = dt.reshape(bsz, nc, q, h).float()

    cum = torch.cumsum(dac, dim=2)                               # (B, C, Q, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B, C, Qi, Qj, H)
    iq = torch.arange(q, device=x.device)
    cmask = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # mask BEFORE exp: anti-causal entries have seg >> 0 and overflow, and
    # an inf behind ``where`` still poisons the backward pass
    decay = torch.where(cmask, torch.exp(torch.where(cmask, seg, 0.0)), 0.0)

    # within-chunk ("diagonal") term
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)             # (B, C, Qi, Qj)
    xdt = xc.float() * dtc[..., None]                            # (B, C, Q, H, P)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * decay, xdt)

    # chunk-final states: S_c = sum_j exp(cum_last - cum_j) B_j (x_j dt_j)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)               # (B, C, Q, H)
    states = torch.einsum("bcjn,bcjhp->bchnp", bc, xdt * decay_out[..., None])

    # inter-chunk recurrence over nc steps: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B, C, H)
    s_prev = torch.zeros_like(states[:, 0])  # (B, H, N, P) float32
    entering = []
    for c in range(nc):
        entering.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(entering, dim=1)                       # (B, C, H, N, P)

    # off-chunk ("low-rank") term: y_off_i = C_i . (exp(cum_i) * S_prev)
    y_off = torch.einsum("bcin,bchnp->bcihp", cc, s_prevs) * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(bsz, s_len, h, p_dim)


def _final_state(xh, b_in, dtv, a_log) -> torch.Tensor:
    """The SSM state after the whole sequence, (B, H, N, P) float32:
    sum_j exp(sum_{k>j} dt_k A) dt_j B_j x_j (the reference's second
    reduction in ``prefill``)."""
    da = dtv * -torch.exp(a_log.float())
    rev_cum = torch.flip(torch.cumsum(torch.flip(da, [1]), dim=1), [1]) - da  # sum_{k>j} da_k
    xdt = xh.float() * dtv[..., None]
    return torch.einsum("bjn,bjhp->bhnp", b_in.float(), xdt * torch.exp(rev_cum)[..., None])


def _mixer(pl: Layer, h_in: torch.Tensor, cfg, conv_state=None, ssm_state=None, single_step: bool = False,
           final_state: bool = False):
    """The Mamba2 mixer -> (y, new conv state, new SSM state).  One token
    from (conv, ssm) states with ``single_step``; else the whole sequence,
    padded to ``cfg.ssd_chunk`` (a padded dt of 0: decay 1, no input), with
    the final SSM state where ``final_state`` asks for it (else None)."""
    dt_model = h_in.dtype
    di, n, nh, pdim = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_head
    proj = constrain(h_in @ pl.in_proj.weight.to(dt_model).T, ("act_batch", "act_seq", "act_ff"))
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(xbc, pl.conv_w, pl.conv_b, conv_state)
    x, b_in, c_in = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = softplus(dt_raw.float() + pl.dt_bias)
    bsz, s_len, _ = x.shape
    xh = unflatten(x, -1, (nh, pdim))

    if single_step:
        a = -torch.exp(pl.a_log.float())
        dec = torch.exp(dt[:, 0, :] * a)                          # (B, H)
        xdt = xh[:, 0].float() * dt[:, 0, :, None]                # (B, H, P)
        new_ssm = ssm_state * dec[..., None, None] + torch.einsum("bn,bhp->bhnp", b_in[:, 0].float(), xdt)
        y = torch.einsum("bn,bhnp->bhp", c_in[:, 0].float(), new_ssm)
        y = y + pl.d_skip[:, None] * xh[:, 0].float()
        y = reshape(y, (bsz, 1, di))
    else:
        pad = (-s_len) % cfg.ssd_chunk
        y = rowwise(lambda *a: ssd_chunked(*a, cfg.ssd_chunk),
                    (F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(b_in, (0, 0, 0, pad)), F.pad(c_in, (0, 0, 0, pad)),
                     F.pad(dt, (0, 0, 0, pad))), (pl.a_log,))
        y = y[:, :s_len] + pl.d_skip[:, None] * xh.float()
        y = reshape(y, (bsz, s_len, di))
        new_ssm = rowwise(_final_state, (xh, b_in, dt), (pl.a_log,)) if final_state else None

    y = L.rmsnorm(y.to(dt_model) * F.silu(z), pl.norm)
    return y @ pl.out_proj.weight.to(dt_model).T, new_conv, new_ssm


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block(pl: Layer, x: torch.Tensor, cfg) -> torch.Tensor:
    x = constrain(x, ("act_batch", "act_seq", "act_embed"))
    y, _, _ = _mixer(pl, L.rmsnorm(x, pl.ln), cfg)
    return x + y


def forward(p: Mamba2, cfg, tokens: torch.Tensor, patch_embeds=None):
    """Full-sequence forward -> (final hidden states (B, S, D), aux 0).
    Under ``cfg.remat``, while autograd records, each layer is
    checkpointed (recomputed in the backward), as the reference's
    ``jax.checkpoint(body)``."""
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    for pl in p.layers:
        x = checkpoint(_block, pl, x, cfg, use_reentrant=False) if remat else _block(pl, x, cfg)
    return L.rmsnorm(x, p.final_norm), torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(p: Mamba2, cfg, x: torch.Tensor) -> torch.Tensor:
    return x @ p.embed.to(x.dtype).T


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """Empty (conv, ssm) states on ``device`` (default the card, which
    raises without one unless ``device="cpu"``); ``max_len`` is unused:
    the state is O(1) in the sequence length."""
    del max_len
    device = resolve_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.n_ssm_heads, cfg.d_state, cfg.ssm_head),
                           dtype=torch.float32, device=device),
        "pos": 0,
    }


def decode_step(p: Mamba2, cfg, cache: dict, cur_tokens: torch.Tensor):
    """One decode step.  cur_tokens: (B, 1).  Returns (logits (B, V),
    cache), the cache's (conv, ssm) states updated in place."""
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), cur_tokens)
    for li, pl in enumerate(p.layers):
        conv, ssm = cache["conv"][li], cache["ssm"][li]
        y, conv_new, ssm_new = _mixer(pl, L.rmsnorm(x, pl.ln), cfg, conv_state=conv, ssm_state=ssm,
                                      single_step=True)
        conv.copy_(conv_new)
        ssm.copy_(ssm_new)
        x = x + y
    x = L.rmsnorm(x, p.final_norm)
    cache["pos"] = int(cache["pos"]) + 1
    return logits_fn(p, cfg, x)[:, 0], cache


def prefill(p: Mamba2, cfg, tokens: torch.Tensor, max_len: int, patch_embeds=None, cache_dtype=torch.bfloat16):
    """The chunked forward over the prompt, each layer also returning its
    conv tail and final SSM state.  Returns (last logits (B, V), cache)."""
    del max_len
    x = L.embed_lookup(p.embed.to(_dtype(cfg.dtype)), tokens)
    convs, ssms = [], []
    for pl in p.layers:
        y, conv, ssm = _mixer(pl, L.rmsnorm(x, pl.ln), cfg, final_state=True)
        x = x + y
        convs.append(conv.to(cache_dtype))
        ssms.append(ssm)
    x = L.rmsnorm(x, p.final_norm)
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms), "pos": tokens.shape[1]}
    return logits_fn(p, cfg, x[:, -1:])[:, 0], cache
