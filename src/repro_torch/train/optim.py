"""Optimizers, the port of ``repro/train/optim.py``: AdamW with float32,
bfloat16 or int8-blockwise states, and Adafactor, with the reference's
schedule and global-norm clipping.

The reference updates a parameter pytree whose layers are stacked on a
leading axis and whose dense weights are (in, out); the port keeps one
tensor per layer, (out, in) for an ``nn.Linear``.  Four of the
reference's rules depend on its leaf, not on the port's tensor, so each
port tensor is updated as the slice of its reference leaf
(``models.reference_leaves``, built once from the model's config):

  (a) weight decay applies where the *stacked* leaf has ndim >= 2: every
      layer tensor (the per-layer norms, QKV biases and mamba2's per-head
      ``a_log``, ``d_skip``, ``dt_bias`` included) and the embeddings, but
      not ``final_norm`` nor griffin's unstacked remainder norms and
      ``lam``;
  (b) int8 states quantize in blocks of 32 along the reference's last
      axis (an ``nn.Linear`` weight's dim 0) and are kept in the layout of
      the reference's slice; ``v`` is stored in the sqrt domain, and a
      leaf whose last axis is not a multiple of 32 keeps bfloat16 states;
  (c) Adafactor factors the stacked leaf: an (L, in, out) weight layer by
      layer (``vr`` the mean over out, ``vc`` over in), but the (L, D)
      norms, biases and head vectors as one matrix each, whose ``vc`` and
      normaliser are means across the L layers (griffin: the periods), so
      those layers' updates are coupled; an unstacked (D,) leaf is not
      factored;
  (d) the schedule and the bias corrections are float32 tensors.

Float states keep the port tensor's own layout.  Parameters and states
are updated in place, as the reference donates them: ``update(params,
grads, state)`` returns the same objects, and clips ``grads`` in place.

On a mesh (``dist.sharding``) the parameters, gradients and states are
DTensors and the same code runs on them: the global norm's per-tensor
sums of squares are ``Partial`` and reduce across the ranks; an int8
state's ``q`` lies like its parameter and its ``scale`` whole on every
rank, so a block of 32 that a shard boundary splits takes its absmax as a
``Partial(max)`` over the ranks holding it, and where the shards do not
split the blocks evenly (kimi-k2's 384 experts, 12 blocks over 16
ranks) ``dist.sharding.reshape`` gathers that state's rows for the
encoding; Adafactor's means over a sharded dimension reduce the same way,
into replicated factored states.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..dist.sharding import reshape
from ..models import RefLeaf, reference_leaves

_BLOCK = 32  # the reference's block: sharded last dims stay block-divisible


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in float32 (``step`` an int32
    tensor)."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * prog)
    return cfg.lr * warm * cos


def _slice_view(t: torch.Tensor, leaf: RefLeaf) -> torch.Tensor:
    """``t`` (a port tensor, or a state in its layout) as a view in the
    layout of its reference slice."""
    return t.T if leaf.transposed else t


def _slice_shape(leaf: RefLeaf) -> tuple[int, ...]:
    return leaf.shape[1:] if leaf.layer is not None else leaf.shape


# ---------------------------------------------------------------------------
# int8 blockwise quantized tensors (blocks along the last axis)
# ---------------------------------------------------------------------------


def q8_compatible(shape) -> bool:
    """Blocks run along the reference leaf's LAST axis, so the quantized
    tensors keep the leaf's shape (and, in the reference, its sharding)."""
    return len(shape) >= 1 and shape[-1] % _BLOCK == 0


def _q8_zeros(shape, device) -> dict:
    return {
        "q": torch.zeros(shape, dtype=torch.int8, device=device),
        "scale": torch.zeros((*shape[:-1], shape[-1] // _BLOCK), dtype=torch.float32, device=device),
    }


def _q8_encode(x: torch.Tensor) -> dict:
    shape = x.shape
    blocks = reshape(x, (*shape[:-1], shape[-1] // _BLOCK, _BLOCK)).float()
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0
    q = torch.round(blocks / torch.clamp_min(scale[..., None], 1e-20)).to(torch.int8)
    return {"q": reshape(q, shape), "scale": scale}


def _q8_decode(qt: dict) -> torch.Tensor:
    shape = qt["q"].shape
    q = reshape(qt["q"], (*shape[:-1], shape[-1] // _BLOCK, _BLOCK))
    return reshape(q.float() * qt["scale"][..., None], shape)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _store(state, leaf: RefLeaf, value: torch.Tensor) -> None:
    """Write a float32 moment (in the slice's layout) into its state."""
    if _is_q8(state):
        enc = _q8_encode(value)
        state["q"].copy_(enc["q"])
        state["scale"].copy_(enc["scale"])
    else:
        _slice_view(state, leaf).copy_(value)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: OptConfig, leaves: dict[str, RefLeaf]) -> dict:
    def zeros_like_state(name: str, p: torch.Tensor):
        leaf = leaves[name]
        if cfg.state_dtype == "int8" and q8_compatible(leaf.shape):
            return _q8_zeros(_slice_shape(leaf), p.device)
        # bfloat16 states, and the int8 config's fallback for q8-incompatible leaves
        dt = torch.float32 if cfg.state_dtype == "float32" else torch.bfloat16
        return torch.zeros_like(p, dtype=dt)

    named = dict(params.named_parameters())
    device = next(iter(named.values())).device
    return {
        "m": {n: zeros_like_state(n, p) for n, p in named.items()},
        "v": {n: zeros_like_state(n, p) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(params, grads: dict, state: dict, cfg: OptConfig, leaves: dict[str, RefLeaf]):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    gnorm = clip_by_global_norm(grads, cfg.clip_norm)

    for name, p in params.named_parameters():
        leaf = leaves[name]
        m, v = state["m"][name], state["v"][name]
        pv = _slice_view(p, leaf)
        gf = _slice_view(grads[name], leaf).float()
        mf = _q8_decode(m) if _is_q8(m) else _slice_view(m, leaf).float()
        # v is quantized in the sqrt domain (the reference's reason: linear
        # absmax int8 on raw v flushes a block's small entries to zero)
        vf = _q8_decode(v) ** 2 if _is_q8(v) else _slice_view(v, leaf).float()
        mf = cfg.b1 * mf + (1 - cfg.b1) * gf
        vf = cfg.b2 * vf + (1 - cfg.b2) * gf * gf
        update = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        if len(leaf.shape) >= 2:  # rule (a): the stacked leaf's ndim
            update = update + cfg.weight_decay * pv.float()
        pv.copy_((pv.float() - lr * update).to(p.dtype))
        _store(m, leaf, mf)
        _store(v, leaf, torch.sqrt(vf) if _is_q8(v) else vf)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for leaves of ndim >= 2)
# ---------------------------------------------------------------------------


def _adafactor_units(leaves: dict[str, RefLeaf]) -> dict[str, list[str]]:
    """State key -> the port tensors updated together.  A stacked leaf of
    ndim 2 (a per-layer norm, bias or SSM head vector, (L, D); griffin's
    per-period ones) is one matrix across its layers, keyed by its tensors'
    common name with the index starred (``layers.*.ln1``,
    ``period.*.mix0.lam``); every other tensor is its own unit, keyed by
    its name."""
    units: dict[str, list[str]] = {}
    for name, leaf in leaves.items():
        key = name
        if _coupled(leaf):
            stack, _, rest = name.split(".", 2)
            key = f"{stack}.*.{rest}"
        units.setdefault(key, []).append(name)
    return units


def _coupled(leaf: RefLeaf) -> bool:
    return leaf.layer is not None and len(leaf.shape) == 2


def adafactor_init(params, cfg: OptConfig, leaves: dict[str, RefLeaf]) -> dict:
    device = next(params.parameters()).device
    f32 = dict(dtype=torch.float32, device=device)

    def zeros(shape):
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], **f32), "vc": torch.zeros((*shape[:-2], shape[-1]), **f32)}
        return {"v": torch.zeros(shape, **f32)}

    units = _adafactor_units(leaves)
    return {"f": {key: zeros(leaves[names[0]].shape if _coupled(leaves[names[0]]) else _slice_shape(leaves[names[0]]))
                  for key, names in units.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adafactor_update(params, grads: dict, state: dict, cfg: OptConfig, leaves: dict[str, RefLeaf]):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    d = 1.0 - cfg.b2
    named = dict(params.named_parameters())

    for key, names in _adafactor_units(leaves).items():
        f = state["f"][key]
        ps = [_slice_view(named[n], leaves[n]) for n in names]
        gs = [_slice_view(grads[n], leaves[n]) for n in names]
        # a coupled unit is its stacked (L, D) leaf; any other, its slice
        coupled = _coupled(leaves[names[0]])
        p = torch.stack(ps) if coupled else ps[0]
        gf = (torch.stack(gs) if coupled else gs[0]).float()
        g2 = gf * gf + 1e-30
        if gf.ndim >= 2:
            vr = cfg.b2 * f["vr"] + d * torch.mean(g2, dim=-1)
            vc = cfg.b2 * f["vc"] + d * torch.mean(g2, dim=-2)
            denom = torch.sqrt(
                vr[..., None] * vc[..., None, :]
                / torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True)[..., None], 1e-30)
            )
            update = gf / torch.clamp_min(denom, 1e-30)
            f["vr"].copy_(vr)
            f["vc"].copy_(vc)
        else:
            v = cfg.b2 * f["v"] + d * g2
            update = gf / (torch.sqrt(v) + cfg.eps)
            f["v"].copy_(v)
        newp = (p.float() - lr * update).to(p.dtype)
        for i, pv in enumerate(ps):
            pv.copy_(newp[i] if coupled else newp)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` (name -> tensor) in place to a global norm of at most
    ``max_norm``; returns the norm before clipping."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    for g in grads.values():
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            # the reference's ``(g * scale).astype(g.dtype)``: the product in
            # float32, rounded once (a bfloat16 gradient of a bfloat16 master)
            g.copy_(g.float() * scale)
    return gn


def make_optimizer(cfg: OptConfig, model_cfg):
    """(init(params) -> state, update(params, grads, state) -> (params,
    state, metrics)) for the model of ``model_cfg``, whose reference leaves
    the rules (a)-(c) read."""
    leaves = reference_leaves(model_cfg)
    if cfg.name == "adamw":
        return (
            functools.partial(adamw_init, cfg=cfg, leaves=leaves),
            functools.partial(adamw_update, cfg=cfg, leaves=leaves),
        )
    if cfg.name == "adafactor":
        return (
            functools.partial(adafactor_init, cfg=cfg, leaves=leaves),
            functools.partial(adafactor_update, cfg=cfg, leaves=leaves),
        )
    raise ValueError(cfg.name)
