"""Model registry, the port of ``repro.models``: cfg.arch -> module.

The transformer module exposes the reference's surface:
  init(cfg, generator, device) -> params (an ``nn.Module``)
  forward(p, cfg, tokens) -> (hidden, aux_loss)
  logits_fn(p, cfg, hidden) -> logits
  init_cache(cfg, batch, max_len, dtype, device) -> cache dict
  prefill(p, cfg, tokens, max_len, cache_dtype=...) -> (last_logits, cache)
  decode_step(p, cfg, cache, cur_tokens) -> (logits, cache)

The parameters are float32 masters that require gradients: ``forward``
runs under autograd, and ``train.step`` trains them.  Only
``"transformer"`` is registered, for the dense configurations.  The MoE,
MLA and frontend transformers and the SSM (mamba2), recurrent (griffin)
and encoder-decoder families come with later items of ``ROADMAP.md`` §1
(the LM stack).

``reference_leaves`` maps each port tensor to the reference's leaf, and
``params_from_jax`` carries a reference parameter pytree (numpy arrays)
across with it, so both packages compute the same function in the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.plan import resolve_device
from . import layers, transformer

_REGISTRY = {"transformer": transformer}
_LATER = {
    "mamba2": "the SSM family (mamba2)",
    "griffin": "the recurrent family (griffin)",
    "encdec": "the encoder-decoder family",
}


def get_model(cfg):
    if cfg.arch not in _REGISTRY:
        what = _LATER.get(cfg.arch, f"arch {cfg.arch!r}")
        raise NotImplementedError(f"{cfg.name}: {what} comes with a later item of ROADMAP.md §1 (the LM stack)")
    return _REGISTRY[cfg.arch]


def init_params(cfg, generator: torch.Generator, device: str | torch.device = "cuda"):
    """Random float32 master parameters on ``device`` (default the card,
    which raises without one unless ``device="cpu"``), drawn from
    ``generator``, which must lie on that device."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the parameters go to {dev}")
    return get_model(cfg).init(cfg, generator, dev)


@dataclasses.dataclass(frozen=True)
class RefLeaf:
    """Where a port tensor lives in the reference's parameter pytree.

    The reference stacks the layers on a leading axis and keeps dense
    weights as (in, out) for ``x @ W``; ``nn.Linear`` keeps (out, in).
    ``shape`` is the reference leaf's whole (stacked) shape, ``layer`` the
    port tensor's index on its leading axis (None for an unstacked leaf),
    and ``transposed`` says that the port tensor is the transpose of the
    reference's slice, so the reference's last axis is the port's dim 0.
    """

    path: tuple[str, ...]
    layer: int | None
    transposed: bool
    shape: tuple[int, ...]


def _ref_path(local: str) -> tuple[str, ...]:
    """A layer tensor's path in the reference: ``attn.wq.weight`` ->
    (attn, wq), ``attn.wq.bias`` -> (attn, bq), ``ln1`` -> (ln1,)."""
    parts = local.split(".")
    if parts[-1] == "weight":
        return tuple(parts[:-1])
    if parts[-1] == "bias":
        return (*parts[:-2], "b" + parts[-2][1:])
    return tuple(parts)


def reference_leaves(cfg) -> dict[str, RefLeaf]:
    """The reference leaf of every parameter of ``get_model(cfg)``, in the
    port's ``named_parameters`` order (read off the meta skeleton)."""
    out = {}
    for name, t in get_model(cfg).skeleton(cfg).named_parameters():
        shape = tuple(t.shape)
        transposed = name.endswith(".weight")
        if transposed:
            shape = shape[::-1]
        if name.startswith("layers."):
            _, i, local = name.split(".", 2)
            out[name] = RefLeaf(("layers", *_ref_path(local)), int(i), transposed, (cfg.n_layers, *shape))
        else:
            out[name] = RefLeaf((name,), None, transposed, shape)
    return out


def params_from_jax(cfg, tree, device: str | torch.device = "cuda"):
    """The port's parameters from the reference's pytree (numpy arrays):
    each tensor is its ``reference_leaves`` slice, transposed back where
    ``nn.Linear`` keeps (out, in).  The ``padded_vocab`` rows of the
    embeddings come across as they are.
    """
    dev = resolve_device(device)
    state = {}
    for name, leaf in reference_leaves(cfg).items():
        a = tree
        for key in leaf.path:
            a = a[key]
        a = np.asarray(a)
        if leaf.layer is not None:
            a = a[leaf.layer]
        state[name] = torch.from_numpy(np.array(a.T if leaf.transposed else a, np.float32)).to(dev)
    p = get_model(cfg).skeleton(cfg)
    p.load_state_dict(state, assign=True, strict=True)
    return p


__all__ = ["layers", "transformer", "get_model", "init_params"]
