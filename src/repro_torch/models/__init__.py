"""Model registry, the port of ``repro.models``: cfg.arch -> module.

The transformer module exposes the reference's surface:
  init(cfg, generator, device) -> params (an ``nn.Module``)
  forward(p, cfg, tokens) -> (hidden, aux_loss)
  logits_fn(p, cfg, hidden) -> logits
  init_cache(cfg, batch, max_len, dtype, device) -> cache dict
  prefill(p, cfg, tokens, max_len, cache_dtype=...) -> (last_logits, cache)
  decode_step(p, cfg, cache, cur_tokens) -> (logits, cache)

The parameters are masters in ``cfg.param_dtype`` (float32 but for
kimi-k2's bfloat16) that require gradients: ``forward`` runs under
autograd, and ``train.step`` trains them.  Only ``"transformer"`` is
registered: the dense, MoE, MLA and patch-frontend configurations.  The
SSM (mamba2), recurrent (griffin) and encoder-decoder families come with
a later item of ``ROADMAP.md`` §1 (the LM stack).  ``abstract_init``
gives the parameters' shapes and master dtypes on the meta device, with
no memory behind them, at any size (kimi-k2's 1.045e12 parameters).

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
    """Random master parameters in ``cfg.param_dtype`` on ``device``
    (default the card, which raises without one unless ``device="cpu"``),
    drawn in float32 from ``generator``, which must lie on that device,
    and cast tensor by tensor (the reference casts every float32 leaf)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the parameters go to {dev}")
    return get_model(cfg).init(cfg, generator, dev)


def abstract_init(cfg):
    """The parameters on the meta device in the master dtype (shapes and
    dtypes, nothing allocated): the counterpart of the reference's
    ``abstract_init``, whose leaves are ``reference_leaves(cfg)``."""
    return get_model(cfg).skeleton(cfg)


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
    port's ``named_parameters`` order (read off the meta skeleton).  A
    tensor that is no ``nn.Linear`` weight (the MoE's (E, d, 2f) and
    (E, f, d) experts, embeddings, norms) keeps the reference's layout."""
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
            out[name] = RefLeaf(_ref_path(name), None, transposed, shape)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype.  A bfloat16 array (the
    ``ml_dtypes`` type JAX hands out, which ``torch.from_numpy`` refuses)
    crosses through its 16-bit integer view."""
    a = np.array(a)  # a contiguous, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(cfg, tree, device: str | torch.device = "cuda"):
    """The port's parameters from the reference's pytree (numpy arrays):
    each tensor is its ``reference_leaves`` slice, transposed back where
    ``nn.Linear`` keeps (out, in), in its leaf's dtype (float32 or
    bfloat16 masters).  The ``padded_vocab`` rows of the embeddings come
    across as they are.
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
        state[name] = _tensor(a.T if leaf.transposed else a).to(dev)
    p = get_model(cfg).skeleton(cfg)
    p.load_state_dict(state, assign=True, strict=True)
    return p


__all__ = ["layers", "transformer", "get_model", "abstract_init", "init_params"]
