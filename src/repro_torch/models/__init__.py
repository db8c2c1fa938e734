"""Model registry, the port of ``repro.models``: cfg.arch -> module.

Each family module exposes the reference's surface:
  init(cfg, generator, device) -> params (an ``nn.Module``)
  forward(p, cfg, tokens) -> (hidden, aux_loss)
  logits_fn(p, cfg, hidden) -> logits
  init_cache(cfg, batch, max_len, dtype, device) -> cache dict
  prefill(p, cfg, tokens, max_len, cache_dtype=...) -> (last_logits, cache)
  decode_step(p, cfg, cache, cur_tokens) -> (logits, cache)

The parameters are masters in ``cfg.param_dtype`` (float32 but for
kimi-k2's bfloat16) that require gradients: ``forward`` runs under
autograd, and ``train.step`` trains them.  Registered: ``"transformer"``
(the dense, MoE, MLA and patch-frontend configurations), ``"mamba2"``
(``ssm``), ``"griffin"`` and ``"encdec"`` (whose ``forward`` takes
``(dec_tokens, frames)`` and whose ``prefill`` takes the frames).
``abstract_init``
gives the parameters' shapes and master dtypes on the meta device, with
no memory behind them, at any size (kimi-k2's 1.045e12 parameters).

``reference_leaves`` maps each port tensor to the reference's leaf (each
family module's ``ref_location`` says where its tensors live), and
``params_from_jax`` carries a reference parameter pytree (numpy arrays)
across with it, so both packages compute the same function in the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.plan import resolve_device
from . import encdec, griffin, layers, ssm, transformer

_REGISTRY = {"transformer": transformer, "mamba2": ssm, "griffin": griffin, "encdec": encdec}


def get_model(cfg):
    if cfg.arch not in _REGISTRY:
        raise ValueError(f"{cfg.name}: unknown arch {cfg.arch!r}; choose from {sorted(_REGISTRY)}")
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

    The reference stacks the layers (griffin: the periods) on a leading
    axis and keeps dense
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


def reference_leaves(cfg) -> dict[str, RefLeaf]:
    """The reference leaf of every parameter of ``get_model(cfg)``, in the
    port's ``named_parameters`` order (read off the meta skeleton).  A
    stacked leaf's port tensors are named ``<stack>.<i>.<rest>`` (the
    transformer's and mamba2's ``layers``, griffin's ``period``, the
    encoder-decoder's ``enc`` and ``dec``); the
    module's ``ref_location`` gives the path, the index and the stacked
    count.  A tensor that is no ``nn.Linear`` weight (the MoE's experts,
    the convs, embeddings, norms) keeps the reference's layout."""
    model = get_model(cfg)
    out = {}
    for name, t in model.skeleton(cfg).named_parameters():
        shape = tuple(t.shape)
        transposed = name.endswith(".weight")
        if transposed:
            shape = shape[::-1]
        path, layer, count = model.ref_location(cfg, name)
        out[name] = RefLeaf(path, layer, transposed, shape if layer is None else (count, *shape))
    return out


def param_specs(cfg) -> dict[str, tuple]:
    """The logical axis names of every parameter (``named_parameters``
    order), in the port tensor's own dimension order: the reference's spec
    of its leaf (the family module's ``leaf_spec``) without the stacked
    ``layers`` axis, reversed where the tensor is an ``nn.Linear``
    weight, (out, in) against the reference's (in, out)."""
    model = get_model(cfg)
    out = {}
    for name, leaf in reference_leaves(cfg).items():
        spec = model.leaf_spec(cfg, leaf.path)
        out[name] = spec[::-1] if leaf.transposed else spec
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


__all__ = ["encdec", "griffin", "layers", "ssm", "transformer", "get_model", "abstract_init", "init_params"]
