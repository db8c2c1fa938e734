"""Model registry, the port of ``repro.models``: cfg.arch -> module.

The transformer module exposes the reference's surface:
  init(cfg, generator, device) -> params (an ``nn.Module``)
  forward(p, cfg, tokens) -> (hidden, aux_loss)
  logits_fn(p, cfg, hidden) -> logits
  init_cache(cfg, batch, max_len, dtype, device) -> cache dict
  prefill(p, cfg, tokens, max_len, cache_dtype=...) -> (last_logits, cache)
  decode_step(p, cfg, cache, cur_tokens) -> (logits, cache)

Only ``"transformer"`` is registered, for the dense configurations.  The
SSM (mamba2), recurrent (griffin) and encoder-decoder families, and the
MoE, MLA and frontend transformers, come with later items of
``ROADMAP.md`` §1 (the LM stack).

``params_from_jax`` carries a reference parameter pytree (numpy arrays)
across, so both packages compute the same function in the tests.
"""

from __future__ import annotations

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


def params_from_jax(cfg, tree, device: str | torch.device = "cuda"):
    """The port's parameters from the reference's pytree (numpy arrays).

    The reference stacks the layers on a leading axis and keeps dense
    weights as (in, out) for ``x @ W``; ``nn.Linear`` keeps (out, in), so
    each layer's weight is transposed.  The ``padded_vocab`` rows of the
    embeddings come across as they are.
    """
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dev)

    state = {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        state["unembed"] = t(tree["unembed"])
    lay = tree["layers"]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        state[pre + "ln1"] = t(lay["ln1"][i])
        state[pre + "ln2"] = t(lay["ln2"][i])
        for name in ("wq", "wk", "wv", "wo"):
            state[pre + f"attn.{name}.weight"] = t(np.asarray(lay["attn"][name][i]).T)
        if cfg.qkv_bias:
            for name in ("q", "k", "v"):
                state[pre + f"attn.w{name}.bias"] = t(lay["attn"][f"b{name}"][i])
        for name in ("wi", "wo"):
            state[pre + f"mlp.{name}.weight"] = t(np.asarray(lay["mlp"][name][i]).T)
        for name, bias in (("wi", "bi"), ("wo", "bo")):
            if bias in lay["mlp"]:
                state[pre + f"mlp.{name}.bias"] = t(lay["mlp"][bias][i])
    p = get_model(cfg).skeleton(cfg)
    p.load_state_dict(state, assign=True, strict=True)
    return p


__all__ = ["layers", "transformer", "get_model", "init_params"]
