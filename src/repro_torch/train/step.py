"""Training step, the port of ``repro/train/step.py``: chunked cross
entropy, microbatch gradient accumulation, loss masking, and the
``train_step`` the launcher runs.

Memory discipline, as in the reference:
  * the cross entropy runs in sequence chunks (``cfg.xent_chunk``), each
    under ``torch.utils.checkpoint``, so a chunk's float32 logits live
    only while it is computed and are recomputed in the backward: the
    (B, S, V) logits never live whole, forward or backward;
  * gradients accumulate over ``cfg.microbatch`` contiguous slices of the
    batch, as ``g / micro`` in ``cfg.grad_accum_dtype``.

The step updates the parameters (an ``nn.Module`` of masters) and
the optimizer state in place, where the reference's launcher donates them
to its jitted step (``repro/launch/train.py``): after a step the old
values are gone, and the returned objects are the ones passed in.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..models import get_model
from . import optim as optim_mod

def _chunk_nll(logits_fn: Callable, p, cfg, h, y, m) -> torch.Tensor:
    """Summed masked negative log-likelihood of one sequence chunk."""
    logits = logits_fn(p, cfg, h).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return torch.sum((lse - ll) * m)


def xent_chunked(logits_fn: Callable, p, cfg, hidden, labels, mask) -> torch.Tensor:
    """Mean masked cross entropy, ``tot / max(cnt, 1)``, without the full
    logits.  hidden: (B, S, D); labels, mask: (B, S).

    The reference pads S to a multiple of the chunk with masked positions,
    which add exactly zero; here the last chunk is ragged instead.
    """
    s_len = hidden.shape[1]
    chunk = min(cfg.xent_chunk, s_len)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s_len, chunk):
        args = (logits_fn, p, cfg, hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk], mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            tot = tot + _chunk_nll(*args)
        cnt = cnt + torch.sum(mask[:, lo:lo + chunk])
    return tot / torch.clamp_min(cnt, 1.0)


def make_loss_fn(cfg):
    """loss_fn(params, batch) -> (loss + aux, {"xent", "aux"}) for a model
    of any registered family.  A decoder's batch (transformer, mamba2,
    griffin) holds ``tokens``, ``labels``, optionally ``mask`` and, for a
    patch frontend, ``patch_embeds``; the encoder-decoder's holds
    ``frames``, ``dec_tokens``, ``dec_labels`` and optionally
    ``dec_mask``.  ``aux`` is the MoE layers' summed load-balance loss (0
    without experts)."""
    model = get_model(cfg)

    def loss_fn(params, batch):
        if cfg.arch == "encdec":
            hidden, aux = model.forward(params, cfg, batch["dec_tokens"], batch["frames"])
            labels, mask = batch["dec_labels"], batch.get("dec_mask")
        else:
            hidden, aux = model.forward(params, cfg, batch["tokens"], batch.get("patch_embeds"))
            labels, mask = batch["labels"], batch.get("mask")
            if cfg.frontend == "patches":
                # hidden covers [patches | text]; the loss runs over the text only
                hidden = hidden[:, -labels.shape[1]:]
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        loss = xent_chunked(model.logits_fn, params, cfg, hidden, labels, mask)
        return loss + aux, {"xent": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg, opt_cfg: optim_mod.OptConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``{loss, lr, grad_norm}``.

    The batch's leading axis splits into ``cfg.microbatch`` contiguous
    slices; the loss is the mean of the slices' losses, and each slice's
    gradient adds ``g / micro`` in ``cfg.grad_accum_dtype``.
    """
    loss_fn = make_loss_fn(cfg)
    _, opt_update = optim_mod.make_optimizer(opt_cfg, cfg)
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        micro = max(cfg.microbatch, 1)
        rows = batch["dec_tokens" if cfg.arch == "encdec" else "tokens"].shape[0]
        if rows % micro:
            raise ValueError(f"a batch of {rows} rows does not split into {micro} microbatches")
        per = rows // micro
        names, tensors = zip(*params.named_parameters())
        acc = None
        loss = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        for i in range(micro):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            slice_loss, _ = loss_fn(params, mb)
            grads = torch.autograd.grad(slice_loss, tensors)
            with torch.no_grad():
                # g / 1 is g, bit for bit: one slice keeps autograd's tensors
                grads = [g.to(acc_dt) if micro == 1 else (g.to(acc_dt) / micro).to(acc_dt) for g in grads]
                acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
                loss = loss + slice_loss.detach() / micro
            del grads
        params, opt_state, opt_metrics = opt_update(params, dict(zip(names, acc)), opt_state)
        return params, opt_state, {"loss": loss, **opt_metrics}

    return train_step
