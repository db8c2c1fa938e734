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

Sharded (the reference's pjit-ready step): with DTensor parameters,
states and batch (placed by ``dist.sharding``) the same function runs in
an ``activation_context``: the models' ``constrain`` calls place the
activations, each gradient is brought from ``Partial`` to its
parameter's placement before it is accumulated, and the metrics come
back as plain tensors.  Where the vocabulary is sharded the loss keeps the
logits sharded (``_logsumexp``, ``_label_logit``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import constrain
from ..models import get_model
from . import optim as optim_mod

def _chunk_nll(logits_fn: Callable, p, cfg, h, y, m) -> torch.Tensor:
    """Summed masked negative log-likelihood of one sequence chunk.  On a
    mesh the logits stay sharded over the vocabulary: the label's logit is
    gathered where it lives and combined before the last axis drops."""
    logits = constrain(logits_fn(p, cfg, h).float(), ("act_batch", "act_seq", "act_vocab"))
    rows = ("act_batch", "act_seq")  # each row's terms reduced across the vocabulary's ranks
    return torch.sum((constrain(_logsumexp(logits), rows) - constrain(_label_logit(logits, y), rows)) * m)


def _vocab_sharded(logits: torch.Tensor) -> bool:
    return isinstance(logits, DTensor) and any(isinstance(p, Shard) and p.dim == logits.ndim - 1
                                               for p in logits.placements)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocabulary: torch's, but where a mesh shards the
    vocabulary, as max + log(sum(exp(x - max))) with the max held constant
    (its gradient is nil), so the logits stay sharded (only the row maxima
    and sums are reduced across ranks; DTensor would gather the logits
    whole for torch's)."""
    if not _vocab_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    rows = ("act_batch", "act_seq", None)
    top = constrain(torch.amax(logits.detach(), dim=-1, keepdim=True), rows)
    return (top + torch.log(constrain(torch.sum(torch.exp(logits - top), dim=-1, keepdim=True), rows)))[..., 0]


def _label_logit(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """logits[..., y]: a gather.  On a mesh, where the vocabulary is
    sharded, each rank sums its own columns of the logits masked to the
    label's (the same value: every other term is an exact zero) and the
    result is ``Partial`` over the ranks sharding the vocabulary (reduced
    where the loss next needs it); a gather's backward would build the
    whole (B, S, V) gradient on every rank, and DTensor would gather the
    logits whole to mask them against a replicated column index."""
    if not _vocab_sharded(logits):
        return torch.gather(logits, -1, y[..., None].long())[..., 0]
    mesh, vocab = logits.device_mesh, logits.ndim - 1
    # the labels placed like the logits' rows, whole on the vocabulary's ranks
    rows = [Replicate() if isinstance(p, Shard) and p.dim == vocab else p for p in logits.placements]
    y = y.redistribute(mesh, rows) if isinstance(y, DTensor) else DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim)
    local = logits.to_local()
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, logits.placements)
    cols = offset[vocab] + torch.arange(local.shape[-1], device=local.device, dtype=y.dtype)
    part = torch.sum(torch.where(cols == y.to_local()[..., None], local, 0.0), dim=-1)
    out = [Partial() if isinstance(p, Shard) and p.dim == vocab else p for p in logits.placements]
    return DTensor.from_local(part, mesh, out, shape=logits.shape[:-1], stride=torch.empty(logits.shape[:-1],
                              device="meta").stride())


def xent_chunked(logits_fn: Callable, p, cfg, hidden, labels, mask) -> torch.Tensor:
    """Mean masked cross entropy, ``tot / max(cnt, 1)``, without the full
    logits.  hidden: (B, S, D); labels, mask: (B, S).

    The reference pads S to a multiple of the chunk with masked positions,
    which add exactly zero; here the last chunk is ragged instead.
    """
    hidden = constrain(hidden, ("act_batch", "act_seq", "act_embed"))  # the final norm's rows, whole on every model rank
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
            mask = torch.ones_like(labels, dtype=torch.float32)
        loss = xent_chunked(model.logits_fn, params, cfg, hidden, labels, mask)
        return loss + aux, {"xent": loss, "aux": aux}

    return loss_fn


def _placed_like(g: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements
    (a reduce-scatter or all-reduce of a Partial one); a plain one as it is."""
    if isinstance(param, DTensor):
        return g.redistribute(param.device_mesh, param.placements)
    return g


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor scalar reduced where Partial)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
            mb = batch
            if micro > 1:
                mb = {k: constrain(v[i * per:(i + 1) * per], ("act_batch",) + ("act_seq",) * (v.ndim - 1))
                      for k, v in batch.items()}
            slice_loss, _ = loss_fn(params, mb)
            grads = torch.autograd.grad(slice_loss, tensors)
            with torch.no_grad():
                # on a mesh, a gradient comes out Partial (summed over the
                # data ranks) or in the placement its last product left:
                # bring it to its parameter's placement before anything else
                grads = [_placed_like(g, t) for g, t in zip(grads, tensors)]
                # g / 1 is g, bit for bit: one slice keeps autograd's tensors
                grads = [g.to(acc_dt) if micro == 1 else (g.to(acc_dt) / micro).to(acc_dt) for g in grads]
                acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
                loss = loss + slice_loss.detach() / micro
            del grads
        params, opt_state, opt_metrics = opt_update(params, dict(zip(names, acc)), opt_state)
        return params, opt_state, {"loss": _whole(loss), **{k: _whole(v) for k, v in opt_metrics.items()}}

    return train_step
