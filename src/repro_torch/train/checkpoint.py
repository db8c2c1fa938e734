"""Checkpointing with atomic commit + auto-resume, the port of
``repro/train/checkpoint.py``, on the reference's on-disk layout.

Layout:  <dir>/step_<N>/  arrays.npz  manifest.json   (+ .tmp staging)

  * atomic commit: writes go to ``step_N.tmp``, are fsynced, and are
    renamed only then — a killed writer never corrupts the latest
    checkpoint;
  * keys are the state's nested dict keys joined by ``/``; the parameters
    of a port model are its ``named_parameters`` (``params/layers.0.ln1``),
    and a reference checkpoint's pytree comes back nested as it was
    (``params/layers/ln1``, for ``models.params_from_jax``);
  * async: ``save(..., blocking=False)`` makes its host copy before it
    returns and hands only the writing to a thread (one outstanding save
    at most).  The copy must come first: the next optimizer step updates
    the parameters and states in place;
  * numpy has no bfloat16, so a bfloat16 tensor is stored as its int16
    bits and named in the manifest's ``bfloat16_keys``;
  * mesh-agnostic, as the reference: a sharded state (DTensors) is saved
    at its GLOBAL shape in the same layout, every rank taking part in the
    gathers and the process group's rank 0 alone writing, and
    ``restore(..., shardings=...)`` re-distributes each tensor onto
    whatever mesh the restart runs with;
  * the data pipeline needs no state beyond ``step`` (see train/data.py).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(v) -> np.ndarray:
    """A host copy that nothing else holds (a CPU tensor is copied too); a
    DTensor's whole tensor (a collective: every rank calls it)."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        h = v.detach().to("cpu", copy=True)
        return (h.view(torch.int16) if h.dtype == torch.bfloat16 else h).numpy()
    return np.array(v)


_pending: list[threading.Thread] = []


def _writer() -> bool:
    """Whether this process writes: rank 0 of the process group, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, state: dict, *, blocking: bool = True, meta: dict | None = None):
    """state: nested dicts of tensors (params, opt_state, ...), plain or
    DTensors.  With DTensors every rank calls ``save`` (their whole
    tensors are gathered) and rank 0 writes."""
    flat = _flatten(state)
    host = {k: _to_host(v) for k, v in flat.items()}
    bf16 = sorted(k for k, v in flat.items() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16)
    if not _writer():
        return

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        arrays = os.path.join(tmp, "arrays.npz")
        np.savez(arrays, **host)
        with open(arrays, "rb") as f:
            os.fsync(f.fileno())
        manifest = {"step": step, "keys": sorted(host.keys()), "bfloat16_keys": bf16, **(meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
    else:
        wait_pending()
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _pending.append(t)


def wait_pending():
    while _pending:
        _pending.pop().join()


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int | None = None, shardings=None,
            device: str | torch.device = "cpu") -> tuple[dict, int]:
    """Load a checkpoint as nested dicts of tensors on ``device``; with
    ``shardings`` (nested dicts of ``dist.sharding.NamedSharding``, keyed as
    the state), each tensor that has one becomes a DTensor on its mesh."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        bf16 = set(json.load(f).get("bfloat16_keys", ()))
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k in z.files:
            t = torch.from_numpy(z[k])
            flat[k] = (t.view(torch.bfloat16) if k in bf16 else t).to(device)
    if shardings is not None:
        placed = _flatten(shardings)
        flat = {k: placed[k].place(v) if k in placed else v for k, v in flat.items()}
    return _unflatten(flat), step
