"""Device->host materialization choke point + transfer accounting.

The port of ``repro/engine/io.py``.  Bulk device->host copies happen only
at named materialization points, with the reference's tag names:

  ``knn``             — the kNN stage's host view (feeds the WSPD control plane).
  ``candidate_count`` — fused path: the (slot, unique, mutual, tie-overflow)
                        counts in one sync; slot path: the unique count.
  ``candidate_slots`` — slot path only: the real SBCN slot count.
  ``stage1_count``    — fused path: the (certified, open) stage-1 survivor counts.
  ``graph``           — the RNG^kmax verdicts + edge arrays.
  ``lune_exact``      — variant="rng" only: the exact lune scan's verdicts
                        over the unresolved edges (``core.rng._exact_lune_pass``).
  ``mst``             — the MST compaction, the MST stage's single sync.
  ``linkage``         — the batched single-linkage merge arrays.
  ``predict``         — the out-of-sample path's single sync: per-row
                        (lambdas, attachment neighbours) of a query batch
                        (``core.predict.attach_queries``).
  ``candidates``      — the SBCN edge list's host view (debugging only).
  ``input``           — ``ensure_host`` normalizing a tensor handed to a
                        host-facing entry point.
  ``lm_decode``       — the LM serving engine's tokens, once a step (``serve.lm``).

``transfer_ledger`` records every ``to_host`` as ``(tag, nbytes)``.  It does
not guard implicit syncs the way the reference's JAX transfer guard does:
PyTorch's ``torch.cuda.set_sync_debug_mode`` counts them on the card, and
``chip_smoke.py`` reports that count for one warm fit.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_LEDGER = threading.local()


def _materialize(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialize(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    return tree


def _nbytes(tree) -> int:
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0))


def to_host(tree, tag: str):
    """Materialize a (nested tuple/list/dict of) tensors as numpy, ledgered.

    The only sanctioned device->host transfer in the clustering pipeline;
    ``tag`` names the materialization point (see module docstring).
    """
    out = _materialize(tree)
    ledger = getattr(_LEDGER, "value", None)
    if ledger is not None:
        ledger.append((tag, _nbytes(out)))
    return out


@contextlib.contextmanager
def transfer_ledger():
    """Record every ``to_host`` inside the context as ``(tag, nbytes)``."""
    prev = getattr(_LEDGER, "value", None)
    ledger: list[tuple[str, int]] = []
    _LEDGER.value = ledger
    try:
        yield ledger
    finally:
        _LEDGER.value = prev


def tags(ledger) -> list[str]:
    """The sequence of materialization tags a ledger recorded."""
    return [t for t, _ in ledger]


def ensure_host(x) -> np.ndarray:
    """Host view of ``x``: numpy passes through, tensors go through
    ``to_host`` under the ``input`` tag."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return to_host(x, "input")
    return np.asarray(x)
