"""repro_torch: the multi-density HDBSCAN* pipeline on PyTorch and CUDA.

The PyTorch port of the ``repro`` package.  Module names mirror the
reference, so every port module has one reference module with the same
name.  The port imports ``torch``, numpy and scipy and nothing of JAX.

Device policy: entry points take ``device=`` and default to ``"cuda"``,
where the hand-written Hopper kernels run (backend ``"cuda"``).
``device="cpu"`` selects backend ``"torch"``, the plain PyTorch versions
of those kernels.  A fit that asks for the card on a machine without one
raises; it never carries on on the CPU.

Float32 products are pinned to full precision at import: the SBCN tie
tolerance ``64 * 2**-23 * (|a|^2 + |b|^2)`` and the lune margins assume
them, and TF32 keeps only about three decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "1.3.0"

__all__ = [
    "FittedModel",
    "MultiHDBSCAN",
    "Plan",
    "SelectionPolicy",
    "resolve_plan",
    "__version__",
]


def __getattr__(name):
    if name in ("MultiHDBSCAN", "FittedModel", "SelectionPolicy"):
        from . import api

        return getattr(api, name)
    if name in ("Plan", "resolve_plan"):
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
