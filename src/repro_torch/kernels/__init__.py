"""Hand-written Hopper kernels for the pipeline's hot spots, each beside its
plain PyTorch version.

Layout per kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
``_build`` at first use and loaded with ctypes) and ``<module>.py`` (the
wrapper, its plain version and its launch counter); ``ops.py`` holds the
kNN, query-kNN and lune-scan dispatch and ``ref.py`` the oracles.
``prim_mst`` (the baseline's dense Prim) and ``single_linkage`` (the
union-find of extraction) port device loops the reference runs outside
any Pallas kernel, and ``sbcn_tile`` the SBCN tiles' products above
d = 256 in the reference's float32 order.

As in the reference, the package binds ``pairwise_topk``, ``edge_cascade``
and ``lune_filter`` to the kernel functions; reach a kernel's module by its
own name (``importlib.import_module("repro_torch.kernels.pairwise_topk")``
or ``from repro_torch.kernels.pairwise_topk import ...``).
"""

from . import fused_cascade, ops, ref
from .fused_cascade import edge_cascade
from .lune_filter import lune_filter
from .pairwise_topk import pairwise_topk

__all__ = [
    "edge_cascade", "fused_cascade", "lune_filter", "ops", "pairwise_topk",
    "ref",
]
