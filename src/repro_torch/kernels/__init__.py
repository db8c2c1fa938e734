"""Hand-written Hopper kernels for the pipeline's hot spots, each beside its
plain PyTorch version.

Layout per kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
``_build`` at first use and loaded with ctypes) and ``<module>.py`` (the
wrapper, its plain version and its launch counter); ``ops.py`` holds the
kNN, query-kNN and lune-scan dispatch and ``ref.py`` the oracles.
"""

from . import fused_cascade, lune_filter, ops, pairwise_topk, ref

__all__ = ["fused_cascade", "lune_filter", "ops", "pairwise_topk", "ref"]
