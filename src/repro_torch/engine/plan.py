"""The `Plan`: device + backend + chunk/tile sizes, resolved once.

The port of ``repro/engine/plan.py``.  A Plan is the single value threaded
through every pipeline stage; stages ask it to run the kNN, the edge
cascade or the MST range and never look at the hardware themselves.

Backends:
  * ``"cuda"``  — the hand-written Hopper kernels (tensors on the card).
  * ``"torch"`` — the kernels' plain PyTorch versions (tensors on the CPU).
  * ``"ref"``   — the oracles and the slot-array candidate path, on either.

The reference's XLA program cache (``cached_program`` / ``declare_family``)
has no counterpart: PyTorch runs eagerly and compiles nothing per shape.
Single device only; the mesh placement is a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch

PLAN_REQUESTS = ("auto", "single")
BACKENDS = ("cuda", "torch", "ref")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved execution plan for the clustering pipeline.

    ``device`` is where every tensor of the fit lives; ``backend`` picks
    the kernels (see the module docstring).  The tile and chunk fields are
    the reference's; the ones the port reads:

      * ``knn_block_q`` / ``knn_block_k`` — tiles of the plain blocked kNN
        (the CUDA kernel's tiles are compile-time constants of its source).
      * ``cascade_block_e`` — threads per block of the ``edge_cascade``
        kernel (a multiple of 32, at most 256); ``cascade_chunk`` — edges
        per chunk of its plain version.
      * ``lune_block_e`` / ``lune_block_c`` — the ``lune_filter`` kernel's
        edges per block (one warp each, 1 to 32) and points per
        shared-memory tile (an upper bound: the kernel shrinks the tile
        until it fits for the data's d).
      * ``candidate_method`` / ``dualtree_min_n`` — the candidate tier
        (``use_dualtree``); ``dualtree_leaf`` / ``dualtree_margin`` — the
        dual-tree traversals' leaf size and relative prune margin.
    """

    backend: str
    device: str = "cuda"
    knn_block_q: int = 1024
    knn_block_k: int = 2048
    knn_refine_slack: int = 8
    lune_block_e: int = 8
    lune_block_c: int = 512
    filter_chunk: int = 16384
    sbcn_tile_elems: int = 1 << 22
    sbcn_pair_cap: int = 1 << 18
    sbcn_row_chunk: int = 2048
    cascade_tie_cap: int = 3
    cascade_stage1_k: int = 2
    cascade_chunk: int = 65536
    cascade_block_e: int = 256
    tier_chunk_elems: int = 1 << 18
    candidate_method: str = "auto"  # "auto" | "wspd" | "dualtree"
    dualtree_min_n: int = 20000
    dualtree_leaf: int = 4
    dualtree_margin: float = 1e-5

    def use_dualtree(self, n: int) -> bool:
        """Size-tier dispatch for the candidate stages (kNN + graph build)."""
        if self.candidate_method == "dualtree":
            return True
        if self.candidate_method == "wspd":
            return False
        if self.candidate_method != "auto":
            raise ValueError(
                f"candidate_method must be 'auto', 'wspd' or 'dualtree'; "
                f"got {self.candidate_method!r}"
            )
        return n >= self.dualtree_min_n

    # -- stage dispatch ----------------------------------------------------

    def knn(self, x: torch.Tensor, k_top: int, *, x_host=None):
        """(d2 ascending, idx) of every row's ``k_top`` nearest other rows:
        the dual-tree candidate search on the host plus the shared exact
        refine on the large-n tier, the top-K kernel otherwise.  ``x_host``
        feeds the host search without a device sync when the caller already
        holds a host view (``fit_msts`` does)."""
        from ..kernels import ops

        n = int(x.shape[0])
        if n > 2 and self.use_dualtree(n):
            from ..core import dualtree
            from . import io

            if x_host is None:
                x_host = io.ensure_host(x)
            k_eff = min(n - 1, k_top + self.knn_refine_slack)
            cand = dualtree.knn_candidates(
                x_host, k_eff, leaf_size=self.dualtree_leaf, margin=self.dualtree_margin
            )
            return ops.knn_from_candidates(x, cand, k_top=k_top)
        return ops.knn(
            x,
            k_top,
            backend=self.backend,
            block_q=self.knn_block_q,
            block_k=self.knn_block_k,
            refine_slack=self.knn_refine_slack,
        )

    def query_knn(self, xq, x, k_top: int):
        """Out-of-sample kNN: query rows ranked against the fitted set."""
        from ..kernels import ops

        return ops.query_knn(
            xq, x, k_top,
            backend=self.backend,
            block_q=self.knn_block_q,
            block_k=self.knn_block_k,
            refine_slack=self.knn_refine_slack,
        )

    def lune_nonempty(self, ea, eb, w2, points, cd2):
        """Exact lune-emptiness verdicts for an edge list (``lune_filter``)."""
        from ..kernels import ops

        return ops.lune_nonempty(
            ea, eb, w2, points, cd2,
            backend=self.backend,
            block_e=self.lune_block_e,
            block_c=self.lune_block_c,
        )

    def edge_cascade(self, x, cd2k, knn_idx, knn_d2, ea, eb, valid, *, k_check: int, order: str):
        """Fused d2 + w2 + kNN-lune verdict + certificate over an edge list,
        summing squares in ``order`` (``kernels.ops.SUM_ORDERS``)."""
        from ..kernels import fused_cascade

        return fused_cascade.edge_cascade(
            x, cd2k, knn_idx, knn_d2, ea, eb, valid,
            k_check=k_check,
            order=order,
            chunk=self.cascade_chunk,
            block_e=self.cascade_block_e,
        )

    def mst_range(self, ea, eb, w_range, *, n: int):
        """All R MSTs as an (R, m) bool mask."""
        from ..core import boruvka

        return boruvka.boruvka_mst_range(ea, eb, w_range, n=n)

    def describe(self) -> str:
        return f"Plan(backend={self.backend!r}, device={self.device!r})"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The port's device rule: ``"cuda"`` by default, which raises without
    a card; the CPU only when the caller asks for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu'; got {dev}")
    return dev


def resolve_plan(
    plan: Plan | str | None = "auto",
    *,
    backend: str | None = None,
    device: str | torch.device | None = None,
    **sizes,
) -> Plan:
    """Resolve a plan request against the hardware, once.

    ``device`` defaults to ``"cuda"``.  Without a card that raises: a fit
    runs on the CPU only when the caller asks for ``device="cpu"``.
    ``backend=None`` picks ``"cuda"`` on the card and ``"torch"`` on the
    CPU.  Extra keyword args override individual chunk/tile sizes.
    """
    if isinstance(plan, Plan):
        return plan
    if plan is None:
        plan = "auto"
    if plan == "mesh":
        raise NotImplementedError(
            "plan='mesh' (multi-GPU) belongs to a later slice of the port"
        )
    if plan not in PLAN_REQUESTS:
        raise ValueError(f"plan must be one of {PLAN_REQUESTS} or a Plan; got {plan!r}")
    dev = resolve_device(device)
    backend = backend or ("cuda" if dev.type == "cuda" else "torch")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if (backend == "cuda") != (dev.type == "cuda") and backend != "ref":
        raise ValueError(
            f"backend {backend!r} does not run on device {dev}: 'cuda' needs "
            "the card, 'torch' runs on the CPU, 'ref' on either"
        )
    return Plan(backend=backend, device=str(dev), **sizes)
