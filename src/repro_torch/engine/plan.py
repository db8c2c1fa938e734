"""The `Plan`: device + backend + chunk/tile sizes, resolved once.

The port of ``repro/engine/plan.py``.  A Plan is the single value threaded
through every pipeline stage; stages ask it to run the kNN, the edge
cascade or the MST range and never look at the hardware themselves.

Backends:
  * ``"cuda"``  — the hand-written Hopper kernels (tensors on the card).
  * ``"torch"`` — the kernels' plain PyTorch versions (tensors on the CPU).
  * ``"ref"``   — the oracles and the slot-array candidate path, on either.

Placement: with a ``torch.distributed`` ``DeviceMesh`` (``launch.mesh``)
the row-parallel stages (the kNN, the exact lune scan, the per-mpts
Borůvka rows) shard over the mesh's ``axis`` (``dist.cluster_parallel``),
every rank running the same fit; the request (``"auto"`` / ``"single"``
/ ``"mesh"``) is filtered against the mesh that exists, as in the
reference, so a one-rank mesh runs the single-device path.

The reference's XLA program cache (``cached_program`` / ``declare_family``)
has no counterpart: PyTorch runs eagerly and compiles nothing per shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

PLAN_REQUESTS = ("auto", "single", "mesh")
BACKENDS = ("cuda", "torch", "ref")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved execution plan for the clustering pipeline.

    ``device`` is where every tensor of the fit lives; ``backend`` picks
    the kernels (see the module docstring).  ``mesh`` (a ``DeviceMesh`` of
    ``device``'s type, or None for one device) and ``axis``, the mesh
    dimension the rows shard over, place the row-parallel stages.  The
    tile and chunk fields are the reference's; the ones the port reads:

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
    mesh: Any = None
    axis: str = "data"
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

    def __post_init__(self):
        if self.mesh is not None and self.mesh.device_type != torch.device(self.device).type:
            raise ValueError(
                f"the mesh's device type {self.mesh.device_type!r} is not the plan's device {self.device!r}"
            )

    # -- placement ---------------------------------------------------------

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def n_shards(self) -> int:
        from ..dist import cluster_parallel

        return cluster_parallel.axis_size(self.mesh, self.axis) if self.mesh is not None else 1

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
        the ring kNN over the mesh when sharded, the dual-tree candidate
        search on the host plus the shared exact refine on the large-n
        tier, the top-K kernel otherwise.  ``x_host`` feeds the host search
        without a device sync when the caller already holds a host view
        (``fit_msts`` does)."""
        from ..kernels import ops

        n = int(x.shape[0])
        if not self.sharded and n > 2 and self.use_dualtree(n):
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
            backend="mesh" if self.sharded else self.backend,
            mesh=self.mesh,
            mesh_axis=self.axis,
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
        """Exact lune-emptiness verdicts for an edge list (``lune_filter``),
        each rank scanning its rows of the points when sharded."""
        from ..kernels import ops

        return ops.lune_nonempty(
            ea, eb, w2, points, cd2,
            backend="mesh" if self.sharded else self.backend,
            mesh=self.mesh,
            mesh_axis=self.axis,
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
        """All R MSTs as an (R, m) bool mask; the rows (independent mpts
        values) shard over the mesh."""
        if self.sharded:
            from ..dist import cluster_parallel

            return cluster_parallel.sharded_mst_range(ea, eb, w_range, n=n, mesh=self.mesh, axis=self.axis)
        from ..core import boruvka

        return boruvka.boruvka_mst_range(ea, eb, w_range, n=n)

    def describe(self) -> str:
        place = f"mesh[{self.axis}={self.n_shards}]" if self.sharded else "single"
        return f"Plan(backend={self.backend!r}, device={self.device!r}, placement={place})"


def _mesh_usable(mesh, axis: str) -> bool:
    """A mesh is worth sharding over iff the row axis exists and is > 1."""
    from ..dist import cluster_parallel

    return mesh is not None and axis in (mesh.mesh_dim_names or ()) and cluster_parallel.axis_size(mesh, axis) > 1


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The port's device rule: ``"cuda"`` by default, which raises without
    a card; the CPU only when the caller asks for ``device="cpu"``;
    ``"meta"`` (shapes, no memory) for the dry runs' caches."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be a CUDA device, 'cpu' or 'meta'; got {dev}")
    return dev


def resolve_plan(
    plan: Plan | str | None = "auto",
    *,
    backend: str | None = None,
    mesh=None,
    axis: str = "data",
    device: str | torch.device | None = None,
    **sizes,
) -> Plan:
    """Resolve a plan request against the hardware, once.

    ``plan`` is a resolved ``Plan`` (returned as it is; passing a
    different ``mesh`` beside it raises) or one of the requests:

      * ``"auto"`` (default): shard iff ``mesh`` has an ``axis`` of more
        than one rank, else one device;
      * ``"single"``: one device, the mesh ignored;
      * ``"mesh"``: shard, and raise where ``mesh`` cannot be sharded over
        instead of degrading.

    ``device`` defaults to ``"cuda"``.  Without a card that raises: a fit
    runs on the CPU only when the caller asks for ``device="cpu"``, and a
    mesh must be of the device's type (NCCL on the card, gloo on the CPU).
    ``backend=None`` picks ``"cuda"`` on the card and ``"torch"`` on the
    CPU.  Extra keyword args override individual chunk/tile sizes.
    """
    if isinstance(plan, Plan):
        if mesh is not None and plan.mesh is not mesh:
            raise ValueError(
                "got both a pre-built Plan and a different mesh=; build the Plan against that mesh "
                "(resolve_plan(..., mesh=mesh) or dataclasses.replace(plan, mesh=mesh)) instead of passing both"
            )
        return plan
    if plan is None:
        plan = "auto"
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
    usable = _mesh_usable(mesh, axis)
    if plan == "mesh" and not usable:
        raise ValueError(f"plan='mesh' requires a mesh with a non-trivial {axis!r} axis; got mesh={mesh!r}")
    use_mesh = usable and plan in ("auto", "mesh")
    return Plan(backend=backend, device=str(dev), mesh=mesh if use_mesh else None, axis=axis, **sizes)
