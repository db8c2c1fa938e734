"""End-to-end pipeline: every hierarchy of an mpts range from one graph, the
port of ``repro/core/multi.py``.

Staged pipeline, as in the reference:

  ``fit_msts``          — one (kmax-1)-NN pass, one RNG^kmax, reweight for the
                          whole mpts range, batched Borůvka: all R MSTs as
                          (R, n-1) edge arrays.  Device work, done once.
  ``linkage_range``     — stage 1 of extraction: all R single-linkage
                          dendrograms at once (``core.linkage``).
  ``extract_hierarchies`` / ``extract_one_from_linkage``
                        — stage 2: vectorized condense/stability/labels
                          (``core.hierarchy``) per requested mpts.

``multi_hdbscan`` runs the whole method with eager extraction;
``hdbscan_baseline`` is the paper's re-run baseline (one shared kNN, then
one dense Prim MST and one extraction per mpts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from .. import engine
from . import boruvka, hierarchy, linkage
from . import mrd as mrd_mod
from .rng import RngGraph, build_rng_graph


@dataclasses.dataclass
class HierarchyResult:
    mpts: int
    labels: np.ndarray
    n_clusters: int
    condensed: hierarchy.CondensedTree
    stability: dict[int, float]  # every condensed cluster, selected or not
    mst_ea: np.ndarray
    mst_eb: np.ndarray
    mst_w: np.ndarray  # real (non-squared) mrd weights
    selected: list[int] = dataclasses.field(default_factory=list)  # chosen cluster ids
    point_lambda: np.ndarray | None = None  # (n,) departure lambda (0 for noise)


def _validate_min_cluster_size(min_cluster_size: int | None) -> None:
    if min_cluster_size is not None and min_cluster_size < 2:
        raise ValueError(
            f"min_cluster_size must be >= 2 (or None for the per-mpts "
            f"default max(2, mpts)); got {min_cluster_size}"
        )


@dataclasses.dataclass
class MultiMSTResult:
    """Everything shared across the mpts range, before any extraction."""

    n: int
    kmax: int
    mpts_values: list[int]
    graph: RngGraph | None
    knn_d2: np.ndarray
    knn_idx: np.ndarray
    cd2: np.ndarray
    mst_ea: np.ndarray  # (R, n-1) int32: MST edges per mpts row
    mst_eb: np.ndarray  # (R, n-1) int32
    mst_w: np.ndarray   # (R, n-1) float32, real (non-squared) mrd weights
    timings: dict[str, float]

    def row_of(self, mpts: int) -> int:
        try:
            return self.mpts_values.index(mpts)
        except ValueError:
            raise KeyError(
                f"mpts={mpts} not in computed range {self.mpts_values}"
            ) from None


@dataclasses.dataclass
class LinkageRange:
    """Stage-1 extraction output: all R dendrograms, scipy convention."""

    left: np.ndarray    # (R, n-1) int32
    right: np.ndarray   # (R, n-1) int32
    height: np.ndarray  # (R, n-1) float32, ascending per row
    size: np.ndarray    # (R, n-1) int32


@dataclasses.dataclass
class MultiDensityResult:
    n: int
    kmax: int
    mpts_values: list[int]
    graph: RngGraph
    knn_d2: np.ndarray
    knn_idx: np.ndarray
    cd2: np.ndarray
    hierarchies: list[HierarchyResult]
    timings: dict[str, float]


# The MST stage's rows at a time: as many as keep (rows x edges) at most
# this.  Borůvka holds about seven int64 (rows, edges) arrays at once (the
# sort keys, their order and ranks, a round's component ids and candidates),
# so a chunk takes some 7.5 GB at most; the rows' MSTs do not depend on
# each other, so the chunks' outputs are the whole stage's, bit for bit.
MST_CHUNK_ELEMS = 1 << 27


def _mst_stage_local(d2_e, cd2_dev, ea, eb, row_idx, *, n: int, plan):
    """Reweight + batched Borůvka + row compaction for the selected rows,
    ``MST_CHUNK_ELEMS // m`` rows at a time (no sync between chunks)."""
    step = max(1, MST_CHUNK_ELEMS // max(1, int(ea.shape[0])))
    parts = []
    for r0 in range(0, int(row_idx.shape[0]), step):
        # rows j - 1 of the reweighting are mpts = j: the chunk's columns of
        # the core distances give its rows alone (row-major, as Borůvka's
        # sorts and gathers want them: a transposed layout costs them copies)
        w_sel = mrd_mod.reweight_all_mpts(d2_e, cd2_dev[:, row_idx[r0 : r0 + step]], ea, eb).contiguous()
        in_mst = plan.mst_range(ea, eb, w_sel, n=n)
        parts.append(_compact_mst_rows(in_mst, ea, eb, w_sel, n=n))
    return parts[0] if len(parts) == 1 else tuple(torch.cat(p) for p in zip(*parts))


def _compact_mst_rows(in_mst, ea, eb, w_sel, *, n: int):
    """(R, m) MST mask -> (R, n-1) ascending edge-id compaction + counts.

    Slot s of a row holds the edge id where the row's int32 running count
    of MST edges first reaches s + 1 (a binary search, no sync); rows with
    fewer than n-1 edges keep edge id 0 in their unfilled slots, and
    ``counts`` says so.  No int64 (R, m) array: the running counts are
    int32, the searches (R, n-1).
    """
    R, _ = in_mst.shape
    dev = in_mst.device
    pos = torch.cumsum(in_mst, dim=1, dtype=torch.int32)
    slots = torch.arange(1, n, dtype=torch.int32, device=dev).expand(R, n - 1).contiguous()
    sel = torch.searchsorted(pos, slots)
    counts = in_mst.sum(dim=1, dtype=torch.int32)
    sel = torch.where(slots <= counts[:, None], sel, 0)
    # float32 sqrt through float64: correctly rounded on every device, as
    # the reference's XLA sqrt is (torch's vectorised CPU float32 sqrt is not)
    mst_w = torch.sqrt(w_sel.gather(1, sel).double()).float()
    ea, eb = ea.long(), eb.long()
    return ea[sel].to(torch.int32), eb[sel].to(torch.int32), mst_w, counts


def fit_msts(
    x,
    kmax: int,
    *,
    kmin: int = 2,
    variant: str = "rng_star",
    mpts_values: Sequence[int] | None = None,
    plan: "engine.Plan | str | None" = None,
    device=None,
) -> MultiMSTResult:
    """kNN -> RNG^kmax -> reweight-all-mpts -> batched Borůvka, no extraction.

    Every stage runs on the plan's device and ends at one named
    ``engine.to_host`` materialization: ``knn``, then ``candidate_count``,
    ``stage1_count`` and ``graph`` inside ``build_rng_graph`` (``graph``
    alone on the dual-tree tier), then ``mst``.
    ``device`` (default ``"cuda"``) is read only when ``plan`` is not
    already a resolved ``Plan``.
    """
    plan = plan if isinstance(plan, engine.Plan) else engine.resolve_plan(plan, device=device)
    x_host = engine.io.ensure_host(x)
    n = int(x_host.shape[0])
    if kmax < 2 or kmax > n:
        raise ValueError(f"kmax must be in [2, n]; got {kmax} (n={n})")
    mpts_list = list(mpts_values) if mpts_values is not None else list(range(kmin, kmax + 1))
    if any(m < 1 or m > kmax for m in mpts_list):
        raise ValueError(f"mpts values must lie in [1, kmax]; got {mpts_list}")
    dev = torch.device(plan.device)
    # every kernel computes in float32, as the reference does on its device
    x = torch.as_tensor(np.ascontiguousarray(x_host, dtype=np.float32)).to(dev)
    timings: dict[str, float] = {}

    t0 = time.monotonic()
    knn_d2, knn_idx = plan.knn(x, kmax - 1, x_host=x_host)
    cd2_dev = mrd_mod.core_distances2(knn_d2)
    knn_host, knn_idx_host, cd2 = engine.to_host((knn_d2, knn_idx, cd2_dev), "knn")
    timings["knn"] = time.monotonic() - t0

    t0 = time.monotonic()
    graph = build_rng_graph(
        x, knn_d2, knn_idx,
        variant=variant,
        plan=plan,
        x_host=x_host,
        cd_kmax_host=np.sqrt(cd2[:, -1].astype(np.float64)),
        knn_d2_host=knn_host,
        knn_idx_host=knn_idx_host,
    )
    timings["rng_build"] = time.monotonic() - t0

    t0 = time.monotonic()
    m_real = len(graph.edges)
    ea = torch.as_tensor(graph.edges[:, 0].astype(np.int32)).to(dev)
    eb = torch.as_tensor(graph.edges[:, 1].astype(np.int32)).to(dev)
    d2_e = torch.as_tensor(np.ascontiguousarray(graph.d2)).to(dev)
    row_idx = torch.as_tensor([m - 1 for m in mpts_list], device=dev)
    mst_dev = _mst_stage_local(d2_e, cd2_dev, ea, eb, row_idx, n=n, plan=plan)
    mst_ea, mst_eb, mst_w, counts = engine.to_host(mst_dev, "mst")
    if not np.all(counts == n - 1):
        # the RNG^kmax contains every per-mpts MST (paper Cor. 1), so a
        # disconnected row means an upstream candidate or filter bug
        bad = {mpts_list[i]: int(counts[i]) for i in np.flatnonzero(counts != n - 1)}
        raise RuntimeError(
            f"MST incomplete: graph variant {variant!r} with "
            f"{m_real} edges is disconnected — got "
            f"{{mpts: n_tree_edges}} = {bad}, need {n - 1} edges per mpts. "
            f"The RNG^kmax must contain every MST, so this indicates an "
            f"upstream candidate-generation or filter bug."
        )
    timings["mst_range"] = time.monotonic() - t0

    return MultiMSTResult(
        n=n,
        kmax=kmax,
        mpts_values=mpts_list,
        graph=graph,
        knn_d2=knn_host,
        knn_idx=knn_idx_host,
        cd2=cd2,
        mst_ea=mst_ea,
        mst_eb=mst_eb,
        mst_w=mst_w,
        timings=timings,
    )


def linkage_range(msts: MultiMSTResult, *, device=None) -> LinkageRange:
    """All of the range's dendrograms; row i is ``msts.mpts_values[i]``.

    The MST arrays are host numpy, so the caller names the device the
    union-find runs on: ``"cuda"`` by default (the ``single_linkage``
    kernel), which raises without a card unless ``device="cpu"``.
    """
    dev = engine.plan.resolve_device(device)
    ea, eb, w = (
        torch.from_numpy(np.array(a, order="C")).to(dev)
        for a in (msts.mst_ea, msts.mst_eb, msts.mst_w)
    )
    left, right, height, size = engine.to_host(
        linkage.single_linkage_batch(ea, eb, w, n=msts.n), "linkage"
    )
    return LinkageRange(left=left, right=right, height=height, size=size)


# -- artifact pack/unpack ----------------------------------------------------
#
# The artifact format is the reference's (``repro.core.multi.pack_msts``),
# so a fitted state moves between the two packages in both directions.


def pack_msts(msts: MultiMSTResult) -> tuple[dict[str, np.ndarray], dict]:
    """Split a MultiMSTResult into (arrays, meta) for serialization."""
    arrays = {
        "knn_d2": msts.knn_d2,
        "knn_idx": msts.knn_idx,
        "cd2": msts.cd2,
        "mst_ea": msts.mst_ea,
        "mst_eb": msts.mst_eb,
        "mst_w": msts.mst_w,
        "mpts_values": np.asarray(msts.mpts_values, np.int64),
    }
    meta: dict = {
        "n": int(msts.n),
        "kmax": int(msts.kmax),
        "timings": {k: float(v) for k, v in msts.timings.items()},
        "graph": None,
    }
    if msts.graph is not None:
        arrays["graph_edges"] = msts.graph.edges
        arrays["graph_d2"] = msts.graph.d2
        arrays["graph_w2_kmax"] = msts.graph.w2_kmax
        meta["graph"] = {
            "variant": msts.graph.variant,
            "n_points": int(msts.graph.n_points),
            "stats": {
                k: (int(v) if isinstance(v, (int, np.integer)) else v)
                for k, v in msts.graph.stats.items()
            },
        }
    return {k: engine.io.ensure_host(v) for k, v in arrays.items()}, meta


def unpack_msts(arrays: dict[str, np.ndarray], meta: dict) -> MultiMSTResult:
    """Inverse of ``pack_msts`` (either package's); raises KeyError on a
    missing array field."""
    graph = None
    if meta.get("graph") is not None:
        g = meta["graph"]
        graph = RngGraph(
            edges=arrays["graph_edges"],
            d2=arrays["graph_d2"],
            w2_kmax=arrays["graph_w2_kmax"],
            variant=g["variant"],
            n_points=int(g["n_points"]),
            stats=dict(g["stats"]),
        )
    return MultiMSTResult(
        n=int(meta["n"]),
        kmax=int(meta["kmax"]),
        mpts_values=[int(m) for m in arrays["mpts_values"]],
        graph=graph,
        knn_d2=arrays["knn_d2"],
        knn_idx=arrays["knn_idx"],
        cd2=arrays["cd2"],
        mst_ea=arrays["mst_ea"],
        mst_eb=arrays["mst_eb"],
        mst_w=arrays["mst_w"],
        timings={k: float(v) for k, v in meta.get("timings", {}).items()},
    )


def extract_one_from_linkage(
    msts: MultiMSTResult,
    lk: LinkageRange,
    row: int,
    *,
    min_cluster_size: int | None = None,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
    cluster_selection_epsilon: float = 0.0,
    policy=None,
) -> HierarchyResult:
    """Vectorized condense/select/label for one mpts row of a LinkageRange.

    ``policy`` (an ``api.selection.SelectionPolicy``, duck-typed so core
    never imports the api layer) overrides the individual keyword
    arguments when given (its ``min_cluster_size=None`` falls through to
    the per-mpts default).
    """
    if policy is not None:
        cluster_selection_method = policy.method
        cluster_selection_epsilon = policy.epsilon
        allow_single_cluster = policy.allow_single_cluster
        if policy.min_cluster_size is not None:
            min_cluster_size = policy.min_cluster_size
    mpts = msts.mpts_values[row]
    mcs = min_cluster_size if min_cluster_size is not None else max(2, mpts)
    Z = linkage.linkage_to_Z(lk.left[row], lk.right[row], lk.height[row], lk.size[row])
    tree = hierarchy.condense_tree_fast(Z, msts.n, mcs)
    stab = hierarchy.compute_stability_fast(tree)
    selected = hierarchy.extract_clusters(
        tree,
        stab,
        allow_single_cluster=allow_single_cluster,
        cluster_selection_method=cluster_selection_method,
        cluster_selection_epsilon=cluster_selection_epsilon,
    )
    labels, lam_pt = hierarchy.labels_for_fast(tree, selected)
    return HierarchyResult(
        mpts=mpts,
        labels=labels,
        n_clusters=int(labels.max()) + 1,
        condensed=tree,
        stability=stab,
        mst_ea=msts.mst_ea[row].astype(np.int64),
        mst_eb=msts.mst_eb[row].astype(np.int64),
        mst_w=msts.mst_w[row],
        selected=selected,
        point_lambda=lam_pt,
    )


def extract_hierarchies(
    msts: MultiMSTResult,
    *,
    lk: LinkageRange | None = None,
    min_cluster_size: int | None = None,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
    cluster_selection_epsilon: float = 0.0,
    policy=None,
    device=None,
) -> tuple[list[HierarchyResult], dict[str, float]]:
    """Batched extraction of the whole range; returns (hierarchies, timings).

    ``device`` is where the linkage runs when ``lk`` is not given (see
    ``linkage_range``)."""
    timings: dict[str, float] = {}
    t0 = time.monotonic()
    if lk is None:
        lk = linkage_range(msts, device=device)
    timings["hierarchy_linkage"] = time.monotonic() - t0

    t0 = time.monotonic()
    out = [
        extract_one_from_linkage(
            msts,
            lk,
            row,
            min_cluster_size=min_cluster_size,
            allow_single_cluster=allow_single_cluster,
            cluster_selection_method=cluster_selection_method,
            cluster_selection_epsilon=cluster_selection_epsilon,
            policy=policy,
        )
        for row in range(len(msts.mpts_values))
    ]
    timings["hierarchy_condense"] = time.monotonic() - t0
    timings["hierarchy"] = timings["hierarchy_linkage"] + timings["hierarchy_condense"]
    return out, timings


def multi_hdbscan(
    x,
    kmax: int,
    *,
    kmin: int = 2,
    variant: str = "rng_star",
    min_cluster_size: int | None = None,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
    cluster_selection_epsilon: float = 0.0,
    compute_hierarchies: bool = True,
    mpts_values: Sequence[int] | None = None,
    plan: "engine.Plan | str | None" = None,
    device=None,
) -> MultiDensityResult:
    """All HDBSCAN* hierarchies for mpts in [kmin, kmax] via one RNG^kmax."""
    _validate_min_cluster_size(min_cluster_size)
    plan = plan if isinstance(plan, engine.Plan) else engine.resolve_plan(plan, device=device)
    msts = fit_msts(
        x, kmax, kmin=kmin, variant=variant,
        mpts_values=mpts_values, plan=plan,
    )
    timings = dict(msts.timings)
    hierarchies: list[HierarchyResult] = []
    if compute_hierarchies:
        hierarchies, t_extract = extract_hierarchies(
            msts,
            min_cluster_size=min_cluster_size,
            allow_single_cluster=allow_single_cluster,
            cluster_selection_method=cluster_selection_method,
            cluster_selection_epsilon=cluster_selection_epsilon,
            device=plan.device,
        )
        timings.update(t_extract)
    else:
        timings["hierarchy"] = 0.0
    timings["total"] = (
        timings["knn"] + timings["rng_build"] + timings["mst_range"] + timings["hierarchy"]
    )
    return MultiDensityResult(
        n=msts.n,
        kmax=kmax,
        mpts_values=msts.mpts_values,
        graph=msts.graph,
        knn_d2=msts.knn_d2,
        knn_idx=msts.knn_idx,
        cd2=msts.cd2,
        hierarchies=hierarchies,
        timings=timings,
    )


def hdbscan_baseline(
    x,
    mpts_values: Sequence[int],
    *,
    kmax: int | None = None,
    min_cluster_size: int | None = None,
    allow_single_cluster: bool = False,
    cluster_selection_method: str = "eom",
    cluster_selection_epsilon: float = 0.0,
    backend: str | None = None,
    compute_hierarchies: bool = True,
    plan: "engine.Plan | str | None" = None,
    device=None,
) -> tuple[list[HierarchyResult], dict[str, float]]:
    """Paper's baseline: shared kNN pass + dense complete-graph MST per mpts.

    One ``prim_dense_mst`` call (one ``prim_mst`` launch on the card) per
    mpts, each synced to the host under the ``mst`` tag, as the reference
    runs one program per mpts: the baseline is one independent run per
    density level.  ``device`` (default ``"cuda"``) and ``backend`` are
    read only when ``plan`` is not already a resolved ``Plan``.
    """
    _validate_min_cluster_size(min_cluster_size)
    if not isinstance(plan, engine.Plan):
        plan = engine.resolve_plan(plan, backend=backend, device=device)
    x_host = engine.io.ensure_host(x)
    dev = torch.device(plan.device)
    x = torch.as_tensor(np.ascontiguousarray(x_host, dtype=np.float32)).to(dev)
    n = int(x.shape[0])
    mpts_list = list(mpts_values)
    kmax = kmax or max(mpts_list)
    timings: dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.monotonic()
    knn_d2, _ = plan.knn(x, kmax - 1, x_host=x_host)
    cd2 = mrd_mod.core_distances2(knn_d2)
    sync()
    timings["knn"] = time.monotonic() - t0

    t_mst = 0.0
    eb = np.arange(1, n, dtype=np.int32)
    mst_ea = np.zeros((len(mpts_list), n - 1), np.int32)
    mst_w = np.zeros((len(mpts_list), n - 1), np.float32)
    for row, mpts in enumerate(mpts_list):
        t0 = time.monotonic()
        src, w2 = boruvka.prim_dense_mst(x, cd2[:, mpts - 1])
        sync()
        t_mst += time.monotonic() - t0
        src_h, w2_h = engine.to_host((src, w2), "mst")
        mst_ea[row] = src_h[1:]
        # float32 sqrt on the host, as the reference takes it
        mst_w[row] = np.sqrt(w2_h[1:])
    timings["mst"] = t_mst

    results: list[HierarchyResult] = []
    t0 = time.monotonic()
    if compute_hierarchies:
        knn_d2_h, cd2_h = engine.to_host((knn_d2, cd2), "knn")
        msts = MultiMSTResult(
            n=n,
            kmax=kmax,
            mpts_values=mpts_list,
            graph=None,
            knn_d2=knn_d2_h,
            knn_idx=np.zeros((n, 0), np.int32),
            cd2=cd2_h,
            mst_ea=mst_ea,
            mst_eb=np.broadcast_to(eb, mst_ea.shape),
            mst_w=mst_w,
            timings={},
        )
        results, _ = extract_hierarchies(
            msts,
            min_cluster_size=min_cluster_size,
            allow_single_cluster=allow_single_cluster,
            cluster_selection_method=cluster_selection_method,
            cluster_selection_epsilon=cluster_selection_epsilon,
            device=plan.device,
        )
    timings["hierarchy"] = time.monotonic() - t0
    timings["total"] = timings["knn"] + t_mst + timings["hierarchy"]
    return results, timings
