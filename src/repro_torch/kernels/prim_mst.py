"""Prim's MST over the implicit complete mrd graph for one mpts: the unit of
work of the paper's re-run baseline, the port of the device loop of
``repro/core/boruvka.py::prim_dense_mst``.

``prim_mst`` launches the hand-written CUDA kernel (``csrc/prim_mst.cu``:
one thread-block cluster runs all n-1 steps, each block holding its share
of the vertices in shared memory) for tensors on the card and takes the
plain version ``prim_mst_plain`` for tensors on the CPU; any other device
raises.  ``plan_for`` chooses the cluster size and what stays resident;
``set_plan`` forces a plan.  Both sum each d2 in the reference's order for
this program (``ops.sum_order(d, "prim")``), update with a strict ``<``
and break argmin ties by the lowest index, so ``src`` is equal and ``w2``
bit-equal to the reference's.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .ops import sum_order, sum_sq

# The plain version sums every d2 row up front while the (n, n) matrix
# stays within this many bytes, and one row a step above it.  The FMA
# orders are emulated with about 15 torch ops a column, so a row a step
# is the slow way: at n = 16000, d = 8 it took 28.6 s on an H100 against
# 3.7 s up front, and 15 calls at n = 4000 took 61.9 s against 16.0 s on
# that machine's host CPU (chip_smoke.py).
MATRIX_BYTES = 1 << 31


def _d2_matrix(xf: torch.Tensor, order: str):
    """Every row's d2 in ``order`` (row u, column v: the sum over x[v] - x[u]),
    or None when the (n, n) matrix would pass ``MATRIX_BYTES``."""
    n, d = xf.shape
    if n * n * 4 > MATRIX_BYTES:
        return None
    out = torch.empty((n, n), dtype=torch.float32, device=xf.device)
    rows = max(1, (1 << 22) // max(1, n * d))
    for r0 in range(0, n, rows):
        out[r0 : r0 + rows] = sum_sq(xf[None, :, :] - xf[r0 : r0 + rows, None, :], order)
    return out


def prim_mst_plain(x: torch.Tensor, cd2_col: torch.Tensor):
    """The reference's loop in torch ops, one Python step per vertex:
    (src (n,) int32, w2 (n,) float32), w2[0] = 0.  The d2 rows are summed
    up front, in the same order, while the (n, n) matrix stays within
    ``MATRIX_BYTES``, and one row per step above that."""
    n, d = x.shape
    dev = x.device
    xf, cd = x.float(), cd2_col.float()
    order = sum_order(int(d), "prim")
    d2 = _d2_matrix(xf, order)
    inf = torch.tensor(float("inf"), device=dev)
    in_tree = torch.zeros((n,), dtype=torch.bool, device=dev)
    in_tree[0] = True
    best_w2 = torch.full((n,), float("inf"), device=dev)
    best_w2[0] = 0.0
    best_src = torch.zeros((n,), dtype=torch.int32, device=dev)
    last = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n - 1):
        d2_row = d2[last] if d2 is not None else sum_sq(xf - xf[last], order)
        row = torch.maximum(torch.maximum(cd[last], cd), d2_row)
        better = (row < best_w2) & ~in_tree
        best_w2 = torch.where(better, row, best_w2)
        best_src = torch.where(better, last.to(torch.int32), best_src)
        # torch.argmin returns the first of equal minima, as jax.lax.argmin
        last = torch.argmin(torch.where(in_tree, inf, best_w2))
        in_tree[last] = True
    return best_src, torch.where(torch.arange(n, device=dev) == 0, 0.0, best_w2)


# Mirrors of csrc/prim_mst.cu's constants (tests/test_torch_plans.py reads
# them back from the source; chip_smoke.py checks the budget against the
# built library's ``repro_prim_mst_smem_budget``).
SMEM_BUDGET = 227 * 1024 - 1024  # dynamic shared memory a block plans with
BAR_WORDS = 4                    # the two slot buffers' mbarriers
SLOT_HEAD = 4                    # words of a slot ahead of its coordinates
COORDS_MAX = 32                  # coordinates travel with the key up to this d
MAX_THREADS = 512                # a block; past a share of 512 a thread takes several vertices
CLUSTERS = (16, 8)               # the non-portable size where granted, else the portable one

_forced: dict = {}


@dataclass(frozen=True)
class PrimPlan:
    """One launch's shape: a cluster of ``cluster`` blocks of ``threads``
    threads, block r owning vertices [r share, (r + 1) share); ``points``
    and ``state`` (cd2, best_w2, src) each ``"shared"`` (resident in the
    block's shared memory) or ``"device"`` (read from device memory each
    step); ``smem`` bytes of dynamic shared memory a block."""

    cluster: int
    threads: int
    share: int
    points: str
    state: str
    smem: int


def plan_smem(n: int, d: int, cluster: int, points: str, state: str) -> int:
    """A block's dynamic shared memory under a plan: two mbarriers, the
    double-buffered slots (key, cd2 and, up to d = 32 with the points
    resident, the coordinates, for each block of the cluster), then the
    points and the state of its share."""
    share = -(-n // cluster)
    coords = points == "shared" and d <= COORDS_MAX
    words = SLOT_HEAD + (-(-d // 4) * 4 if coords else 0)
    nbytes = (BAR_WORDS + 2 * cluster * words) * 4
    if points == "shared":
        nbytes += share * d * 4
    if state == "shared":
        nbytes += 3 * share * 4
    return nbytes


def plan_for(n: int, d: int, cluster: int, *, points: str | None = None, state: str | None = None) -> PrimPlan:
    """The plan of one launch at (n, d) on a cluster of ``cluster`` blocks
    (16 where the card grants it, else 8): the state resident while a
    block's share of it fits ``SMEM_BUDGET``, and the points with it while
    both fit.  ``points`` and ``state`` force a residency; a forced plan
    that does not fit raises ``ValueError``."""
    if n < 1 or d < 1:
        raise ValueError(f"prim_mst needs n >= 1 and d >= 1; got n={n}, d={d}")
    if not 1 <= cluster <= max(CLUSTERS):
        raise ValueError(f"a cluster holds 1 to {max(CLUSTERS)} blocks; got {cluster}")
    for name, v in (("points", points), ("state", state)):
        if v not in (None, "shared", "device"):
            raise ValueError(f"{name} must be 'shared' or 'device'; got {v!r}")
    if state is None:
        fits = plan_smem(n, d, cluster, "device", "shared") <= SMEM_BUDGET
        state = "shared" if points == "shared" or fits else "device"
    if points is None:
        fits = plan_smem(n, d, cluster, "shared", state) <= SMEM_BUDGET
        points = "shared" if state == "shared" and fits else "device"
    if points == "shared" and state != "shared":
        raise ValueError("the points are resident only with the state")
    smem = plan_smem(n, d, cluster, points, state)
    if smem > SMEM_BUDGET:
        raise ValueError(f"prim_mst at n={n}, d={d} on a cluster of {cluster}: points {points}, state {state} "
                         f"take {smem} bytes of shared memory a block, above {SMEM_BUDGET}")
    share = -(-n // cluster)
    threads = min(MAX_THREADS, max(32, -(-share // 32) * 32))
    return PrimPlan(cluster, threads, share, points, state, smem)


def set_plan(**forced) -> dict:
    """Force the plan of later launches: ``cluster`` (blocks), ``points``
    and ``state`` (``"shared"`` or ``"device"``), each left to ``plan_for``
    where not given; no argument restores the chosen plans.  Returns the
    settings it replaces."""
    unknown = set(forced) - {"cluster", "points", "state"}
    if unknown:
        raise ValueError(f"set_plan takes cluster, points and state; got {sorted(unknown)}")
    global _forced
    before, _forced = _forced, {k: v for k, v in forced.items() if v is not None}
    return before


def _lib():
    lib = _build.load("prim_mst")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_prim_mst.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
    lib.repro_prim_mst.restype = i
    lib.repro_prim_mst_max_active_clusters.argtypes = [i, i, i, i, i, i]
    lib.repro_prim_mst_max_active_clusters.restype = i
    lib.repro_prim_mst_floor.argtypes = [i, i, i, p, p]
    lib.repro_prim_mst_floor.restype = i
    return lib


def max_active_clusters(plan: PrimPlan, d: int, device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel instance for
    ``plan`` at width ``d`` on ``device``: how many such clusters the card
    holds at once (0: it refuses the shape)."""
    with torch.cuda.device(device):
        got = _lib().repro_prim_mst_max_active_clusters(
            d, plan.cluster, plan.threads, plan.smem, plan.points == "shared", plan.state == "shared")
    if got < 0:
        _build.check(-got, "prim_mst occupancy query")
    return got


_CARD_CLUSTER: dict = {}


def card_cluster(device) -> int:
    """The largest cluster of ``CLUSTERS`` that ``device`` grants at the
    kernel's heaviest shape (512 threads, the whole shared-memory budget)."""
    dev = torch.device(device)
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _CARD_CLUSTER:
        big, portable = CLUSTERS
        heavy = PrimPlan(big, MAX_THREADS, 1, "shared", "shared", SMEM_BUDGET)
        _CARD_CLUSTER[key] = big if max_active_clusters(heavy, 8, dev) >= 1 else portable
    return _CARD_CLUSTER[key]


def launch_plan(n: int, d: int, device) -> PrimPlan:
    """The plan ``prim_mst`` launches at (n, d) on ``device``: ``plan_for``
    on the card's cluster size, under whatever ``set_plan`` forced."""
    forced = dict(_forced)
    cluster = forced.pop("cluster", None) or card_cluster(device)
    return plan_for(n, d, cluster, **forced)


def _launch(x: torch.Tensor, cd2_col: torch.Tensor):
    n, d = x.shape
    dev = x.device
    if cd2_col.device != dev:
        raise ValueError(f"every operand must lie on {dev}; cd2_col is on {cd2_col.device}")
    xf = x.float().contiguous()
    if xf.data_ptr() % 16:  # the kernel reads point rows as float4
        xf = xf.clone()
    cd = cd2_col.float().contiguous()
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    w2 = torch.empty((n,), dtype=torch.float32, device=dev)
    plan = launch_plan(n, d, dev)
    fn = _lib().repro_prim_mst
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(xf.data_ptr(), cd.data_ptr(), n, d, plan.cluster, plan.threads, plan.points == "shared",
                    plan.state == "shared", src.data_ptr(), w2.data_ptr(), stream)
    _build.check(status, "prim_mst")
    prim_mst.launches += 1
    return src, w2


def step_floor(steps: int, plan: PrimPlan, device) -> None:
    """Launch the step-floor kernel: ``steps`` steps of ``prim_mst``'s key
    exchange alone (8-byte pushes, the wait, the C-way reduction) at
    ``plan``'s cluster shape (no update, no block reduction), on
    ``device``'s current stream: what a step cannot go below.  Not counted
    as a launch."""
    out = torch.empty((plan.cluster,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _lib().repro_prim_mst_floor(steps, plan.cluster, plan.threads, out.data_ptr(), stream)
    _build.check(status, "prim_mst step floor")


def prim_mst(x: torch.Tensor, cd2_col: torch.Tensor):
    """Prim's MST of the complete mrd graph of ``x`` (n, d) under one mpts,
    ``cd2_col`` (n,) its squared core distances: (src (n,) int32,
    w2 (n,) float32).  For each vertex v != 0 the MST edge is
    (src[v], v) with squared mrd weight w2[v]; w2[0] = 0.

    CUDA tensors run the kernel under ``launch_plan`` (one cluster; the
    points and state resident in shared memory where ``plan_for`` finds
    room); CPU tensors run the plain version.
    """
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be (n, d) with n >= 1; got {tuple(x.shape)}")
    if cd2_col.shape != (x.shape[0],):
        raise ValueError(f"cd2_col must be ({x.shape[0]},); got {tuple(cd2_col.shape)}")
    if not (x.is_floating_point() and cd2_col.is_floating_point()):
        raise ValueError(f"x and cd2_col must be floating point; got {x.dtype}, {cd2_col.dtype}")
    if x.device.type == "cpu":
        return prim_mst_plain(x, cd2_col)
    if x.device.type != "cuda":
        raise ValueError(f"prim_mst runs on CUDA or CPU tensors; got {x.device}")
    return _launch(x, cd2_col)


prim_mst.launches = 0
