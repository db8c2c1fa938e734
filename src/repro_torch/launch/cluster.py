"""Clustering engine launcher, the port of ``repro/launch/cluster.py``: the
production-mesh dry run of the engine's three device data planes.

  ring_knn          -- the kmax-NN pass (paper Alg. 1 lines 1-3)
  ring_lune_count   -- the exact-RNG filter (lines 22-26)
  sharded_mst_range -- the batched per-mpts MSTs (lines 31-32)

Each runs as ``dist.cluster_parallel`` runs it on a mesh of cards, in ONE
process as rank 0 of a ``"fake"`` process group of 256 or 512 ranks
(``launch.dryrun.start_fake_world``) on
``make_production_mesh(device="cpu")``, on meta tensors: nothing is
allocated, no kernel is built or launched (``ring_lune_count`` takes
its verdicts' shape on meta tensors).  The points shard over every mesh
dimension, as the reference's ``P(("pod", "data", "model"), None)``
(one flattened ``points`` dimension of 256 or 512 ranks); the Borůvka rows
over ``data``, R padded to its size.  Defaults are the reference's:
n = 4194304 points of d = 64, kmax = 64, m = 8 n edges.

Each plane's record keeps the reference's keys: ``temp_bytes_per_device``
(the peak of the storages the plane allocates and holds at once),
``flops_per_device``, ``hbm_bytes_per_device``,
``collective_bytes_per_device`` and the ``roofline`` against the H100's
datasheet peaks (``launch.dryrun``), plus ``argument_bytes_per_device``
and the collectives by type.  The kNN and lune planes' operations and
bytes are the kernels' own counts (``kernels.pairwise_topk.work``,
``kernels.lune_filter.work``; the lune scan at its most, every edge
against every point, since a dry run has no data), the total split evenly
over the ranks; their collectives and memory are traced.  Borůvka's
rounds end on a data-dependent test the trace cannot take, so 1 and 2
rounds are traced with no test and extended to ``ceil(log2 n) + 1``
rounds, its bound (``rounds_bound``; the reference records such loops as
``unknown_trip_counts``).

  PYTHONPATH=src python -m repro_torch.launch.cluster --dryrun \\
      --n 4194304 --dim 64 --kmax 64 [--multi-pod] [--bf16-tiles]

Local mode (a fit on one device or a host mesh) is
``examples/quickstart_torch.py``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import time

import torch

from repro_torch.dist import cluster_parallel as cp
from repro_torch.launch.dryrun import Tally, roofline, start_fake_world
from repro_torch.launch.mesh import make_production_mesh


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _traced(fn, mesh) -> tuple[dict, float]:
    """Run ``fn()`` under a ``Tally``: (its counts, seconds)."""
    groups = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    tally = Tally(groups)
    t0 = time.monotonic()
    with tally:
        fn()
    counts = {"flops": tally.flops, "hbm_bytes": tally.hbm_bytes, "temp_bytes": tally.peak,
              **{f"coll/{k}": v for k, v in tally.coll_bytes.items()},
              **{f"axis/{k}": v for k, v in tally.coll_axis.items()}}
    return counts, time.monotonic() - t0


def _report(name: str, counts: dict, arg_bytes: int, mesh, t_trace: float, **extra) -> dict:
    coll = {k[5:]: v for k, v in counts.items() if k.startswith("coll/")}
    by_axis = {k[5:]: v for k, v in counts.items() if k.startswith("axis/")}
    terms = roofline(counts["flops"], counts["hbm_bytes"], by_axis, mesh, peak="float32_flops")
    rec = {
        "kernel": name,
        "argument_bytes_per_device": arg_bytes,
        "temp_bytes_per_device": int(counts["temp_bytes"]),
        "flops_per_device": counts["flops"],
        "hbm_bytes_per_device": counts["hbm_bytes"],
        "collective_bytes_per_device": float(sum(coll.values())),
        "collectives": coll,
        "collective_bytes_by_axis": by_axis,
        "roofline": terms,
        "t_trace_s": round(t_trace, 2),
        **extra,
    }
    print(f"[{name}] args {arg_bytes / 2**30:.2f} GiB/dev  temp {rec['temp_bytes_per_device'] / 2**30:.2f} GiB/dev  "
          f"t_comp {terms['t_compute_s'] * 1e3:.1f}ms  t_mem {terms['t_memory_s'] * 1e3:.1f}ms  "
          f"t_coll {terms['t_collective_s'] * 1e3:.1f}ms -> {terms['dominant']}", flush=True)
    return rec


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def dryrun(n: int, dim: int, kmax: int, multi_pod: bool, out: str | None, bf16_tiles: bool = False,
           tag: str = "") -> dict:
    """The three planes' records at n points of ``dim`` on the production mesh."""
    n_chips = 512 if multi_pod else 256
    start_fake_world(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    points = mesh._flatten("points")  # every rank, in mesh order: the reference's P(axes)
    if n % n_chips:
        raise ValueError(f"n={n} does not split over {n_chips} ranks")
    nl = n // n_chips
    m_edges = 8 * n  # RNG edge budget: ~8n edges (paper Fig 6 scale)
    dtype = torch.bfloat16 if bf16_tiles else torch.float32
    results = {}

    # 1) ring kNN over the sharded points
    x_loc = _meta((nl, dim), dtype)
    counts, t = _traced(lambda: cp.ring_knn(x_loc, kmax, points, axis="points", n_valid=n), mesh)
    flops, nbytes = importlib.import_module("repro_torch.kernels.pairwise_topk").work(n, dim, kmax)
    counts.update(flops=flops / n_chips, hbm_bytes=nbytes / n_chips)
    results["ring_knn"] = _report("ring_knn", counts, _nbytes(x_loc), mesh, t)

    # 2) the exact lune scan: the edges on every rank, the points sharded
    cd2_loc = _meta((nl,), torch.float32)
    ea, eb = _meta((m_edges,), torch.int32), _meta((m_edges,), torch.int32)
    w2 = _meta((m_edges,), torch.float32)
    counts, t = _traced(lambda: cp.ring_lune_count(x_loc, cd2_loc, ea, eb, w2, points, axis="points", n_valid=n),
                        mesh)
    flops, nbytes = importlib.import_module("repro_torch.kernels.lune_filter").work(n, dim, m_edges, 0)
    counts.update(flops=flops / n_chips, hbm_bytes=nbytes / n_chips)
    results["ring_lune_count"] = _report("ring_lune_count", counts, _nbytes(x_loc, cd2_loc, ea, eb, w2), mesh, t)

    # 3) batched Borůvka over the mpts range: the R rows over ``data``
    # (R padded to its size, Plan.mst_range's rule), the edge list on every rank
    data = mesh["data"].size()
    r_pad = -(-kmax // data) * data
    w_range = _meta((r_pad, m_edges), torch.float32)
    bound = math.ceil(math.log2(n)) + 1
    traced = [_traced(lambda r=r: cp.sharded_mst_range(ea, eb, w_range, n=n, mesh=mesh, rounds=r), mesh)
              for r in (1, 2)]
    (c1, t1), (c2, t2) = traced
    counts = {k: c1.get(k, 0.0) + (bound - 1) * (c2.get(k, 0.0) - c1.get(k, 0.0)) for k in c1.keys() | c2.keys()}
    counts["temp_bytes"] = max(c1["temp_bytes"], c2["temp_bytes"])  # a round frees what the last one held
    results["sharded_mst_range"] = _report("sharded_mst_range", counts, _nbytes(ea, eb, w_range), mesh, t1 + t2,
                                           rounds_bound=bound, traced_rounds=[1, 2], unknown_trip_counts=1)

    if out:
        os.makedirs(out, exist_ok=True)
        name = f"cluster__n{n}__d{dim}__k{kmax}__{'multi' if multi_pod else 'single'}{tag}"
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--kmax", type=int, default=64)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--bf16-tiles", action="store_true", help="hold the points in bfloat16")
    ap.add_argument("--out", default="artifacts/dryrun_cluster_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not args.dryrun:
        raise SystemExit("local mode: use examples/quickstart_torch.py")
    import torch.distributed as dist

    try:
        dryrun(args.n, args.dim, args.kmax, args.multi_pod, args.out, bf16_tiles=args.bf16_tiles, tag=args.tag)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
