"""Multi-GPU fit on the PyTorch port: one point set fitted on a mesh of
several GPUs, one process a GPU, each rank's fit held to a single-device
fit.

  PYTHONPATH=src python examples/mesh_fit_torch.py --ranks 4                    # four cards, NCCL
  PYTHONPATH=src python examples/mesh_fit_torch.py --ranks 3 --device cpu --n 1500  # gloo on the CPU

The SPMD pattern of ``repro_torch.dist.cluster_parallel``: each rank starts
the process group itself (a ``file://`` store in a temporary directory,
rank r of N), builds ``launch.mesh.make_host_mesh`` and calls the same
``MultiHDBSCAN(kmax, variant=..., plan="mesh", mesh=mesh).fit(X)`` on the
same X; the kNN runs as a ring over the ranks, the exact lune scan over
each rank's rows of the points and the R MSTs split by rows.  Every rank
also fits X on its own device without the mesh.  For RNG* and the exact
variant the script checks that each rank's mesh fit (kNN, graph edges,
MST ids, ``mst_w``, labels) equals that single-device fit bit for bit and
that all ranks agree, and prints each stage's seconds beside the
single-device fit's and, on the card, the launches of the hand-written
kernels in the mesh fit.  The summary goes to ``--out`` as JSON.
"""

import argparse
import datetime
import hashlib
import importlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np

VARIANTS = ("rng_star", "rng")
STAGES = ("knn", "rng_build", "mst_range")
KERNELS = {"pairwise_topk": "pairwise_topk", "edge_cascade": "fused_cascade", "lune_filter": "lune_filter",
           "single_linkage": "single_linkage"}


def make_points(n: int, d: int, seed: int) -> np.ndarray:
    """16 Gaussian clusters in [-10, 10]^d plus 5% uniform noise, float32
    (``chip_smoke.py``'s points)."""
    rng = np.random.default_rng(seed)
    n_noise = n // 20
    centers = rng.uniform(-10.0, 10.0, size=(16, d))
    members = centers[rng.integers(0, 16, n - n_noise)] + rng.normal(0.0, 0.6, size=(n - n_noise, d))
    noise = rng.uniform(-12.0, 12.0, size=(n_noise, d))
    x = np.concatenate([members, noise])
    return x[rng.permutation(n)].astype(np.float32)


def _outputs(est) -> dict:
    m = est.model_.msts
    return {"knn_idx": m.knn_idx, "knn_d2": m.knn_d2, "edges": est.graph_.edges, "mst_ea": m.mst_ea,
            "mst_eb": m.mst_eb, "mst_w": m.mst_w, "labels": np.stack([v.labels for v in est.select_all()])}


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(out):
        h.update(key.encode())
        h.update(np.ascontiguousarray(out[key]).tobytes())
    return h.hexdigest()


def rank_main(args) -> None:
    """One rank: the single-device fits, then the mesh fits."""
    import torch
    import torch.distributed as dist

    from repro_torch.api import MultiHDBSCAN
    from repro_torch.launch.mesh import make_host_mesh

    card = args.device == "cuda"
    if card:
        torch.cuda.set_device(args.rank)
    else:
        torch.set_num_threads(1)
    counters = {k: getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), k) for k, mod in KERNELS.items()}
    x = make_points(args.n, args.d, args.seed)
    sync = torch.cuda.synchronize if card else (lambda: None)
    single = {}
    for variant in VARIANTS:
        for _ in range(2 if card else 1):  # the first fit on a card warms its kernels
            est = MultiHDBSCAN(kmax=args.kmax, variant=variant, device=args.device).fit(x)
        single[variant] = est
    dist.init_process_group("nccl" if card else "gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.ranks, timeout=datetime.timedelta(seconds=args.timeout))
    result = {"rank": args.rank, "backend": dist.get_backend()}
    try:
        mesh = make_host_mesh(device=args.device)
        for variant in VARIANTS:
            opts = dict(kmax=args.kmax, variant=variant, device=args.device, plan="mesh", mesh=mesh)
            if card:  # the first mesh fit also sets up the communicators
                MultiHDBSCAN(**opts).fit(x)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.monotonic()
            est = MultiHDBSCAN(**opts).fit(x)
            est.select_all()
            sync()
            total = time.monotonic() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            result["plan"] = est.plan_.describe()
            got, want = _outputs(est), _outputs(single[variant])
            equal = {k: np.array_equal(np.ascontiguousarray(got[k]).view(np.uint8),
                                       np.ascontiguousarray(want[k]).view(np.uint8)) for k in got}
            result[variant] = {
                "equal": equal, "digest": _digest(got), "fit_and_select_all_s": total,
                "launches": launches,
                "stages_s": {k: est.timings_[k] for k in STAGES},
                "single_stages_s": {k: single[variant].timings_[k] for k in STAGES},
                "graph": est.graph_.stats,
            }
    finally:
        dist.destroy_process_group()
    Path(args.out_dir, f"rank{args.rank}.json").write_text(json.dumps(result))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"mesh_fit_torch: check failed: {msg}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; NCCL, one card a rank) or cpu (gloo)")
    ap.add_argument("--ranks", type=int, default=None, help="default: every card (cuda) or 3 (cpu)")
    ap.add_argument("--n", type=int, default=16000)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--kmax", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=int, default=600, help="seconds for the ranks and each collective")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "mesh_fit.json"))
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}

    import torch

    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        raise SystemExit("mesh_fit_torch: no CUDA device is available; pass --device cpu")
    args.ranks = args.ranks or (torch.cuda.device_count() if card else 3)
    check(args.ranks >= 2, f"a mesh needs 2 or more ranks; got {args.ranks}")
    if card:
        check(torch.cuda.device_count() >= args.ranks, f"{args.ranks} ranks need as many cards; "
              f"{torch.cuda.device_count()} here")
        from repro_torch.kernels import _build

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        print("\n".join(smi), flush=True)
        print(f"build: per source {_build.build_all()}", flush=True)  # once, before the ranks load it
    summary = {"device": args.device, "ranks": args.ranks, "n": args.n, "d": args.d, "kmax": args.kmax}
    if card:
        summary["cards"] = smi
    with tempfile.TemporaryDirectory() as tmp:
        common = [f"--{k}={v}" for k, v in (("device", args.device), ("ranks", args.ranks), ("n", args.n),
                                             ("d", args.d), ("kmax", args.kmax), ("seed", args.seed),
                                             ("timeout", args.timeout))]
        t0 = time.monotonic()
        procs = [subprocess.Popen([sys.executable, __file__, *common, f"--rank={r}", f"--store={tmp}/store",
                                   f"--out-dir={tmp}"]) for r in range(args.ranks)]
        try:
            for p in procs:
                p.wait(timeout=args.timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(all(p.returncode == 0 for p in procs), f"rank exit codes {[p.returncode for p in procs]}")
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(args.ranks)]
        summary["wall_s"] = time.monotonic() - t0
    summary["per_rank"] = ranks
    for variant in VARIANTS:
        rows = [r[variant] for r in ranks]
        for r, row in zip(ranks, rows):
            check(all(row["equal"].values()), f"rank {r['rank']}, {variant}: mesh fit != single-device fit "
                  f"{row['equal']}")
            check(r["plan"].endswith(f"placement=mesh[data={args.ranks}])"), f"rank {r['rank']}: {r['plan']}")
        check(len({row["digest"] for row in rows}) == 1, f"{variant}: the ranks' fits differ")
        if card:
            for row in rows:
                la = row["launches"]
                check(la["pairwise_topk"] == 0 and la["edge_cascade"] >= 2 and la["single_linkage"] == 1
                      and (la["lune_filter"] >= 1) == (variant == "rng"), f"{variant}: launches {la}")
        r0 = rows[0]
        print(f"{variant}: {args.ranks} ranks ({ranks[0]['backend']}), every rank's mesh fit == its single-device "
              f"fit and all ranks equal; rank 0: fit + select_all {r0['fit_and_select_all_s']:.2f} s, launches "
              f"{r0['launches']}, stages (s) mesh {json.dumps(r0['stages_s'])} against single "
              f"{json.dumps(r0['single_stages_s'])}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({"ok": True, "ranks": args.ranks, "device": args.device}), flush=True)
    return summary


if __name__ == "__main__":
    main()
