"""Multi-density exploration with the PyTorch port's `MultiHDBSCAN`, as
``examples/multi_density_explore.py`` does it.

Fits once, then walks the whole mpts range: which density level reveals
which cluster structure (paper §I motivation), scored with the per-level
stability summary.  The reference's ``--sweep`` (the paper's Table II /
Fig 7 runtime harness) runs the JAX package's benchmark code and is left
out here: the sweep comes with the port's own benchmark.

  PYTHONPATH=src python examples/multi_density_explore_torch.py                 # on the card
  PYTHONPATH=src python examples/multi_density_explore_torch.py --device cpu --n 600 --kmax 10
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.api import MultiHDBSCAN


def make_data(n: int, seed: int = 7) -> np.ndarray:
    """Structure at two density scales: tight twins, one diffuse blob and
    uniform noise (the reference example's data)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal((0, 0), 0.25, size=(n // 4, 2)),
        rng.normal((1.6, 0), 0.25, size=(n // 4, 2)),
        rng.normal((8, 6), 1.4, size=(n // 3, 2)),
        rng.uniform(-4, 12, size=(n - n // 4 * 2 - n // 3, 2)),
    ]).astype(np.float32)


def explore(n: int, kmax: int, device: str = "cuda") -> dict:
    x = make_data(n)
    est = MultiHDBSCAN(kmax=kmax, device=device).fit(x)
    print(f"fitted n={len(x)} in {sum(v for k, v in est.timings_.items()):.2f}s "
          f"(mpts range [2, {kmax}] from ONE graph)\n")

    profile = est.mpts_profile()
    print(f"{'mpts':>5} {'clusters':>9} {'noise':>6} {'largest':>8} {'total_stab':>11}")
    for row in profile:
        largest = max(row["cluster_sizes"], default=0)
        print(f"{row['mpts']:>5} {row['n_clusters']:>9} {row['n_noise']:>6} "
              f"{largest:>8} {row['total_stability']:>11.1f}")

    # rank by stability among non-shattered levels (tiny mpts inflates the
    # lambda scale; see MultiHDBSCAN.mpts_profile docs)
    candidates = [r for r in profile if r["n_clusters"] <= len(x) ** 0.5]
    best = max(candidates, key=lambda r: r["total_stability"])
    print(f"\nhighest-stability level: mpts={best['mpts']} "
          f"({best['n_clusters']} clusters) — labels via est.select(mpts).labels.")
    print("low mpts isolates the tight twins; high mpts merges them and")
    print("stabilizes the diffuse blob — one fit exposes both readings.")
    return {"x": x, "labels": {v.mpts: v.labels for v in est.select_all()}, "profile": profile,
            "best": best["mpts"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The reference's --sweep (paper Table II / Fig 7) is not here: the sweep comes with the "
               "port's benchmark.")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=2400)
    ap.add_argument("--kmax", type=int, default=24)
    args = ap.parse_args(argv)
    return explore(args.n, args.kmax, args.device)


if __name__ == "__main__":
    main()
