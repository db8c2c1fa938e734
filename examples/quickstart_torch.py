"""Quickstart on the PyTorch port: one hundred hierarchies for the cost of
about two (the paper's headline), as ``examples/quickstart.py`` shows it.

Builds the same clustered dataset, fits the `MultiHDBSCAN` estimator
once, compares against the re-run baseline (one Prim's MST per mpts), and
verifies that the hierarchies agree.

  PYTHONPATH=src python examples/quickstart_torch.py                  # on the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu     # plain PyTorch on the CPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n-per-center 60 --kmax 8
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.api import MultiHDBSCAN
from repro_torch.core import multi


def make_data(n_per_center: int = 500, d: int = 8, seed: int = 0) -> np.ndarray:
    """Eight Gaussian blobs of unit spread around centres drawn in
    [-10, 10]^d: the reference example's dataset at its defaults."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(8, d))
    return np.concatenate([rng.normal(c, 1.0, size=(n_per_center, d)) for c in centers]).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n-per-center", type=int, default=500)
    ap.add_argument("--kmax", type=int, default=32)
    args = ap.parse_args(argv)
    x = make_data(args.n_per_center)
    kmax = args.kmax
    print(f"dataset: n={len(x)}, d={x.shape[1]}, mpts range [2, {kmax}], device {args.device}")

    t0 = time.monotonic()
    est = MultiHDBSCAN(kmax=kmax, device=args.device).fit(x)
    profile = est.mpts_profile()  # forces extraction of the whole range
    t_multi = time.monotonic() - t0
    print(f"\nMultiHDBSCAN: {len(profile)} hierarchies in {t_multi:.2f}s")
    print(f"  graph edges: {est.n_graph_edges_:,} (complete graph: {len(x) * (len(x) - 1) // 2:,})")
    print("  fit timings:", {k: round(v, 2) for k, v in est.timings_.items()})

    t0 = time.monotonic()
    base, _ = multi.hdbscan_baseline(x, [kmax], device=args.device)
    t_one = time.monotonic() - t0
    print(f"\nbaseline, ONE hierarchy (mpts={kmax}): {t_one:.2f}s")
    print(f"=> {len(profile)} hierarchies for {t_multi / t_one:.1f}x the cost of one (paper: ~2x at kmax=128)")

    _, _, w = est.mst_for(kmax)
    np.testing.assert_allclose(np.sort(w), np.sort(base[0].mst_w), rtol=1e-5, atol=1e-6)
    print("\nMST weight multisets agree with the baseline — hierarchies are exact.")

    print("\nclusters per mpts (sampled):")
    for row in profile[:: max(1, len(profile) // 8)]:
        print(f"  mpts={row['mpts']:3d}: {row['n_clusters']:3d} clusters, {row['n_noise']:4d} noise pts")
    return {"x": x, "labels": {v.mpts: v.labels for v in est.select_all()}, "profile": profile}


if __name__ == "__main__":
    main()
