"""Serve clustering queries from one fitted multi-density state on the
PyTorch port, as ``examples/serve_clusters.py`` does it.

Fits once, saves the fitted state as an artifact, boots a serve worker
from the artifact (the refit-free scale-out path), then drives concurrent
out-of-sample prediction traffic through the micro-batching
``ClusterServeEngine`` and prints the latency profile.

  PYTHONPATH=src python examples/serve_clusters_torch.py                # on the card
  PYTHONPATH=src python examples/serve_clusters_torch.py --device cpu   # plain PyTorch on the CPU
"""

import argparse
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.api import FittedModel, SelectionPolicy
from repro_torch.serve import ClusterServeEngine


def make_data(rng: np.random.Generator) -> np.ndarray:
    """Three blobs of 500, 500 and 300 points (the reference example's)."""
    return np.concatenate([
        rng.normal((0, 0), 0.3, size=(500, 2)),
        rng.normal((4, 0), 0.5, size=(500, 2)),
        rng.normal((2, 4), 0.8, size=(300, 2)),
    ]).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    x = make_data(rng)

    # fit ONCE, persist the artifact: every serve worker loads it in ~ms
    t0 = time.monotonic()
    model = FittedModel.fit(x, kmax=16, device=args.device)
    t_fit = time.monotonic() - t0
    path = os.path.join(tempfile.mkdtemp(), "clusters.fitted.npz")
    model.save(path)
    t0 = time.monotonic()
    with ClusterServeEngine.load(path, expect_config_hash=model.config_hash, device=args.device) as eng:
        t_boot = time.monotonic() - t0
        print(f"fit {t_fit:.2f}s once -> worker boots from "
              f"{os.path.getsize(path) / 1e6:.1f} MB artifact in {t_boot * 1e3:.0f} ms")

        # a burst of concurrent single-query clients, mixed density levels
        queries = x[rng.choice(len(x), size=128)] + rng.normal(0, 0.05, (128, 2)).astype(np.float32)
        results = {}

        def client(i):
            results[i] = eng.predict(queries[i], mpts=int(4 + 4 * (i % 4)))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(128)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        labeled = sum(1 for lab, _ in results.values() if lab[0] >= 0)
        print(f"128 concurrent queries: {labeled} assigned to clusters")
        leaf = SelectionPolicy(method="leaf")
        hybrid = SelectionPolicy(method="leaf", epsilon=0.8)
        n_clusters = {"eom": int(eng.labels(8).max() + 1), "leaf": int(eng.labels(8, policy=leaf).max() + 1),
                      "leaf+eps": int(eng.labels(8, policy=hybrid).max() + 1)}
        print("per-request selection policy:",
              f"eom -> {n_clusters['eom']} clusters,",
              f"leaf -> {n_clusters['leaf']},",
              f"leaf+eps(0.8) -> {n_clusters['leaf+eps']}")
        print("engine stats:", eng.stats())
    return {"x": x, "queries": queries, "labels": [int(results[i][0][0]) for i in range(128)],
            "n_clusters": n_clusters}


if __name__ == "__main__":
    main()
