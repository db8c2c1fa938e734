"""Embed a corpus with an LM, explore it at every density level, pick a
level by DBCV and emit curation decisions: the PyTorch port of
``examples/embedding_curation.py``, steps 2-4.

Embedding-space curation (semantic dedup, outlier removal) needs
clusterings at many density levels, and the engine gives all of them for
about the cost of two.  The reference's step 1 trains a reduced LM for 15
steps and then embeds with freshly initialised parameters, so the trained
weights never reach the embeddings; this port has no training step (the
train step is a later item of ROADMAP.md) and embeds with its own seeded
initialisation.

  PYTHONPATH=src python examples/embedding_curation_torch.py               # on the card
  PYTHONPATH=src python examples/embedding_curation_torch.py --device cpu  # on the CPU
  PYTHONPATH=src python examples/embedding_curation_torch.py --full-width  # qwen2-1.5b as published
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import dbcv, multi
from repro_torch.models import get_model, init_params
from repro_torch.train import data as data_lib


def embed_corpus(cfg, params, n_docs: int, batch: int, device) -> np.ndarray:
    """Mean-pooled final hidden states of ``n_docs`` synthetic documents of
    48 tokens, float32 (n_docs, d_model)."""
    model = get_model(cfg)
    dcfg = data_lib.DataConfig(seed=9, vocab=cfg.vocab, seq_len=48, global_batch=batch)
    embs = []
    with torch.inference_mode():
        for step in range(-(-n_docs // batch)):
            tokens = data_lib.train_batch(dcfg, step)["tokens"].to(device)
            h, _ = model.forward(params, cfg, tokens)
            embs.append(h.mean(dim=1).float().cpu().numpy())
    return np.concatenate(embs)[:n_docs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1200)
    ap.add_argument("--full-width", action="store_true", help="qwen2-1.5b as published (bfloat16)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # 2) embed a "corpus" with the LM (mean-pooled hidden states)
    cfg = get_config("qwen2_1_5b")
    cfg = cfg if args.full_width else cfg.reduced()
    print(f"=== step 2: embed {args.docs} documents with {cfg.name} (d={cfg.d_model}, {cfg.n_layers} layers) ===")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    x = embed_corpus(cfg, params, args.docs, 32 if args.full_width else 8, device)
    # inject duplicated docs (the dedup targets)
    x[-40:] = x[:40] + np.random.default_rng(0).normal(0, 1e-3, x[:40].shape)
    x = x.astype(np.float32)
    print(f"embeddings: {x.shape}")

    # 3) multi-density exploration
    print("\n=== step 3: all hierarchies for mpts in [2, 24] ===")
    res = multi.multi_hdbscan(x, 24, variant="rng_star", device=device)
    scores = {h.mpts: dbcv.dbcv_relative_validity(h.mst_ea, h.mst_eb, h.mst_w, h.labels) for h in res.hierarchies}
    best = max(scores, key=lambda k: scores[k])
    print("DBCV by mpts (sampled):", {k: round(v, 3) for k, v in list(scores.items())[::4]})
    print(f"selected density level: mpts={best} (DBCV={scores[best]:.3f})")

    # 4) curation decisions at the chosen level
    h = [hh for hh in res.hierarchies if hh.mpts == best][0]
    n_noise = int((h.labels == -1).sum())
    print("\n=== step 4: curation report ===")
    print(f"clusters: {h.n_clusters}, outliers flagged: {n_noise}")
    # near-duplicate detection: tiny-mrd MST edges = candidate dupes
    thresh = np.quantile(h.mst_w, 0.01)
    dup_edges = h.mst_w < max(thresh, 1e-6)
    print(f"near-duplicate pairs (bottom-1% mrd): {int(dup_edges.sum())} (injected 40 dupes)")
    keep = np.ones(len(x), bool)
    keep[h.mst_eb[dup_edges]] = False
    print(f"keep list: {int(keep.sum())}/{len(x)} documents")


if __name__ == "__main__":
    main()
