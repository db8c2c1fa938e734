"""Data pipeline: deterministic synthetic corpus + packing + resume state.

A copy of ``repro/train/data.py`` (pure numpy) whose ``train_batch``
returns torch tensors on the CPU; the caller moves them to its device.

The generator is a pure function of (seed, step), so checkpoint-resume
reproduces the exact same batch stream with no iterator state to persist
beyond the step counter — the simplest correct form of data-pipeline fault
tolerance (and what the resume test asserts).

Synthetic text is a Zipf-ish Markov stream (not uniform noise) so language-
model training losses actually descend, and document boundaries + packing
emulate a production mixture.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 50_000
    seq_len: int = 1024
    global_batch: int = 8
    mean_doc_len: int = 384
    zipf_a: float = 1.3


def _batch_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """(B, S+1) int32, deterministic in (seed, step). Zipf unigram + doc breaks."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s = cfg.global_batch, cfg.seq_len + 1
    # zipf over vocab, clipped
    toks = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
    toks = (toks - 1) % (cfg.vocab - 2) + 2          # reserve 0=BOS, 1=EOS
    # inject document boundaries (packing): geometric doc lengths
    n_docs = max(1, s // cfg.mean_doc_len)
    for i in range(b):
        cuts = rng.integers(1, s - 1, size=n_docs)
        toks[i, cuts] = 1
        toks[i, np.minimum(cuts + 1, s - 1)] = 0
    toks[:, 0] = 0
    return toks.astype(np.int32)


def train_batch(cfg: DataConfig, step: int) -> dict:
    """{'tokens': (B, S), 'labels': (B, S), 'mask': (B, S)}."""
    t = _batch_tokens(cfg, step)
    tokens, labels = t[:, :-1], t[:, 1:]
    mask = (labels != 0).astype(np.float32)          # don't predict BOS
    return {
        "tokens": torch.from_numpy(np.ascontiguousarray(tokens)),
        "labels": torch.from_numpy(np.ascontiguousarray(labels)),
        "mask": torch.from_numpy(mask),
    }


def embedding_stream(seed: int, n: int, dim: int, n_modes: int = 12) -> np.ndarray:
    """Synthetic 'document embedding' stream with cluster structure, for the
    clustering-engine examples (stands in for LM-pooled embeddings)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4.0, size=(n_modes, dim))
    scales = rng.uniform(0.3, 1.2, size=n_modes)
    which = rng.integers(0, n_modes, size=n)
    x = centers[which] + rng.normal(size=(n, dim)) * scales[which][:, None]
    # 5% uniform background noise
    noise = rng.random(n) < 0.05
    x[noise] = rng.uniform(-8, 8, size=(int(noise.sum()), dim))
    return x.astype(np.float32)
