"""Minimal batched LM serving engine: prefill, then a decode loop with
sampling, the port of ``repro/serve/lm.py``.

A fixed batch (join at prefill), per-request greedy or temperature
sampling at each request's own temperature, EOS masking, and stats that
count only the real tokens.  Prompts are left-padded with BOS = 0, and the
padded tokens are attended to, as in the reference.  Sampling draws from a
``torch.Generator`` seeded by ``generate``'s ``seed`` (Gumbel-max over the
scaled logits, as ``jax.random.categorical`` samples): the random streams
differ from ``jax.random``'s, so only greedy rows compare across packages.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import engine
from ..engine.plan import resolve_device
from ..models import get_model


@dataclasses.dataclass
class GenRequest:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 => greedy
    eos_id: int = 1


class Engine:
    """``params`` are the model's masters on ``device`` (default the card,
    which raises without one unless ``device="cpu"``); the engine keeps a
    copy with the weights cast once to ``cfg.dtype``, which gives the bits
    of casting them at each step (bfloat16 masters under bfloat16 compute
    are shared, not copied).  Every decoder family serves through its
    own cache: the transformers (KV, MLA's latent cache, MoE), mamba2's
    (conv, SSM) states and griffin's recurrent states with its ring of
    window slots.  As in the reference, ``generate`` takes token prompts
    only (no patch embeddings)."""

    def __init__(self, cfg, params, max_len: int = 512, cache_dtype=torch.float32,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        found = {t.device.type for t in params.parameters()}
        if found != {self.device.type}:
            raise ValueError(f"the parameters lie on {sorted(found)}, the engine runs on {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = self.model.cast_for_compute(params, cfg)
        self.max_len = max_len
        self.cache_dtype = cache_dtype

    def _decode(self, cache, cur, temps, gen):
        # temps is (b,): each request samples at ITS OWN temperature
        logits, cache = self.model.decode_step(self.params, self.cfg, cache, cur)
        greedy = torch.argmax(logits, dim=-1)
        scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
        u = torch.rand(scaled.shape, generator=gen, device=scaled.device).clamp_min(torch.finfo(torch.float32).tiny)
        sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
        nxt = torch.where(temps > 0, sampled, greedy).to(torch.int32)
        return nxt[:, None], cache

    @torch.inference_mode()
    def generate(self, requests: list[GenRequest], seed: int = 0) -> list[np.ndarray]:
        """Batched generation; prompts are right-aligned, padded to equal length."""
        b = len(requests)
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad with BOS=0
        max_new = max(r.max_new_tokens for r in requests)
        temps = torch.tensor([r.temperature for r in requests], dtype=torch.float32, device=self.device)
        eos = np.asarray([r.eos_id for r in requests], np.int32)
        gen = torch.Generator(device=self.device).manual_seed(seed)

        t0 = time.monotonic()
        logits, cache = self.model.prefill(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device), max_len=self.max_len,
            cache_dtype=self.cache_dtype)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        cur = engine.to_host(nxt, "lm_decode")
        t_prefill = time.monotonic() - t0
        outs = [cur]
        done = cur[:, 0] == eos
        for _ in range(max_new - 1):
            if done.all():
                break
            nxt, cache = self._decode(cache, nxt, temps, gen)
            cur = engine.to_host(nxt, "lm_decode")
            # rows that already emitted EOS keep emitting EOS: sampled junk
            # from finished rows must never reach results or the stats
            cur = np.where(done[:, None], eos[:, None], cur)
            outs.append(cur)
            done |= cur[:, 0] == eos
        dt = time.monotonic() - t0
        gen_toks = np.concatenate(outs, axis=1)
        results = []
        for i, r in enumerate(requests):
            row = gen_toks[i][: r.max_new_tokens]
            hit = np.nonzero(row == r.eos_id)[0]
            results.append(row[: hit[0] + 1] if len(hit) else row)
        # per-request generated counts stop at EOS, so the throughput stat
        # reflects real tokens, not padding decoded for the batch laggards
        n_tokens = int(sum(len(r) for r in results))
        self.last_stats = {
            "wall_s": dt,
            "tokens": n_tokens,
            "tok_per_s": float(n_tokens / max(dt, 1e-9)),
            "batch_steps": int(gen_toks.shape[1]),
            "prefill_s": t_prefill,
        }
        return results
