"""Serve a small LM with batched requests through the decode engine: the
PyTorch port of ``examples/serve_lm.py`` (gemma3-4b reduced, 8 requests at
temperature 0.8).

  PYTHONPATH=src python examples/serve_lm_torch.py               # on the card
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # on the CPU
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.lm import Engine, GenRequest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config("gemma3_4b").reduced()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    eng = Engine(cfg, params, max_len=96, device=device)

    rng = np.random.default_rng(0)
    reqs = [
        GenRequest(prompt=rng.integers(2, cfg.vocab, size=rng.integers(3, 12)).astype(np.int32),
                   max_new_tokens=24, temperature=0.8)
        for _ in range(8)
    ]
    outs = eng.generate(reqs, seed=1)
    for i, o in enumerate(outs):
        print(f"req {i}: prompt_len={len(reqs[i].prompt)} -> {len(o)} tokens: {o[:10]}...")
    print("engine stats:", eng.last_stats)


if __name__ == "__main__":
    main()
