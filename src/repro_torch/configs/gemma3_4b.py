"""gemma3-4b [dense] — 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (window 1024; every 6th layer global, theta 1M on
global / 10k on local), head_dim 256, GeGLU, logit softcap, 128k context
design target.  [hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    arch="transformer",
    vocab=262144,
    d_model=2560,
    n_layers=34,
    n_heads=8,
    n_kv=4,
    d_head=256,
    d_ff=10240,
    act="geglu",
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    window=1024,
    window_period=6,                # layers 6, 12, ... are global
    logit_softcap=30.0,
    microbatch=2,
    # 5:1 local:global => only ~1/6 of layers carry the 500k KV; the arch's
    # design point is long context, so the long_500k cell runs.
    run_long_500k=True,
)
