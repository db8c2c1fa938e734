"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

RoPE, GELU MLP with bias, sliding window 4096.  [arXiv:2402.19173; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    arch="transformer",
    vocab=49152,
    d_model=3072,
    n_layers=30,
    n_heads=24,
    n_kv=2,
    d_head=128,
    d_ff=12288,
    act="gelu",
    mlp_bias=True,
    qkv_bias=True,
    rope_theta=100_000.0,
    window=4096,
    run_long_500k=False,
    skip_note=(
        "sliding-window-only (4096) would bound the cache, but the arch is "
        "full-attention family per the task rule; long_500k skipped"
    ),
)
