"""qwen2-1.5b [dense] — 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

QKV bias, SwiGLU, head_dim 128.  [arXiv:2407.10671; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    arch="transformer",
    vocab=151936,
    d_model=1536,
    n_layers=28,
    n_heads=12,
    n_kv=2,
    d_head=128,
    d_ff=8960,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    run_long_500k=False,
    skip_note="pure full attention; long_500k skipped per task rule",
)
