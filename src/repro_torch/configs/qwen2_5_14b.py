"""qwen2.5-14b [dense] — 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.

QKV bias, SwiGLU, head_dim 128.  [hf:Qwen/Qwen2.5-0.5B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    arch="transformer",
    vocab=152064,
    d_model=5120,
    n_layers=48,
    n_heads=40,
    n_kv=8,
    d_head=128,
    d_ff=13824,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    microbatch=2,
    run_long_500k=False,
    skip_note="pure full attention; long_500k skipped per task rule",
)
