"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.

Griffin block pattern (RG-LRU, RG-LRU, local-attn w=2048) ~ 1:2 attn:recurrent,
head_dim 256, GeGLU.  [arXiv:2402.19427; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    arch="griffin",
    vocab=256000,
    d_model=2560,
    n_layers=26,                    # (R,R,A) x 8 + (R,R)
    n_heads=10,
    n_kv=1,
    d_head=256,
    d_ff=7680,
    act="geglu",
    window=2048,
    block_pattern=("R", "R", "A"),
    run_long_500k=True,             # bounded state: LRU + 2048 window
)
