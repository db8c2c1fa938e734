"""kimi-k2-1t-a32b [moe] — 61L d=7168 64H (GQA kv=8) vocab=163840.

MoE 384 routed top-8 + 1 shared, expert d_ff=2048; ~1.04T total params,
~32B active.  The assignment specifies GQA kv=8 (real K2 uses MLA; the
assigned table wins — DESIGN.md §5).  Trains on 512 v5e only with bf16
master + int8 blockwise Adam + microbatch=1 (DESIGN.md §8).
[arXiv:2501.kimi2; paper-table]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    arch="transformer",
    vocab=163840,
    d_model=7168,
    n_layers=61,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=0,
    act="swiglu",
    n_experts=384,
    n_shared=1,
    top_k=8,
    d_ff_expert=2048,
    rope_theta=50_000.0,
    tie_embeddings=False,
    microbatch=8,
    param_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    optimizer_state_dtype="int8",
    run_long_500k=False,
    skip_note="pure full attention; long_500k skipped per task rule",
)
