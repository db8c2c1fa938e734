"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H d_ff(expert)=1408 vocab=102400.

MLA: kv_lora=512, qk_nope=128, qk_rope=64, v=128, no q-compression (V2-Lite).
MoE: 2 shared + 64 routed experts, top-6.  NOTE: the assignment block lists
both "64e" and "2 shared+160 routed"; V2-Lite's published config is 64 routed
=> we implement 64 and record the discrepancy (DESIGN.md §5).
[arXiv:2405.04434; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    arch="transformer",
    vocab=102400,
    d_model=2048,
    n_layers=27,
    n_heads=16,
    n_kv=16,
    d_head=192,                     # qk_nope + qk_rope
    d_ff=0,
    act="swiglu",
    n_experts=64,
    n_shared=2,
    top_k=6,
    d_ff_expert=1408,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    rope_theta=10_000.0,
    microbatch=4,
    tie_embeddings=False,
    run_long_500k=False,
    skip_note=(
        "MLA compresses KV memory but attention compute is full-quadratic; "
        "long_500k skipped per task rule"
    ),
)
