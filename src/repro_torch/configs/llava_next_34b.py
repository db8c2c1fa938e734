"""llava-next-34b [vlm] — 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Transformer backbone only (Yi-34B-class); the anyres-tiling vision frontend
is a STUB per the task: input_specs() feeds precomputed patch embeddings
(B, n_patch, 1152) through a 2-layer MLP projector into the token stream.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    arch="transformer",
    vocab=64000,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_head=128,
    n_layers=60,
    d_ff=20480,
    act="swiglu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    frontend="patches",
    frontend_dim=1152,
    frontend_tokens_4k=2880,        # anyres 2880 patch positions + 1216 text
    microbatch=4,
    run_long_500k=False,
    skip_note="pure full attention; long_500k skipped per task rule",
)
