"""mamba2-780m [ssm] — 48L d=1536 attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality): expand=2 (d_inner=3072), headdim=64 => 48 SSD
heads, chunked scan (chunk 256), causal conv k=4.  [arXiv:2405.21060]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    arch="mamba2",
    vocab=50280,
    d_model=1536,
    n_layers=48,
    d_state=128,
    expand=2,
    ssm_head=64,
    ssd_chunk=256,
    d_conv=4,
    run_long_500k=True,             # O(1) recurrent state
)
