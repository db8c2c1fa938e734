"""seamless-m4t-large-v2 [audio] — enc-dec 24L+24L d=1024 16H d_ff=8192 vocab=256206.

Transformer backbone only; the audio frontend is a STUB per the task:
input_specs() feeds precomputed fbank-frame embeddings (B, S, 1024) into the
encoder; the decoder is text (dec len = seq/4).  [arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    arch="encdec",
    vocab=256206,
    d_model=1024,
    n_layers=48,                    # 24 enc + 24 dec
    n_enc_layers=24,
    n_dec_layers=24,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=8192,
    act="gelu",
    mlp_bias=True,
    dec_seq_frac=0.25,
    frontend="frames",
    frontend_dim=1024,
    tie_embeddings=False,
    run_long_500k=False,
    skip_note="enc-dec: a 500k-frame encoder is quadratic; long_500k skipped",
)
