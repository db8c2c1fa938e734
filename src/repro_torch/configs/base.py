"""Model/config system: one frozen dataclass per architecture + registry.

Every assigned architecture is a ``ModelConfig`` in its own module
(``src/repro/configs/<id>.py``) and is selectable by ``--arch <id>`` in every
launcher.  ``reduced()`` derives the CPU smoke-test configuration (same
family, tiny dims).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = [
    "gemma3_4b",
    "qwen2_5_14b",
    "qwen2_1_5b",
    "starcoder2_3b",
    "mamba2_780m",
    "recurrentgemma_2b",
    "deepseek_v2_lite_16b",
    "kimi_k2_1t_a32b",
    "llava_next_34b",
    "seamless_m4t_large_v2",
]

# (name, seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | vlm | audio
    arch: str                       # transformer | mamba2 | griffin | encdec
    vocab: int
    d_model: int
    n_layers: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None   # gemma3: global layers differ
    window: int = 0                             # sliding window (0 = full)
    window_period: int = 0                      # gemma3: every `period`-th layer global
    logit_softcap: float = 0.0
    # mlp
    d_ff: int = 0
    act: str = "swiglu"                         # swiglu | geglu | gelu
    mlp_bias: bool = False
    # embeddings
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # MLA
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # mamba2 (SSD)
    d_state: int = 0
    expand: int = 2
    ssm_head: int = 64
    ssd_chunk: int = 256
    d_conv: int = 4
    # griffin (RG-LRU)
    block_pattern: tuple = ()                   # e.g. ("R", "R", "A")
    # enc-dec
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    dec_seq_frac: float = 0.25                  # decoder len = frac * seq_len
    # frontend stubs (vlm / audio): precomputed embeddings enter the stream
    frontend: Optional[str] = None              # patches | frames
    frontend_dim: int = 0
    frontend_tokens_4k: int = 0                 # patch positions inside train_4k
    # numerics / training
    dtype: str = "bfloat16"                      # compute dtype
    param_dtype: str = "float32"                 # master weights
    grad_accum_dtype: str = "float32"            # microbatch accumulation
    remat: bool = True
    microbatch: int = 1                          # grad-accum steps per train_step
    optimizer_state_dtype: str = "float32"       # float32 | bfloat16 | int8
    xent_chunk: int = 512                        # seq-chunked cross entropy
    # shape-cell policy
    run_long_500k: bool = False
    skip_note: str = ""

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded so the vocab dim shards cleanly over
        the model axis (MaxText-style padding; logits rows beyond vocab are
        never referenced by the loss)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        def shrink(v, cap):
            return min(v, cap) if v else v

        return dataclasses.replace(
            self,
            vocab=min(self.vocab, 512),
            d_model=64,
            n_layers=min(self.n_layers, 4) or 4,
            n_heads=shrink(self.n_heads, 4),
            n_kv=shrink(self.n_kv, 2),
            d_head=shrink(self.d_head, 16),
            d_ff=shrink(self.d_ff, 128),
            n_experts=shrink(self.n_experts, 8),
            n_shared=shrink(self.n_shared, 1),
            top_k=shrink(self.top_k, 2),
            d_ff_expert=shrink(self.d_ff_expert, 32),
            kv_lora=shrink(self.kv_lora, 32),
            qk_nope=shrink(self.qk_nope, 16),
            qk_rope=shrink(self.qk_rope, 8),
            v_head=shrink(self.v_head, 16),
            d_state=shrink(self.d_state, 16),
            ssm_head=shrink(self.ssm_head, 16),
            ssd_chunk=min(self.ssd_chunk, 32) if self.ssd_chunk else 0,
            n_enc_layers=shrink(self.n_enc_layers, 2),
            n_dec_layers=shrink(self.n_dec_layers, 2),
            frontend_dim=shrink(self.frontend_dim, 48),
            frontend_tokens_4k=shrink(self.frontend_tokens_4k, 16),
            window=shrink(self.window, 8),
            xent_chunk=32,
            microbatch=1,
            dtype="float32",
            param_dtype="float32",
            grad_accum_dtype="float32",
        )


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
