from .base import ARCH_IDS, SHAPES, ModelConfig, all_configs, get_config

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "all_configs", "get_config"]
