from .deit import (DEIT_BASE, DEIT_SMALL, DEIT_TINY, Block, DeiTConfig,
                   LayerNorm, VisionTransformer, deit_model, init_weights)
from .registry import create_model, resolve_device

__all__ = [
    "Block", "DEIT_BASE", "DEIT_SMALL", "DEIT_TINY", "DeiTConfig", "LayerNorm",
    "VisionTransformer", "create_model", "deit_model", "init_weights",
    "resolve_device",
]
