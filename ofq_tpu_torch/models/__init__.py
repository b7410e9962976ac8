from .deit import (DEIT_BASE, DEIT_SMALL, DEIT_TINY, BatchNorm, Block,
                   DeiTConfig, LayerNorm, VisionTransformer, deit_model,
                   init_weights)
from .registry import (create_model, list_models, register_model,
                       resolve_device)
from .swin import (SWIN_TINY, PatchMerging, QSwinAttentionQKR, SwinAttention,
                   SwinBlock, SwinConfig, SwinTransformer, swin_model)

__all__ = [
    "BatchNorm", "Block", "DEIT_BASE", "DEIT_SMALL", "DEIT_TINY",
    "DeiTConfig", "LayerNorm",
    "PatchMerging", "QSwinAttentionQKR", "SWIN_TINY", "SwinAttention",
    "SwinBlock", "SwinConfig", "SwinTransformer", "VisionTransformer",
    "create_model", "deit_model", "init_weights", "list_models",
    "register_model", "resolve_device",
    "swin_model",
]
