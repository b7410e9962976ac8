from .attention import Attention, QAttention, QAttentionQKR, qkr_quant_chain
from .bias import ImageBias, LearnableBias
from .conv import LsqImgQuantizer, PatchEmbedConv, QPatchEmbedConv
from .linear import (Dense, LsqLinear, Mlp, PReLU, QHeadLinear, QLinear, QMlp,
                     RPReLU, gelu)
from .quantizers import LsqAct, LsqWeight, LsqWeightIterativeFreezing

__all__ = [
    "Attention", "Dense", "ImageBias", "LearnableBias", "LsqAct",
    "LsqImgQuantizer", "LsqLinear", "LsqWeight", "LsqWeightIterativeFreezing",
    "Mlp", "PReLU", "PatchEmbedConv", "QAttention", "QAttentionQKR",
    "QHeadLinear", "QLinear", "QMlp", "QPatchEmbedConv", "RPReLU", "gelu",
    "qkr_quant_chain",
]
