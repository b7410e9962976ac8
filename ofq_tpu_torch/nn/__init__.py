from .attention import Attention, QAttentionQKR, qkr_quant_chain
from .bias import ImageBias, LearnableBias
from .conv import LsqImgQuantizer, PatchEmbedConv, QPatchEmbedConv
from .linear import Dense, Mlp, QHeadLinear, QLinear, QMlp, gelu
from .quantizers import LsqAct, LsqWeight

__all__ = [
    "Attention", "Dense", "ImageBias", "LearnableBias", "LsqAct",
    "LsqImgQuantizer", "LsqWeight", "Mlp", "PatchEmbedConv", "QAttentionQKR",
    "QHeadLinear", "QLinear", "QMlp", "QPatchEmbedConv", "gelu",
    "qkr_quant_chain",
]
