from .attention import QAttentionQKR, qkr_quant_chain
from .bias import ImageBias, LearnableBias
from .conv import LsqImgQuantizer, QPatchEmbedConv
from .linear import QHeadLinear, QLinear, QMlp, gelu
from .quantizers import LsqAct, LsqWeight

__all__ = [
    "ImageBias", "LearnableBias", "LsqAct", "LsqImgQuantizer", "LsqWeight",
    "QAttentionQKR", "QHeadLinear", "QLinear", "QMlp", "QPatchEmbedConv",
    "gelu", "qkr_quant_chain",
]
