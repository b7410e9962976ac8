"""Learnable shifts around activation quantizers (port of
`ofq_tpu/nn/bias.py:35-71`)."""

from __future__ import annotations

import torch
from torch import nn


class LearnableBias(nn.Module):
    """Additive bias over the trailing feature axis.  `apply_shape`
    reshapes the stored flat `(dim,)` param to a trailing multi-axis
    shape, e.g. (H, C) on a (B, N, H, C) tensor."""

    def __init__(self, dim: int, apply_shape: tuple | None = None):
        super().__init__()
        self.apply_shape = apply_shape
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias
        if self.apply_shape is not None:
            b = b.reshape(self.apply_shape)
        return x + b.to(x.dtype)


class ImageBias(nn.Module):
    """Additive spatial bias for NHWC images, one value per (h, w)."""

    def __init__(self, height: int, width: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(height, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias[None, :, :, None].to(x.dtype)
