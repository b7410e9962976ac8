"""Learnable shifts around activation quantizers (port of
`ofq_tpu/nn/bias.py`)."""

from __future__ import annotations

import torch
from torch import nn

from ..quant.ste import needs_grad


class _BiasAdd(torch.autograd.Function):
    """`x + b` with the custom VJP of `ofq_tpu.nn.bias._bias_add`: dx = g,
    db = the sum of g over the leading axes, taken in fp32 whatever the
    stream's dtype (as JAX does, also under fp64)."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.b_shape = (b.ndim, b.dtype)
        return x + b.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        ndim_b, b_dtype = ctx.b_shape
        lead = tuple(range(g.ndim - ndim_b))
        db = g.to(torch.float32)
        if lead:
            db = torch.sum(db, dim=lead)
        return g, db.to(b_dtype)


def bias_add(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not needs_grad(x, b):
        return x + b.to(x.dtype)
    return _BiasAdd.apply(x, b)


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
        return bias_add(x, b)


class ImageBias(nn.Module):
    """Additive spatial bias for NHWC images, one value per (h, w)."""

    def __init__(self, height: int, width: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(height, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias[None, :, :, None].to(x.dtype)
