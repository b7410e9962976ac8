"""W8A8 patch-embedding convolution (port of `ofq_tpu/nn/conv.py:30-138`).

NHWC images and an HWIO kernel, as in JAX.  A patchify convolution
(stride == kernel == patch) is a space-to-depth reshape followed by one
matrix product, left to `torch.matmul`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..quant.lsq import init_scale, lsq_quantize_dynamic_signed
from ..quant.ste import at_least_f32
from .bias import ImageBias
from .quantizers import LsqWeight, _calibrate_scale


class LsqImgQuantizer(nn.Module):
    """Per-image-channel LSQ with the reference's sticky signedness.

    `signed` is a 0/1 float buffer (the JAX `quant_stats` collection):
    calibration sets it from the batch (any value below -1e-5 makes the
    range signed); the eval forward reads it as stored.
    """

    def __init__(self, bit: int, channels: int):
        super().__init__()
        self.bit = bit
        self.calibrating = False
        self.s = nn.Parameter(torch.ones(channels))
        self.register_buffer("signed", torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(at_least_f32(x.dtype))
        if self.calibrating:
            batch_signed = (torch.min(x32) < -1e-5).to(self.signed.dtype)
            self.signed.copy_(batch_signed)
            _calibrate_scale(self.s, init_scale(x32, self.bit, False, -1),
                             "LsqImgQuantizer")
        y = lsq_quantize_dynamic_signed(x32, self.s, self.bit,
                                        self.signed != 0, channel_axis=-1)
        return y.to(x.dtype)


def _patchify(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Space-to-depth: (B, nh*kh, nw*kw, C) -> (B, nh, nw, kh*kw*C); a
    remainder of rows or columns is dropped (VALID convolution)."""
    B, H, W, C = x.shape
    nh, nw = H // kh, W // kw
    x = x[:, :nh * kh, :nw * kw]
    x = x.reshape(B, nh, kh, nw, kw, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, nh, nw, kh * kw * C)


class QPatchEmbedConv(nn.Module):
    """Patchify conv with W8A8 LSQ fake-quant (pinned to 8 bits whatever
    the policy): image bias -> LSQ4img -> image bias, per-output-channel
    LSQ weights."""

    def __init__(self, in_chans: int, features: int, patch_size=(16, 16),
                 img_size=(224, 224)):
        super().__init__()
        self.patch_size = tuple(patch_size)
        kh, kw = self.patch_size
        self.kernel = nn.Parameter(torch.zeros(kh, kw, in_chans, features))
        self.move_b4 = ImageBias(*img_size)
        self.input_quant = LsqImgQuantizer(8, in_chans)
        self.move_aft = ImageBias(*img_size)
        self.weight_quant = LsqWeight(8, features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.patch_size
        x = self.move_aft(self.input_quant(self.move_b4(x)))
        wq = self.weight_quant(self.kernel)
        w2 = wq.reshape(-1, wq.shape[-1]).to(x.dtype)
        y = torch.matmul(_patchify(x, kh, kw), w2)
        return y + self.bias.to(y.dtype)
