"""LSQ (learned step size) fake-quantization, forward
(port of `ofq_tpu/quant/lsq.py:32-187, 249-280`).

One function parameterized by the axis (or tuple of axes) that carries the
learned scale:
  * -2   per-token scale on (B, N, C) activations,
  * -1   per-channel scale,
  * None per-tensor scale,
  * a tuple, e.g. (1, 2) on (B, N, H, C): one entry per (token, head),
    stored flat in row-major order.
The scale-gradient factors keep the per-shape formulas of the reference
(`grad_scale_factor`), so the training slice can reuse them unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .ste import clip_lower, grad_scale, round_pass

_S_EPS = 1e-5  # lower bound on the learned scale


def thresholds(bit: int, all_positive: bool) -> tuple[int, int]:
    """Integer range [thd_neg, thd_pos] for a bit width."""
    if all_positive:
        if bit == 1:
            return 0, 1
        return 0, 2**bit - 1
    if bit == 1:
        return -1, 1
    return -(2 ** (bit - 1)), 2 ** (bit - 1) - 1


def _broadcast_scale(s: torch.Tensor, x_shape: Sequence[int],
                     channel_axis) -> torch.Tensor:
    """Reshape a flat (or scalar) scale to broadcast along channel_axis,
    which may be one axis or a tuple of axes (flat row-major entries)."""
    if channel_axis is None or s.ndim == 0 or s.numel() == 1:
        return s.reshape(())
    x_ndim = len(x_shape)
    shape = [1] * x_ndim
    if isinstance(channel_axis, tuple):
        for a in channel_axis:
            shape[a % x_ndim] = x_shape[a % x_ndim]
    else:
        shape[channel_axis] = s.shape[0]
    return s.reshape(shape)


def _scale_axes(channel_axis, ndim: int) -> tuple:
    """Normalized set of axes that carry scale entries."""
    if channel_axis is None:
        return ()
    axes = channel_axis if isinstance(channel_axis, tuple) else (channel_axis,)
    return tuple(a % ndim for a in axes)


def grad_scale_factor(x_shape: Sequence[int], bit: int, all_positive: bool,
                      channel_axis) -> float:
    """1/sqrt(thd_pos * group_numel), with the reference's per-shape
    group sizes:
      per-tensor:                 numel(x)
      axis -2, 2-D (N, C):        C
      axis -2, 3-D (B, N, C):     B * C
      axis -2, 4-D (B, H, N, d):  B * H * d
      axis -1, 2-D (in, out):     in
      axis -1, 3-D (B, N, C):     B * N
      axis -1, 4-D (B, H, N, d):  B * H * N
      other axes (incl. tuples):  elements sharing one scale entry
    """
    _, thd_pos = thresholds(bit, all_positive)
    nd = len(x_shape)
    if channel_axis is None:
        numel = math.prod(x_shape)
    elif channel_axis in (-2, nd - 2):
        if nd == 2:
            numel = x_shape[-1]
        elif nd == 3:
            numel = x_shape[0] * x_shape[-1]
        elif nd == 4:
            numel = x_shape[0] * x_shape[1] * x_shape[-1]
        else:
            raise ValueError(f"unsupported ndim {nd} for axis -2 LSQ")
    elif channel_axis in (-1, nd - 1):
        if nd == 2:
            numel = x_shape[0]
        elif nd == 3:
            numel = x_shape[0] * x_shape[1]
        elif nd == 4:
            numel = x_shape[0] * x_shape[1] * x_shape[2]
        else:
            raise ValueError(f"unsupported ndim {nd} for axis -1 LSQ")
    else:
        axes = channel_axis if isinstance(channel_axis, tuple) else (
            channel_axis,)
        numel = math.prod(x_shape)
        for a in axes:
            numel //= x_shape[a % nd]
    return 1.0 / math.sqrt(thd_pos * numel)


def init_scale(x: torch.Tensor, bit: int, all_positive: bool,
               channel_axis) -> torch.Tensor:
    """Data-dependent scale init from a calibration batch.

    signed: 2 * mean|x| / sqrt(thd_pos); all-positive: 4 * mean|x| /
    sqrt(thd_pos); per-tensor: always the factor 2.  The mean reduces
    over every axis but `channel_axis`.  The result is rounded through
    float32, as the reference stores its scales.
    """
    _, thd_pos = thresholds(bit, all_positive)
    if channel_axis is None:
        m = torch.mean(torch.abs(x))
        s = (2.0 * m / math.sqrt(thd_pos)).reshape(1)
    else:
        factor = 4.0 if all_positive else 2.0
        keep = _scale_axes(channel_axis, x.ndim)
        red = tuple(a for a in range(x.ndim) if a not in keep)
        m = torch.mean(torch.abs(x), dim=red) if red else torch.abs(x)
        s = (factor * m / math.sqrt(thd_pos)).reshape(-1)
    return s.to(torch.float32).to(s.dtype)


def lsq_quantize(x: torch.Tensor, s: torch.Tensor, bit: int, *,
                 all_positive: bool = False, channel_axis=-2) -> torch.Tensor:
    """LSQ fake-quantization with learned scale `s` (forward values of
    `ofq_tpu.quant.lsq.lsq_quantize`).  bit == 1 signed is sign(x)."""
    thd_neg, thd_pos = thresholds(bit, all_positive)
    g = grad_scale_factor(x.shape, bit, all_positive, channel_axis)
    s_b = _broadcast_scale(s, x.shape, channel_axis)
    s_eff = grad_scale(clip_lower(s_b, _S_EPS), g).to(x.dtype)
    y = x / s_eff
    if bit == 1 and not all_positive:
        y = torch.sign(y)
    else:
        y = round_pass(torch.clamp(y, thd_neg, thd_pos))
    return y * s_eff


def lsq_quantize_dynamic_signed(x: torch.Tensor, s: torch.Tensor, bit: int,
                                signed: torch.Tensor, *,
                                channel_axis=-1) -> torch.Tensor:
    """LSQ whose signed/unsigned range is a tensor-valued boolean (the
    sticky `signed` state of the image quantizer); stays on the device,
    no host synchronisation."""
    lo = torch.where(signed, -(2 ** (bit - 1)), 0).to(x.dtype)
    thd_pos = torch.where(signed, 2 ** (bit - 1) - 1, 2 ** bit - 1)
    if channel_axis is None:
        numel = math.prod(x.shape)
    else:
        numel = math.prod(x.shape) // x.shape[channel_axis % x.ndim]
    g = 1.0 / torch.sqrt(thd_pos.to(torch.float32) * numel)
    s_b = _broadcast_scale(s, x.shape, channel_axis)
    s_eff = grad_scale(clip_lower(s_b, _S_EPS), g)
    y = torch.clamp(x / s_eff, lo, thd_pos.to(x.dtype))
    y = round_pass(y)
    return y * s_eff
