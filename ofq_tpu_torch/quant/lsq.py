"""LSQ (learned step size) fake-quantization
(port of `ofq_tpu/quant/lsq.py:32-280`).

One function parameterized by the axis (or tuple of axes) that carries the
learned scale:
  * -2   per-token scale on (B, N, C) activations,
  * -1   per-channel scale,
  * None per-tensor scale,
  * a tuple, e.g. (1, 2) on (B, N, H, C): one entry per (token, head),
    stored flat in row-major order.
The scale-gradient factors keep the per-shape formulas of the reference
(`grad_scale_factor`); an activation's (`act_grad_scale_factor`, every
activation quantizer's one rule) are taken at the global batch's shape
inside a data-parallel step (`parallel.collectives.batch_shape`), as JAX's
under `jit` over a sharded batch, and, where the call site says an axis is
sharded over the mesh's 'model' axis (`model=(axis, parts)`: the heads of
the attention probabilities, the channels of a row-parallel linear's
input), at that axis's global length.  `lsq_quantize` differentiates through
the fused custom VJP of the JAX package (`_LsqFused`); the image
quantizer's `lsq_quantize_dynamic_signed` through the composition, as in
JAX.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..parallel.collectives import batch_shape
from ..parallel.tensor import model_global_shape
from .ste import at_least_f32, clip_lower, grad_scale, needs_grad, round_pass

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


def act_grad_scale_factor(x_shape: Sequence[int], bit: int,
                          all_positive: bool, channel_axis,
                          model=None) -> float:
    """`grad_scale_factor` of a batch-major activation, at the global
    batch's shape inside a data-parallel step and, with `model=(axis,
    parts)`, at `parts` times this rank's length along that axis (a
    weight's shape has no batch: it takes `grad_scale_factor`)."""
    return grad_scale_factor(model_global_shape(batch_shape(x_shape), model),
                             bit, all_positive, channel_axis)


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


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip`: maximum(lo, x), then minimum(hi, .).  Same values as
    `torch.clamp`, and JAX's gradient: a value exactly on a bound gets
    half the cotangent (torch.maximum/minimum split ties evenly, as
    lax.max/min do), where `torch.clamp` passes all of it."""
    if not needs_grad(x):
        return torch.clamp(x, lo, hi)
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(hi, torch.maximum(lo, x))


def _factor(x_shape, bit, all_positive, channel_axis, weight, model):
    if weight:
        # a kernel cut over the model group counts its whole shape
        return grad_scale_factor(model_global_shape(x_shape, model), bit,
                                 all_positive, channel_axis)
    return act_grad_scale_factor(x_shape, bit, all_positive, channel_axis,
                                 model)


def lsq_quantize_composed(x: torch.Tensor, s: torch.Tensor, bit: int, *,
                          all_positive: bool = False, channel_axis=-2,
                          weight: bool = False, model=None) -> torch.Tensor:
    """LSQ fake-quantization by autograd through the composition
    (`ofq_tpu.quant.lsq.lsq_quantize_composed`).  bit == 1 signed is
    sign(x).  x is a batch-major activation (`act_grad_scale_factor`,
    with `model`) unless `weight` (a kernel: `grad_scale_factor` at its
    whole shape, `model` naming its cut axis)."""
    thd_neg, thd_pos = thresholds(bit, all_positive)
    g = _factor(x.shape, bit, all_positive, channel_axis, weight, model)
    s_b = _broadcast_scale(s, x.shape, channel_axis)
    s_eff = grad_scale(clip_lower(s_b, _S_EPS), g).to(x.dtype)
    y = x / s_eff
    if bit == 1 and not all_positive:
        y = torch.sign(y)
    else:
        y = round_pass(_clip(y, thd_neg, thd_pos))
    return y * s_eff


class _LsqFused(torch.autograd.Function):
    """The custom VJP of `ofq_tpu.quant.lsq._lsq_fused`: the composed
    forward values, residuals (x, s), and one pass for the cotangents:

        dx = g * [thd_neg <= u <= thd_pos]
        ds = gf * sum (in ? round(u) - u : clip(u)) * g   (fp32 sums)

    with u = x / max(s, 1e-5); no masking of ds where s was floored."""

    @staticmethod
    def forward(ctx, x, s, bit, all_positive, channel_axis, weight, model):
        ctx.save_for_backward(x, s)
        ctx.cfg = (bit, all_positive, channel_axis, weight, model)
        return lsq_quantize_composed(x, s, bit, all_positive=all_positive,
                                     channel_axis=channel_axis, weight=weight,
                                     model=model)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        bit, all_positive, channel_axis, weight, model = ctx.cfg
        thd_neg, thd_pos = thresholds(bit, all_positive)
        gf = _factor(x.shape, bit, all_positive, channel_axis, weight, model)
        s_b = _broadcast_scale(s, x.shape, channel_axis)
        s_eff = torch.where(s_b > _S_EPS, s_b,
                            torch.full_like(s_b, _S_EPS)).to(x.dtype)
        u = x / s_eff
        in_range = (u >= thd_neg) & (u <= thd_pos)
        dx = torch.where(in_range, g, torch.zeros_like(g))
        # summed in fp32 (as JAX does, also under fp64).  The terms are
        # formed in at least fp32 from u and g in x's dtype: JAX writes
        # them in x's dtype, but XLA, compiling the step, keeps a bf16
        # product that only feeds an fp32 sum in fp32 (measured on XLA-CPU,
        # PERF.md); in fp32 and fp64 the two agree.
        hi = at_least_f32(x.dtype)
        ds_elem = (torch.where(in_range, torch.round(u) - u,
                               torch.clamp(u, thd_neg, thd_pos)).to(hi)
                   * g.to(hi)).to(torch.float32)
        keep = _scale_axes(channel_axis, x.ndim)
        axes = tuple(a for a in range(x.ndim) if a not in keep)
        ds = torch.sum(ds_elem, dim=axes) if axes else ds_elem
        ds = (ds.reshape(s.shape) * gf).to(s.dtype)
        return dx, ds, None, None, None, None, None


def lsq_quantize(x: torch.Tensor, s: torch.Tensor, bit: int, *,
                 all_positive: bool = False, channel_axis=-2,
                 weight: bool = False, model=None) -> torch.Tensor:
    """LSQ fake-quantization with learned scale `s`
    (`ofq_tpu.quant.lsq.lsq_quantize`): the fused custom VJP for bit > 1
    or an all-positive range, the composition for the bit == 1 sign path
    (whose gradient through sign is zero).  `weight` and `model` as in
    `lsq_quantize_composed`."""
    if (bit == 1 and not all_positive) or not needs_grad(x, s):
        return lsq_quantize_composed(x, s, bit, all_positive=all_positive,
                                     channel_axis=channel_axis, weight=weight,
                                     model=model)
    return _LsqFused.apply(x, s, bit, all_positive, channel_axis, weight,
                           model)


def lsq_quantize_dynamic_signed(x: torch.Tensor, s: torch.Tensor, bit: int,
                                signed: torch.Tensor, *,
                                channel_axis=-1) -> torch.Tensor:
    """LSQ whose signed/unsigned range is a tensor-valued boolean (the
    sticky `signed` state of the image quantizer); stays on the device,
    no host synchronisation.  Differentiated through the composition, as
    in JAX.  x is the batch-major image: its gradient scale counts the
    global batch in a data-parallel step."""
    lo = torch.where(signed, -(2 ** (bit - 1)), 0).to(x.dtype)
    thd_pos = torch.where(signed, 2 ** (bit - 1) - 1, 2 ** bit - 1)
    shape = batch_shape(x.shape)
    if channel_axis is None:
        numel = math.prod(shape)
    else:
        numel = math.prod(shape) // shape[channel_axis % x.ndim]
    g = 1.0 / torch.sqrt(thd_pos.to(torch.float32) * numel)
    s_b = _broadcast_scale(s, x.shape, channel_axis)
    s_eff = grad_scale(clip_lower(s_b, _S_EPS), g)
    y = round_pass(_clip(x / s_eff, lo, thd_pos))
    return y * s_eff
