"""LSQ quantizer modules (port of `ofq_tpu/nn/quantizers.py:23-152`).

`learnable=False` detaches the scale (JAX's `stop_gradient` on `s`): the
quantizer still uses it, but no gradient reaches it.

The learned scale `s` is a parameter whose shape the caller states.  Its
value comes from a checkpoint (`convert.load_flax_params`) or from a
calibration forward (`calibrate.calibrate`): while a quantizer's
`calibrating` flag is set, it first sets `s` by `init_scale` from the input
it sees and then quantizes with it -- the sequential order of the JAX
package's data-dependent `model.init`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.tensor import copy_to_model
from ..quant.lsq import (grad_scale_factor, init_scale, lsq_quantize,
                         thresholds)
from ..quant.oscillation import (OscillationState, init_oscillation_state,
                                 track_oscillation)
from ..quant.ste import at_least_f32, clip_lower, grad_scale, round_pass


def _calibrate_scale(param: nn.Parameter, value: torch.Tensor,
                     name: str) -> None:
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: calibration gives a scale of shape "
                         f"{tuple(value.shape)}, the param is "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


class LsqAct(nn.Module):
    """Learned-step-size activation fake-quantizer.

    channel_axis: -2 per token, -1 per channel, None per tensor, or a tuple
    of axes (one scale per index combination, stored flat).  `num_scales`
    is the number of scale entries (1 for per-tensor).  `tp` (set by
    `parallel.shard_model`: (axis, mesh)) says that the input is sharded
    along `axis` over the mesh's model group while the scale is whole:
    the scale's gradient is summed over the group and its grad-scale
    factor counts the axis's global length.
    """

    def __init__(self, bit: int, num_scales: int, *,
                 all_positive: bool = False, channel_axis=-2,
                 learnable: bool = True):
        super().__init__()
        self.bit = bit
        self.all_positive = all_positive
        self.channel_axis = channel_axis
        self.learnable = learnable
        self.calibrating = False
        self.tp = None
        self.s = nn.Parameter(torch.ones(num_scales)) if bit < 32 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bit >= 32:
            return x
        if self.calibrating:
            _calibrate_scale(self.s, init_scale(
                x.to(at_least_f32(x.dtype)), self.bit, self.all_positive,
                self.channel_axis), "LsqAct")
        s = self.s if self.learnable else self.s.detach()
        model = None
        if self.tp is not None:
            axis, mesh = self.tp
            s = copy_to_model(s, mesh)
            model = (axis, mesh.model_parallel)
        return lsq_quantize(x, s, self.bit,
                            all_positive=self.all_positive,
                            channel_axis=self.channel_axis, model=model)


class LsqWeight(nn.Module):
    """LSQ weight fake-quantizer, one scale per output column (last axis;
    `per_channel=False`: one per tensor), calibrated from the kernel
    itself; `all_positive` (--wq_asym) takes the unsigned range.  `tp`
    (set by `parallel.shard_model` on a row-parallel kernel: (0, mesh))
    says that the kernel's rows are cut over the mesh's model group while
    the scale is whole: its gradient is summed over the group and its
    grad-scale factor counts the whole kernel's rows."""

    def __init__(self, bit: int, num_scales: int, *, learnable: bool = True,
                 per_channel: bool = True, all_positive: bool = False):
        super().__init__()
        self.bit = bit
        self.learnable = learnable
        self.all_positive = all_positive
        self.axis = -1 if per_channel else None
        self.calibrating = False
        self.tp = None
        self.s = (nn.Parameter(torch.ones(num_scales if per_channel else 1))
                  if bit < 32 else None)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        if self.bit >= 32:
            return w
        w32 = w.to(at_least_f32(w.dtype))
        if self.calibrating:
            _calibrate_scale(self.s, init_scale(
                w32, self.bit, self.all_positive, self.axis), "LsqWeight")
        s = self.s if self.learnable else self.s.detach()
        model = None
        if self.tp is not None:
            axis, mesh = self.tp
            s = copy_to_model(s, mesh)
            model = (axis, mesh.model_parallel)
        return lsq_quantize(w32, s, self.bit, all_positive=self.all_positive,
                            channel_axis=self.axis, weight=True,
                            model=model).to(w.dtype)


class LsqWeightIterativeFreezing(nn.Module):
    """LSQ weight quantizer that tracks the oscillation of its integer codes
    and pins those that oscillate (`ofq_tpu.nn.quantizers.
    LsqWeightIterativeFreezing`; no model wires it, in JAX either).

    The state (JAX's `oscillation` collection, `<path>/state/<field>`) is
    the buffers of the child `state`; `calibrate` sets it from the codes
    of the calibrated scale, as JAX's init does, and `load_flax_params`
    carries JAX's.  A training forward (`training=True`) tracks and
    updates it, and raises where it may not (`track=False`, JAX's
    immutable collection); any other forward pins the frozen codes without
    tracking."""

    def __init__(self, bit: int, shape: tuple, *, per_channel: bool = True,
                 learnable: bool = True, freeze_momentum: float = 0.01,
                 freeze_threshold: float = 0.0):
        super().__init__()
        self.bit = bit
        self.learnable = learnable
        self.axis = -1 if per_channel else None
        self.freeze_momentum = freeze_momentum
        self.freeze_threshold = freeze_threshold
        self.calibrating = False
        self.track = True
        self.s = nn.Parameter(torch.ones(shape[-1] if per_channel else 1))
        self.state = nn.Module()
        self._set_state(init_oscillation_state(torch.zeros(shape)))

    def oscillation_state(self) -> OscillationState:
        return OscillationState(*(getattr(self.state, n)
                                  for n in OscillationState._fields))

    def _set_state(self, state: OscillationState) -> None:
        for name, t in zip(OscillationState._fields, state):
            self.state.register_buffer(name, t.detach())

    def forward(self, w: torch.Tensor, *,
                training: bool = False) -> torch.Tensor:
        w32 = w.to(at_least_f32(w.dtype))
        if self.calibrating:
            _calibrate_scale(self.s, init_scale(w32, self.bit, False,
                                                self.axis),
                             "LsqWeightIterativeFreezing")
        s = self.s if self.learnable else self.s.detach()
        thd_neg, thd_pos = thresholds(self.bit, False)
        gf = grad_scale_factor(w32.shape, self.bit, False, self.axis)
        shape = [1] * w32.ndim
        if self.axis is not None:
            shape[self.axis] = s.shape[0]
        s_eff = grad_scale(clip_lower(s.reshape(shape), 1e-5), gf)
        x_int = round_pass(torch.clamp(w32 / s_eff, thd_neg, thd_pos))
        state = self.oscillation_state()
        if self.calibrating:
            self._set_state(init_oscillation_state(x_int))
        elif training:
            if not self.track:
                raise ValueError("a training forward needs the oscillation "
                                 "state mutable (track=True)")
            x_int, new = track_oscillation(
                x_int, state, momentum=self.freeze_momentum,
                freeze_threshold=self.freeze_threshold)
            self._set_state(new)
        else:
            x_int = torch.where(state.frozen, state.frozen_x_int, x_int)
        return (x_int * s_eff).to(w.dtype)
