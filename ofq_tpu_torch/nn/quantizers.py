"""LSQ quantizer modules (port of `ofq_tpu/nn/quantizers.py:23-62, 124-152`).

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

from ..quant.lsq import init_scale, lsq_quantize
from ..quant.ste import at_least_f32


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
    is the number of scale entries (1 for per-tensor).
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
        self.s = nn.Parameter(torch.ones(num_scales))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            _calibrate_scale(self.s, init_scale(
                x.to(at_least_f32(x.dtype)), self.bit, self.all_positive,
                self.channel_axis), "LsqAct")
        s = self.s if self.learnable else self.s.detach()
        return lsq_quantize(x, s, self.bit,
                            all_positive=self.all_positive,
                            channel_axis=self.channel_axis)


class LsqWeight(nn.Module):
    """Signed LSQ weight fake-quantizer, one scale per output column (last
    axis); calibrated from the kernel itself."""

    def __init__(self, bit: int, num_scales: int, *, learnable: bool = True):
        super().__init__()
        self.bit = bit
        self.learnable = learnable
        self.calibrating = False
        self.s = nn.Parameter(torch.ones(num_scales))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        w32 = w.to(at_least_f32(w.dtype))
        if self.calibrating:
            _calibrate_scale(self.s, init_scale(w32, self.bit, False, -1),
                             "LsqWeight")
        s = self.s if self.learnable else self.s.detach()
        return lsq_quantize(w32, s, self.bit,
                            channel_axis=-1).to(w.dtype)
