"""Quantized dense layers and MLP (port of `ofq_tpu/nn/linear.py:125-252,
333-433`).

Kernels keep the Flax `(in, out)` layout.  `QLinear` has the composed
branch (bias -> LSQ -> bias -> x @ StatsQ(W)) and the fused branch
(`matmul_impl='fused'`: one CUDA kernel, `ops/fused_qlinear.py`); both
read the same parameters (`move_b4.bias`, `input_quant.s`,
`move_aft.bias`, `kernel`, `bias`), as the JAX param tree is the same for
every `matmul_impl`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_qlinear import (fused_qlinear, fused_qlinear_fwd,
                                 fused_qlinear_fwd_reference)
from ..quant.statsq import statsq_quantize
from .bias import LearnableBias
from .quantizers import LsqAct, LsqWeight


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, `jax.nn.gelu(approximate=False)`."""
    return torch.nn.functional.gelu(x, approximate="none")


def check_bits(**bits: int) -> None:
    """The slice quantizes every site: reject bit widths >= 32."""
    for name, b in bits.items():
        if not 1 <= b < 32:
            raise NotImplementedError(
                f"{name}={b}: the port quantizes every site of the slice "
                "(1 <= bits < 32); unquantized sites are a ROADMAP item")


class QLinear(nn.Module):
    """StatsQ(weight) + bias->LSQ->bias(input) + matmul + bias.

    `symmetric=False` selects the all-positive input quantizer (post-GELU
    fc2 inputs).  `n_tokens` is the length of the token axis (axis -2 of
    the input), which carries the per-token LSQ scale.  `use_kernels`
    and `calibrating` are set model-wide (see `VisionTransformer`).
    """

    def __init__(self, in_features: int, features: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int, symmetric: bool = True,
                 matmul_impl: str | None = None):
        super().__init__()
        check_bits(weight_bits=weight_bits, input_bits=input_bits)
        if matmul_impl not in (None, "xla", "fused"):
            raise NotImplementedError(
                f"matmul_impl={matmul_impl!r}: the port has the composed "
                "path and 'fused'; 'pallas' (StatsQ matmul) and 'int8' are "
                "ROADMAP items")
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.symmetric = symmetric
        self.matmul_impl = matmul_impl
        self.use_kernels = True
        self.calibrating = False
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.move_b4 = LearnableBias(in_features)
        self.input_quant = LsqAct(input_bits, n_tokens,
                                  all_positive=not symmetric, channel_axis=-2)
        self.move_aft = LearnableBias(in_features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.matmul_impl == "fused" and not self.calibrating:
            return fused_qlinear(
                x, self.kernel, self.input_quant.s, self.move_b4.bias,
                self.move_aft.bias, self.bias, w_bits=self.weight_bits,
                a_bits=self.input_bits, all_positive=not self.symmetric,
                fwd=(fused_qlinear_fwd if self.use_kernels
                     else fused_qlinear_fwd_reference))
        x = self.move_aft(self.input_quant(self.move_b4(x)))
        w = statsq_quantize(self.kernel, self.weight_bits)
        y = torch.matmul(x, w.to(x.dtype))
        return y + self.bias.to(y.dtype)


class QHeadLinear(nn.Module):
    """W8A8 classifier head (pinned to 8 bits whatever the policy):
    per-tensor input LSQ + per-column weight LSQ."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.move_b4 = LearnableBias(in_features)
        self.input_quant = LsqAct(8, 1, channel_axis=None)
        self.move_aft = LearnableBias(in_features)
        self.weight_quant = LsqWeight(8, features)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.move_aft(self.input_quant(self.move_b4(x)))
        y = torch.matmul(x, self.weight_quant(self.kernel).to(x.dtype))
        return y + self.bias.to(y.dtype)


class QMlp(nn.Module):
    """fc1 (signed input) -> GELU -> fc2 (all-positive input)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, n_tokens: int, *, weight_bits: int,
                 input_bits: int, act_layer: str = "gelu",
                 matmul_impl: str | None = None):
        super().__init__()
        if act_layer != "gelu":
            raise NotImplementedError(
                f"act_layer={act_layer!r}: the port has GELU only")
        kw = dict(weight_bits=weight_bits, input_bits=input_bits,
                  matmul_impl=matmul_impl)
        self.fc1 = QLinear(in_features, hidden_features, n_tokens,
                           symmetric=True, **kw)
        self.fc2 = QLinear(hidden_features, out_features, n_tokens,
                           symmetric=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
