"""Dense layers, MLPs and their activations, quantized and float (port of
`ofq_tpu/nn/linear.py:30-90,125-451`, and Flax's `nn.Dense`).

Kernels keep the Flax `(in, out)` layout.  `QLinear` has the composed
branch (bias -> LSQ -> bias -> x @ StatsQ(W)), whose product is the
composition or, with `matmul_impl='pallas'`, the K4 kernel
(`ops/pallas_statsq.py`), the fused branch (`matmul_impl='fused'`: one
CUDA kernel, `ops/fused_qlinear.py`) and the int8 branch
(`matmul_impl='int8'`: the product on the integer codes,
`ops/int8_qlinear.py`; widths whose codes do not fit int8 take the
composed branch); all read the same parameters (`move_b4.bias`,
`input_quant.s`, `move_aft.bias`, `kernel`, `bias`), as the JAX param tree
is the same for every `matmul_impl`.  `compute_dtype` ('bfloat16') runs
the product in that dtype with fp32 sums, as JAX's `statsq_matmul` does;
the fused kernel, as JAX's, takes x in fp32 whatever the stream and
returns y in x's dtype.

An unquantized site runs as JAX's `QLinear` runs it: at 32 input bits the
input chain is skipped (and its parameters do not exist), at 32 weight
bits the product is the plain `x @ kernel` in the compute dtype; the fused
branch needs both quantized and the int8 branches integer codes.

`LsqLinear` is the full-LSQ linear (`--wq-mode lsq`): learned-scale
weights (`weight_quant.s`, per output column) and activations, the product
a plain `x @ wq` in the promoted dtype, as JAX's (no kernel); a frozen
artifact's kernel with `frozen_int_bits` runs the integer core on the
codes rebuilt from its restored scale.

Frozen serving (`frozen=True`, from a policy with `weight_frozen`): the
kernel holds dequantized StatsQ values restored from a packed artifact, so
`weight_bits` is 32 and the product skips the quantizer; with
`frozen_int_bits` the layer also holds the artifact's scale
(`kernel_scale`, (1, out)) and runs the integer core on the codes rebuilt
from it.

The MLP activation (`act_layer`): exact GELU, 'relu', 'None' /
'identity', 'prelu' (one learnable slope, `act.alpha`, 0.25 at init) or
'rprelu' (per-channel `act.move1`, `act.alpha`, `act.move2`), as JAX's
`apply_act`; slopes and shifts are cast to the stream's dtype before use
and `x >= 0` takes the identity branch.  An unknown name raises KeyError,
as JAX's lookup does.

Under tensor parallelism (`parallel.shard_model`) a `QLinear`'s `tp` is
('col', mesh) for fc1 (its columns sharded) or ('row', mesh) for proj and
fc2 (its rows, and its input's channels, sharded), which its products
take (`ops/`); a row-parallel layer's input scale has its gradient summed
over the model group and its bias is added after the partial products
are.  The int8 branch runs on the rank's codes (`int8_qlinear`'s
`tp`), an unquantized weight's plain product and the float `Dense` take
the same f and g around `torch.matmul`.  A sharded `QMlp` or `Mlp` cuts
its hidden dropout mask to its columns; its PReLU sums its one slope's
cotangent over the model group (`tp`), its RPReLU holds its columns'
shifts and slopes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_qlinear import (fused_qlinear, fused_qlinear_fwd,
                                 fused_qlinear_fwd_reference)
from ..ops.int8_qlinear import (frozen_int8_forward, frozen_lsq_int8_forward,
                                int8_eligible, int8_mm, int8_mm_reference,
                                int8_qlinear, lsq_int8_eligible)
from ..ops.pallas_statsq import pallas_statsq_fwd, pallas_statsq_fwd_reference
from ..ops.statsq_matmul import statsq_matmul
from ..parallel.tensor import copy_to_model, reduce_from_model, tp_roles
from ..quant.ste import as_dtype, at_least_f32
from .bias import LearnableBias
from .dropout import dropout
from .quantizers import LsqAct, LsqWeight


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, `jax.nn.gelu(approximate=False)`."""
    return torch.nn.functional.gelu(x, approximate="none")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class PReLU(nn.Module):
    """`torch.nn.PReLU()` semantics: one learnable slope `alpha` (shape
    (1,), init 0.25) shared across channels, `where(x >= 0, x, a * x)`
    with `a` in x's dtype."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))
        # the mesh of a sharded MLP: x is this rank's columns
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha if self.tp is None else copy_to_model(
            self.alpha, self.tp)
        a = alpha[0].to(x.dtype)
        return torch.where(x >= 0, x, a * x)


class RPReLU(nn.Module):
    """ReActNet RPReLU: `PReLU(x - move1) + move2` with per-channel shifts
    and slopes (`move1`, `alpha` at 0.25, `move2`), each in x's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.move1 = nn.Parameter(torch.zeros(dim))
        self.alpha = nn.Parameter(torch.full((dim,), 0.25))
        self.move2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x - self.move1.to(x.dtype)
        y = torch.where(xs >= 0, xs, self.alpha.to(x.dtype) * xs)
        return y + self.move2.to(x.dtype)


def make_act(name: str, dim: int):
    """An MLP's activation over `dim` channels by JAX's name: the PReLU or
    RPReLU module (its parameters under `act`) or a function; KeyError
    for an unknown name."""
    if name == "prelu":
        return PReLU()
    if name == "rprelu":
        return RPReLU(dim)
    return {"gelu": gelu, "relu": torch.relu, "None": _identity,
            "identity": _identity}[name]


def int_product(module):
    """The int product a module's int8 branches run: `int8_mm` or, with the
    module's `use_kernels` off, its plain version."""
    return int8_mm if module.use_kernels else int8_mm_reference


class QLinear(nn.Module):
    """StatsQ(weight) + bias->LSQ->bias(input) + matmul + bias.

    `symmetric=False` selects the all-positive input quantizer (post-GELU
    fc2 inputs).  `n_tokens` is the length of the token axis (axis -2 of
    the input), which carries the per-token LSQ scale.  `use_kernels`
    and `calibrating` are set model-wide (see `VisionTransformer`); every
    branch but the composed one is bypassed while calibrating.
    `aq_learnable=False` detaches the input scale on every branch.
    `frozen`/`frozen_int_bits`: see the module docstring.
    """

    def __init__(self, in_features: int, features: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int, symmetric: bool = True,
                 aq_learnable: bool = True,
                 matmul_impl: str | None = None, compute_dtype=None,
                 frozen: bool = False, frozen_int_bits: int | None = None):
        super().__init__()
        if matmul_impl not in (None, "xla", "fused", "pallas", "int8"):
            raise NotImplementedError(
                f"matmul_impl={matmul_impl!r}: the port has the composed "
                "path, 'pallas', 'fused' and 'int8'")
        if (frozen and weight_bits != 32) or (
                frozen_int_bits is not None and not frozen):
            raise ValueError(
                f"frozen={frozen}, weight_bits={weight_bits}, "
                f"frozen_int_bits={frozen_int_bits}: frozen weights are the "
                "32-bit dequantized kernels of an artifact, and only they "
                "take frozen_int_bits")
        compute_dtype = as_dtype(compute_dtype)
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.symmetric = symmetric
        self.matmul_impl = matmul_impl
        self.compute_dtype = compute_dtype
        self.frozen = frozen
        self.frozen_int_bits = frozen_int_bits
        self.use_kernels = True
        self.calibrating = False
        self.tp = None
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        _input_chain(self, in_features, n_tokens, input_bits, symmetric,
                     aq_learnable)
        self.bias = nn.Parameter(torch.zeros(features))
        if self._int_eligible(frozen_int_bits):
            self.kernel_scale = nn.Parameter(torch.ones(1, features))

    def _int_eligible(self, w_bits):
        return w_bits is not None and int8_eligible(
            w_bits, self.input_bits, not self.symmetric)

    def _scale(self):
        s = self.input_quant.s
        s = s if self.input_quant.learnable else s.detach()
        if self.tp is not None and self.tp[0] == "row":
            s = copy_to_model(s, self.tp[1])
        return s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.calibrating:
            y = self._integer_branch(x)
            if y is not None:
                return y + self.bias.to(y.dtype)
        if self.matmul_impl == "fused" and not self.calibrating \
                and not self.frozen and self.weight_bits < 32 \
                and self.input_bits < 32:
            return fused_qlinear(
                x, self.kernel, self._scale(), self.move_b4.bias,
                self.move_aft.bias, self.bias, w_bits=self.weight_bits,
                a_bits=self.input_bits, all_positive=not self.symmetric,
                fwd=(fused_qlinear_fwd if self.use_kernels
                     else fused_qlinear_fwd_reference), tp=self.tp)
        x = _quantize_input(self, x)
        if self.weight_bits >= 32:
            # frozen levels or an unquantized weight: no weight quantizer,
            # the compute-dtype semantics of `statsq_matmul`
            cd, k = self.compute_dtype, self.kernel
            if cd is not None:
                x, k = x.to(cd), k.to(cd)
            acc = at_least_f32(x.dtype)
            row, col = tp_roles(self.tp)
            y = reduce_from_model(torch.matmul(copy_to_model(x.to(acc), col),
                                               k.to(acc)), row)
            y = y if cd is None else y.to(cd)
        else:
            y = statsq_matmul(
                x, self.kernel, self.weight_bits,
                impl="pallas" if self.matmul_impl == "pallas" else "xla",
                compute_dtype=self.compute_dtype,
                fwd=(pallas_statsq_fwd if self.use_kernels
                     else pallas_statsq_fwd_reference), tp=self.tp)
        return y + self.bias.to(y.dtype)

    def _integer_branch(self, x):
        """The frozen integer core or the int8 training branch, without
        the output bias; None where neither applies (frozen fp serving, or
        widths whose codes do not fit int8)."""
        if self.frozen:
            if not self._int_eligible(self.frozen_int_bits):
                return None
            return frozen_int8_forward(
                x, self.kernel, self.kernel_scale, self._scale(),
                self.move_b4.bias, self.move_aft.bias,
                w_bits=self.frozen_int_bits, a_bits=self.input_bits,
                all_positive=not self.symmetric, mm=int_product(self))
        if self.matmul_impl != "int8" or not self._int_eligible(
                self.weight_bits):
            return None
        return int8_qlinear(
            x, self.kernel, self._scale(), self.move_b4.bias,
            self.move_aft.bias, self.weight_bits, self.input_bits,
            not self.symmetric, mm=int_product(self), tp=self.tp)


def _input_chain(mod, in_features, n_tokens, input_bits, symmetric,
                 aq_learnable):
    """The input quantizer's modules (move_b4, input_quant, move_aft); none
    at 32 bits or more (an unquantized input, as in JAX)."""
    if input_bits >= 32:
        mod.move_b4 = mod.input_quant = mod.move_aft = None
        return
    mod.move_b4 = LearnableBias(in_features)
    mod.input_quant = LsqAct(input_bits, n_tokens, all_positive=not symmetric,
                             channel_axis=-2, learnable=aq_learnable)
    mod.move_aft = LearnableBias(in_features)


def _quantize_input(mod, x):
    if mod.input_quant is None:
        return x
    return mod.move_aft(mod.input_quant(mod.move_b4(x)))


class LsqLinear(nn.Module):
    """Full-LSQ linear (`ofq_tpu.nn.linear.LsqLinear`): bias -> LSQ -> bias
    on the input, `weight_quant` (`LsqWeight`, per output column unless
    `weight_per_channel=False`; unsigned with `wq_all_positive`) on the
    kernel, `x @ wq + bias` in the promoted dtype.  `weight_bits` 32 is a
    frozen artifact's kernel (its levels already applied); with
    `frozen_int_bits` the layer keeps the restored `weight_quant.s` and
    runs the integer core on the codes it gives."""

    def __init__(self, in_features: int, features: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int, symmetric: bool = True,
                 aq_learnable: bool = True, wq_learnable: bool = True,
                 weight_per_channel: bool = True,
                 wq_all_positive: bool = False,
                 frozen_int_bits: int | None = None):
        super().__init__()
        self.input_bits = input_bits
        self.symmetric = symmetric
        self.wq_all_positive = wq_all_positive
        self.frozen_int_bits = frozen_int_bits
        self.use_kernels = True
        self.calibrating = False
        self.tp = None
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        _input_chain(self, in_features, n_tokens, input_bits, symmetric,
                     aq_learnable)
        # the integer core's branch declares the restored scale, per column
        # (its quantizer, idempotent on the restored levels, runs when the
        # integer core is switched off)
        frozen_int = self._frozen_int()
        self.weight_quant = LsqWeight(
            frozen_int_bits if frozen_int else weight_bits, features,
            learnable=wq_learnable, all_positive=wq_all_positive,
            per_channel=weight_per_channel or frozen_int)
        self.bias = nn.Parameter(torch.zeros(features))

    def _frozen_int(self) -> bool:
        return (self.frozen_int_bits is not None and self.input_bits < 32
                and lsq_int8_eligible(self.frozen_int_bits, self.input_bits,
                                      not self.symmetric,
                                      self.wq_all_positive))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._frozen_int() and not self.calibrating:
            iq = self.input_quant
            y = frozen_lsq_int8_forward(
                x, self.kernel, self.weight_quant.s,
                iq.s if iq.learnable else iq.s.detach(), self.move_b4.bias,
                self.move_aft.bias, a_bits=self.input_bits,
                all_positive=not self.symmetric, mm=int_product(self))
            return y + self.bias.to(y.dtype)
        x = _quantize_input(self, x)
        wq = self.weight_quant(self.kernel)
        dt = torch.promote_types(x.dtype, wq.dtype)
        row, col = tp_roles(self.tp)
        y = reduce_from_model(torch.matmul(copy_to_model(x.to(dt), col),
                                           wq.to(dt)), row)
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
    """fc1 (signed input) -> `act_layer` -> dropout -> fc2 (all-positive
    input) -> dropout; `lsq_weights` takes the full-LSQ pair (`LsqLinear`,
    with `wq_learnable` and `wq_all_positive`)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, n_tokens: int, *, weight_bits: int,
                 input_bits: int, act_layer: str = "gelu",
                 aq_learnable: bool = True,
                 matmul_impl: str | None = None, compute_dtype=None,
                 frozen: bool = False, frozen_int_bits: int | None = None,
                 dropout_rate: float = 0.0, lsq_weights: bool = False,
                 wq_learnable: bool = True, wq_all_positive: bool = False):
        super().__init__()
        self.act = make_act(act_layer, hidden_features)
        self.dropout_rate = dropout_rate
        self.tp = None
        kw = dict(weight_bits=weight_bits, input_bits=input_bits,
                  aq_learnable=aq_learnable, frozen_int_bits=frozen_int_bits)
        if lsq_weights:
            cls = LsqLinear
            kw.update(wq_learnable=wq_learnable,
                      wq_all_positive=wq_all_positive)
        else:
            cls = QLinear
            kw.update(matmul_impl=matmul_impl, compute_dtype=compute_dtype,
                      frozen=frozen)
        self.fc1 = cls(in_features, hidden_features, n_tokens,
                       symmetric=True, **kw)
        self.fc2 = cls(hidden_features, out_features, n_tokens,
                       symmetric=False, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return _mlp(self, x, generator)


def _mlp(mod, x, generator):
    """fc1 -> the activation -> dropout -> fc2 -> dropout
    (`ofq_tpu.nn.linear.Mlp`, `QMlp`); a sharded MLP's hidden mask is cut
    to its columns."""
    kw = dict(train=mod.training)
    tp = getattr(mod, "tp", None)
    x = dropout(mod.act(mod.fc1(x)), mod.dropout_rate, generator,
                shard=None if tp is None else (-1, tp), **kw)
    return dropout(mod.fc2(x), mod.dropout_rate, generator, **kw)


class Dense(nn.Module):
    """Flax `nn.Dense`: `x @ kernel + bias`, kernel `(in, out)`, in the
    promoted dtype of x and the parameters (Flax's `promote_dtype`: a bf16
    teacher's bf16 stream stays bf16, its fp32 head input stays fp32)."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        row, col = tp_roles(self.tp)
        y = reduce_from_model(torch.matmul(copy_to_model(x.to(dt), col),
                                           self.kernel.to(dt)), row)
        return y if self.bias is None else y + self.bias.to(dt)


class Mlp(nn.Module):
    """Float transformer MLP: fc1 -> `act_layer` -> dropout -> fc2 ->
    dropout.  The models build it with GELU whatever the policy's
    `act_layer` (the float teacher and unquantized sites), as JAX's do."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, act_layer: str = "gelu",
                 dropout_rate: float = 0.0):
        super().__init__()
        self.act = make_act(act_layer, hidden_features)
        self.dropout_rate = dropout_rate
        self.tp = None
        self.fc1 = Dense(in_features, hidden_features)
        self.fc2 = Dense(hidden_features, out_features)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return _mlp(self, x, generator)
