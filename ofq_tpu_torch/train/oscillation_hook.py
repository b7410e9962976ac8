"""Per-kernel oscillation tracking in the train step (port of
`ofq_tpu/train/oscillation_hook.py:29-108`).

The integer images of the StatsQ-quantized kernels that CGA selects
(`cga.is_cga_kernel`) are tracked as explicit state beside the train state
(`TrainState.extra["oscillation"]`, by parameter name), updated on the
device after the optimizer step and summarised as `oscillation/ema_mean`;
no host synchronisation.  With `freeze_threshold > 0` a frozen weight is
pinned to the dequantized value of its frozen integer.

The image is the pre-offset mid-rise integer `round(clip(w/s) * n -
0.5)` of `quant/statsq.py:statsq_b4_round`, the one the StatsQ forward
rounds (half to even), in >= fp32, so it stays exact under bf16 masters.

Under tensor parallelism (`layout`, the state's `parallel.Layout`) each
tracked kernel's state holds this rank's slice; a row-parallel kernel's
image and pinned values take the whole kernel's StatsQ scale, and
`ema_mean` sums the slices' entries over the model group, the whole
kernels' once.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from ..quant.oscillation import (OscillationState, init_oscillation_state,
                                 track_oscillation)
from ..parallel.tensor import model_sum
from ..quant.statsq import statsq_b4_round, statsq_scale
from .cga import is_cga_kernel


def _row_mesh(layout, name):
    """The model group of a row-parallel kernel's rows, else None."""
    cut = None if layout is None else layout.cuts.get(name)
    return layout.mesh if cut is not None and cut.row_parallel else None


def weight_int_image(w: torch.Tensor, bits: int, mesh=None) -> torch.Tensor:
    """The >= fp32 mid-rise integer image of a kernel (`mesh`: its rows
    are cut over that model group, the scale is the whole kernel's)."""
    b4_round, _ = statsq_b4_round(w, bits, mesh=mesh)
    return torch.round(b4_round)


def _tracked(params: Mapping[str, torch.Tensor], *, qk_reparam: bool,
             model_type: str):
    return [(n, w) for n, w in params.items()
            if is_cga_kernel(n, qk_reparam=qk_reparam,
                             model_type=model_type)]


def init_oscillation_states(params: Mapping[str, torch.Tensor], *,
                            bits: int, qk_reparam: bool = False,
                            model_type: str = "deit", layout=None
                            ) -> dict[str, OscillationState]:
    """name -> the state at step 0 of every tracked kernel (`layout`: the
    module docstring)."""
    with torch.no_grad():
        return {n: init_oscillation_state(
                    weight_int_image(w, bits, _row_mesh(layout, n)))
                for n, w in _tracked(params, qk_reparam=qk_reparam,
                                     model_type=model_type)}


def update_oscillation_states(
        params: Mapping[str, torch.Tensor],
        states: Mapping[str, OscillationState], *, bits: int,
        momentum: float = 0.01, freeze_threshold: float = 0.0,
        qk_reparam: bool = False, model_type: str = "deit", layout=None
) -> tuple[dict[str, OscillationState], dict[str, torch.Tensor]]:
    """One tracking step over the tracked kernels that have a state: (the
    new states, {"oscillation/ema_mean": the mean EMA over all their
    entries}); `layout`: the module docstring."""
    new_states = dict(states)
    total, sliced, count = 0.0, 0.0, 0
    with torch.no_grad():
        for n, w in _tracked(params, qk_reparam=qk_reparam,
                             model_type=model_type):
            if n not in states:
                continue
            _, st = track_oscillation(
                weight_int_image(w.detach(), bits, _row_mesh(layout, n)),
                states[n], momentum=momentum,
                freeze_threshold=freeze_threshold)
            new_states[n] = st
            cut = None if layout is None else layout.cuts.get(n)
            if cut is None:
                total = total + torch.sum(st.ema_oscillation)
                count += st.ema_oscillation.numel()
            else:
                sliced = sliced + torch.sum(st.ema_oscillation)
                count += math.prod(cut.shape)
        if torch.is_tensor(sliced):
            total = total + model_sum(sliced, layout.mesh)
    return new_states, {"oscillation/ema_mean": total / max(count, 1)}


def apply_frozen(old_params, new_params: Mapping[str, torch.Tensor],
                 states: Mapping[str, OscillationState], *, bits: int,
                 qk_reparam: bool = False, model_type: str = "deit",
                 layout=None) -> dict[str, torch.Tensor]:
    """`new_params` with every frozen entry of a tracked kernel pinned to
    `s * ((frozen_x_int + 0.5) / n)`, s the fp32 StatsQ scale of the new
    kernel (fp32 even for fp64 masters, as in JAX), cast back to the
    kernel's dtype, so its StatsQ image is the frozen integer.  Untracked
    parameters come back as they are.  `old_params` is unused (JAX's
    signature); `layout`: the module docstring."""
    del old_params
    n = float(2 ** (bits - 1))
    out = dict(new_params)
    with torch.no_grad():
        for name, w in _tracked(new_params, qk_reparam=qk_reparam,
                                model_type=model_type):
            st = states.get(name)
            if st is None:
                continue
            s = statsq_scale(w.to(torch.float32), mesh=_row_mesh(layout,
                                                                 name))
            pinned = (s * ((st.frozen_x_int + 0.5) / n)).to(w.dtype)
            out[name] = torch.where(st.frozen, pinned, w)
    return out
