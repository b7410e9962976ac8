"""Oscillation tracking in the integer domain (port of
`ofq_tpu/quant/oscillation.py:25-103`).

The state is an explicit `OscillationState` of tensors, updated by a pure
function: with `delta = round(prev_int - int)` and its sign the switch
direction, a weight oscillated where the previous switch direction times
this one is -1; the EMA of that indicator runs with `momentum`, and with
`freeze_threshold > 0` a weight whose EMA passes the threshold is pinned to
`round(ema_x_int)` (or, without `use_ema_x_int`, to its current value).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class OscillationState(NamedTuple):
    prev_x_int: torch.Tensor
    prev_switch_dir: torch.Tensor
    ema_oscillation: torch.Tensor
    total_oscillation: torch.Tensor
    ema_x_int: torch.Tensor
    frozen: torch.Tensor        # bool mask
    frozen_x_int: torch.Tensor
    iters: torch.Tensor         # scalar int32


def init_oscillation_state(x_int: torch.Tensor) -> OscillationState:
    x_int = x_int.detach()
    z = torch.zeros_like(x_int)
    return OscillationState(
        prev_x_int=x_int, prev_switch_dir=z, ema_oscillation=z,
        total_oscillation=z, ema_x_int=x_int,
        frozen=torch.zeros(x_int.shape, dtype=torch.bool,
                           device=x_int.device),
        frozen_x_int=z,
        iters=torch.zeros((), dtype=torch.int32, device=x_int.device))


def track_oscillation(x_int: torch.Tensor, state: OscillationState, *,
                      momentum: float = 0.01, freeze_threshold: float = 0.0,
                      use_ema_x_int: bool = True
                      ) -> tuple[torch.Tensor, OscillationState]:
    """One tracking step: (the codes with the frozen ones pinned, the new
    state)."""
    x_int = torch.where(state.frozen, state.frozen_x_int, x_int)
    x_det = x_int.detach()
    delta = torch.round(state.prev_x_int - x_det)
    switch_dir = torch.sign(delta)
    switched = delta != 0
    oscillated = ((state.prev_switch_dir * switch_dir) == -1).to(x_det.dtype)
    ema_osc = momentum * oscillated + (1 - momentum) * state.ema_oscillation
    prev_switch_dir = torch.where(switched, switch_dir,
                                  state.prev_switch_dir)
    total = state.total_oscillation + oscillated
    frozen, frozen_x_int = state.frozen, state.frozen_x_int
    ema_x_int = state.ema_x_int
    if freeze_threshold > 0:
        newly = ema_osc > freeze_threshold
        frozen = frozen | newly
        if use_ema_x_int:
            frozen_x_int = torch.where(newly, torch.round(state.ema_x_int),
                                       frozen_x_int)
            ema_x_int = momentum * x_det + (1 - momentum) * state.ema_x_int
        else:
            frozen_x_int = torch.where(newly, x_det, frozen_x_int)
    return x_int, OscillationState(
        prev_x_int=x_det, prev_switch_dir=prev_switch_dir,
        ema_oscillation=ema_osc, total_oscillation=total,
        ema_x_int=ema_x_int, frozen=frozen, frozen_x_int=frozen_x_int,
        iters=state.iters + 1)


def oscillation_metrics(state: OscillationState) -> dict[str, torch.Tensor]:
    """Scalar telemetry of a state, as device tensors."""
    return {"oscillation/ema_mean": torch.mean(state.ema_oscillation),
            "oscillation/ema_max": torch.max(state.ema_oscillation),
            "oscillation/total_frozen": torch.sum(state.frozen),
            "oscillation/iters": state.iters}
