"""Train state (port of `ofq_tpu/train/state.py`): the model's parameters
by name, the AdamW state and the step count.

`params` holds the model's own parameter tensors, not copies: a train
step updates them in place (and the image quantizer's `signed` buffer in
the model), where JAX returns a new tree.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import AdamW, AdamWState


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.nn.Parameter]
    opt_state: AdamWState
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: AdamW) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(params=params, opt_state=optimizer.init(params), step=0)
