"""Learning-rate schedules (port of `ofq_tpu/train/schedule.py`): cosine
with linear warmup and a constant cooldown, a function of the step count
(the JAX package's epoch index), computed in float32 as JAX does; and the
constant rate of the CGA finetune, pinned at `min_lr`.

  * t >= epochs:           min_lr
  * t < warmup_epochs:     warmup_lr + (base_lr - warmup_lr) * t / warmup
  * otherwise:             min_lr + (base_lr - min_lr) * (1 + cos(pi t / epochs)) / 2
"""

from __future__ import annotations

import math

import torch


def cosine_with_warmup_cooldown(base_lr: float, *, epochs: int,
                                warmup_epochs: int = 0,
                                warmup_lr: float = 1e-6,
                                min_lr: float = 1e-5):
    """Returns lr(count) -> a Python float holding the float32 value."""

    def lr_fn(count) -> float:
        t = torch.tensor(float(count), dtype=torch.float32)
        if t >= epochs:
            lr = torch.tensor(min_lr, dtype=torch.float32)
        elif t < warmup_epochs:
            lr = warmup_lr + (base_lr - warmup_lr) * t / max(warmup_epochs, 1)
        else:
            lr = min_lr + 0.5 * (base_lr - min_lr) * (
                1.0 + torch.cos(math.pi * t / epochs))
        return float(lr)

    return lr_fn


def constant_lr(value: float):
    """Returns lr(count) -> `value` as a float32, whatever the count."""
    lr = float(torch.tensor(value, dtype=torch.float32))

    def lr_fn(count) -> float:
        return lr

    return lr_fn
