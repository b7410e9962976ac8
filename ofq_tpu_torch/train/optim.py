"""AdamW with the JAX package's no-weight-decay mask (port of
`ofq_tpu/train/optim.py:24-40, 137-170`, without gradient clipping).

`make_optimizer` repeats `optax.adamw`'s arithmetic, leaf by leaf, over a
dict of named parameters (the Flax tree paths with '.' for '/'):

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g^2 + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u     = u + weight_decay * p                  where wd_mask(p)
    u     = -lr(count before the increment) * u

The learning rate is the schedule's float32 value, as optax casts it.  The
caller adds `u` to the parameter in at least fp32 (`loop.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

_NO_DECAY_NAMES = ("pos_embed", "cls_token", "dist_token")


def wd_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """True where weight decay applies: parameters of 2 or more dimensions
    outside the no-decay set, except those named `bias` or `s` (LSQ
    scales, the 2-D image bias)."""
    out = {}
    for name, p in params.items():
        parts = name.split(".")
        out[name] = (not any(n in _NO_DECAY_NAMES for n in parts)
                     and parts[-1] not in ("bias", "s") and p.ndim >= 2)
    return out


def _moment_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


@dataclasses.dataclass
class AdamWState:
    """optax's `ScaleByAdamState`: the update count and the moments, by
    parameter name, in at least fp32."""
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_schedule: Callable[[int], float]
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {n: torch.zeros_like(p, dtype=_moment_dtype(p.dtype))
                 for n, p in params.items()}
        return AdamWState(
            count=0, mu=zeros,
            nu={n: torch.zeros_like(z) for n, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor]
               ) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """(updates, new state) for `grads` and `params` in >= fp32; the
        moment tensors are replaced, not written in place.  Each line is
        one elementwise step of optax's, over every tensor at once
        (`torch._foreach_*`: a few launches per step on the card, not a
        few per parameter)."""
        names = list(grads)
        g = [grads[n] for n in names]
        lr = self.lr_schedule(state.count)
        count = state.count + 1
        m = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                               torch._foreach_mul([state.mu[n] for n in names],
                                                  self.b1))
        v = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul([state.nu[n] for n in names], self.b2))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(v, 1 - self.b2 ** count)), self.eps)
        u = list(torch._foreach_div(
            torch._foreach_div(m, 1 - self.b1 ** count), den))
        decay = wd_mask(params)
        dec = [i for i, n in enumerate(names) if decay[n]]
        if dec:
            u_dec = torch._foreach_add(
                [u[i] for i in dec],
                torch._foreach_mul([params[names[i]] for i in dec],
                                   self.weight_decay))
            for i, t in zip(dec, u_dec):
                u[i] = t
        updates = dict(zip(names, torch._foreach_mul(u, -lr)))
        return updates, AdamWState(count=count, mu=dict(zip(names, m)),
                                   nu=dict(zip(names, v)))


def make_optimizer(lr_schedule: Callable[[int], float], *,
                   weight_decay: float = 0.05,
                   betas: tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, clip_grad=None) -> AdamW:
    """AdamW as `ofq_tpu.train.make_optimizer` builds it; gradient clipping
    is not in the port yet."""
    if clip_grad is not None:
        raise NotImplementedError(
            "gradient clipping (norm, value, AGC) is not in the port yet "
            "(ROADMAP.md, Queue 1)")
    return AdamW(lr_schedule, weight_decay=weight_decay, b1=betas[0],
                 b2=betas[1], eps=eps)
