"""AdamW with the JAX package's no-weight-decay mask, gradient clipping
and the EMA (port of `ofq_tpu/train/optim.py`).

`make_optimizer` repeats `optax.adamw`'s arithmetic, leaf by leaf, over a
dict of named parameters (the Flax tree paths with '.' for '/'), after the
optional clipping transform of the chain (`clip_gradients`):

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g^2 + b2 * nu
    count = count + 1
    u     = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u     = u + weight_decay * p                  where wd_mask(p)
    u     = -lr(count before the increment) * u

The learning rate is the schedule's float32 value, as optax casts it.  The
caller adds `u` to the parameter in at least fp32 (`loop.py`).

Under tensor parallelism (`layout`, the state's `parallel.Layout`) the
update is elementwise on the slices; the clipping reads the full
gradients: the global norm over the model group (`Layout.global_norm`),
AGC's unit norms summed over the group where a slice is cut along the
axes a unit spans (a row-parallel kernel's in-axis, a cut 1-D vector, a
bias table's head columns; `Layout.sq_sum`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

_NO_DECAY_NAMES = ("pos_embed", "cls_token", "dist_token")
CLIP_MODES = ("norm", "value", "agc")


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


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the L2 norm of every leaf's entries together."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(grads))))


def unitwise_norm(x: torch.Tensor, keep_axis: int = -1) -> torch.Tensor:
    """The L2 norm per unit along `keep_axis` (the whole tensor's when it
    has at most one dimension), keeping dimensions."""
    if x.ndim <= 1:
        return torch.linalg.vector_norm(x)
    keep = keep_axis % x.ndim
    axes = tuple(a for a in range(x.ndim) if a != keep)
    return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))


def _agc_keep(name: str, t: torch.Tensor):
    """The axis AGC's units keep: a `*kernel` (Flax's (in, out) layout) its
    last, every other parameter axis 0; None for a whole-tensor norm (the
    2-D ImageBias, `bias`, flat in the original; any tensor of at most one
    dimension)."""
    leaf = name.rsplit(".", 1)[-1]
    if t.ndim <= 1 or (leaf == "bias" and t.ndim == 2):
        return None
    return -1 if leaf.endswith("kernel") else 0


def _agc_norm(name: str, t: torch.Tensor, layout=None) -> torch.Tensor:
    """AGC's unit norms of parameter `name` (`_agc_keep`); with `layout`
    those of its full tensor, this rank's units."""
    keep = _agc_keep(name, t)
    if layout is None:
        return (torch.linalg.vector_norm(t) if keep is None
                else unitwise_norm(t, keep_axis=keep))
    dims = None if keep is None else tuple(
        a for a in range(t.ndim) if a != keep % t.ndim)
    return torch.sqrt(layout.sq_sum(name, t, dims, keepdim=keep is not None))


def _agc_skipped(names) -> set[str]:
    """The parameters `adaptive_grad_clip(exclude_head=True)` leaves alone:
    the original's last two parameters of the model, the last head
    module's `move_b4` and `move_aft` when it is quantized, its `kernel`
    and `bias` when it is float."""
    split = [n.split(".") for n in names]
    head = ("head_dist" if any("head_dist" in p for p in split) else "head")
    quantized = any(p[:2] == [head, "move_b4"] for p in split)
    leaves = ("move_b4", "move_aft") if quantized else ("kernel", "bias")
    return {n for n, p in zip(names, split)
            if head in p and any(x in leaves for x in p)}


def adaptive_grad_clip(grads: Mapping[str, torch.Tensor],
                       params: Mapping[str, torch.Tensor],
                       clip_factor: float, eps: float = 1e-3, layout=None
                       ) -> dict[str, torch.Tensor]:
    """AGC with `exclude_head=True`: each unit's gradient clipped to
    clip_factor * max(||p||, eps), `ofq_tpu.train.optim.
    adaptive_grad_clip`'s arithmetic (`layout`: the module docstring)."""
    skip = _agc_skipped(list(grads))
    out = {}
    for n, g in grads.items():
        if n in skip:
            out[n] = g
            continue
        p_norm = torch.clamp_min(_agc_norm(n, params[n], layout),
                                 eps) * clip_factor
        g_norm = _agc_norm(n, g, layout)
        clipped = g * (p_norm / torch.clamp_min(g_norm, 1e-6))
        out[n] = torch.where(g_norm < p_norm, g, clipped)
    return out


def clip_gradients(grads: Mapping[str, torch.Tensor],
                   params: Mapping[str, torch.Tensor], clip_grad: float,
                   clip_mode: str, layout=None) -> dict[str, torch.Tensor]:
    """The chain's first transform: `norm`, optax.clip_by_global_norm
    (`select(||g|| < max, g, g / ||g|| * max)`); `value`, optax.clip;
    `agc`, `adaptive_grad_clip` with clip_grad as its factor (`layout`:
    the module docstring)."""
    if clip_mode == "norm":
        g_norm = (global_norm(grads.values()) if layout is None
                  else layout.global_norm(grads))
        keep = g_norm < clip_grad
        return {n: torch.where(keep, g, (g / g_norm.to(g.dtype)) * clip_grad)
                for n, g in grads.items()}
    if clip_mode == "value":
        return {n: torch.clamp(g, -clip_grad, clip_grad)
                for n, g in grads.items()}
    return adaptive_grad_clip(grads, params, clip_grad, layout=layout)


def ema_update(ema: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor], decay: float = 0.9999
               ) -> dict[str, torch.Tensor]:
    """`decay * e + (1 - decay) * p.float()` by name; the accumulators are
    fp32 whatever the masters' dtype (a bf16 EMA at decay 0.9999 would
    never move)."""
    names = list(ema)
    return dict(zip(names, torch._foreach_add(
        torch._foreach_mul([ema[n] for n in names], decay),
        torch._foreach_mul([params[n].float() for n in names],
                           1.0 - decay))))


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
    clip_grad: Optional[float] = None
    clip_mode: str = "norm"

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = {n: torch.zeros_like(p, dtype=_moment_dtype(p.dtype))
                 for n, p in params.items()}
        return AdamWState(
            count=0, mu=zeros,
            nu={n: torch.zeros_like(z) for n, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Mapping[str, torch.Tensor], layout=None
               ) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """(updates, new state) for `grads` and `params` in >= fp32; the
        moment tensors are replaced, not written in place.  The gradients
        are clipped first when `clip_grad` is set (`layout`: the module
        docstring).  Each line is one
        elementwise step of optax's, over every tensor at once
        (`torch._foreach_*`: a few launches per step on the card, not a
        few per parameter)."""
        if self.clip_grad is not None:
            grads = clip_gradients(grads, params, self.clip_grad,
                                   self.clip_mode, layout)
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
                   eps: float = 1e-8, clip_grad: Optional[float] = None,
                   clip_mode: str = "norm") -> AdamW:
    """AdamW as `ofq_tpu.train.make_optimizer` builds it, with the
    gradients clipped first (`clip_mode` norm, value or agc) when
    `clip_grad` is given."""
    if clip_grad is not None and clip_mode not in CLIP_MODES:
        raise ValueError(f"clip_mode={clip_mode!r}: one of {CLIP_MODES}")
    return AdamW(lr_schedule, weight_decay=weight_decay, b1=betas[0],
                 b2=betas[1], eps=eps, clip_grad=clip_grad,
                 clip_mode=clip_mode)
