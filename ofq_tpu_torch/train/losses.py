"""Distillation and classification losses (port of
`ofq_tpu/train/losses.py:17-58`): pure functions of the student's outputs,
the targets and the teacher's logits; and the oscillation-dampening
regularizer on the StatsQ kernels (`:131-151`)."""

from __future__ import annotations

from typing import Mapping

import torch

from ..quant.lsq import _clip
from ..quant.statsq import _CLIP_HI_EPS, statsq_quantize, statsq_scale

_DAMPENED = ("fc1", "fc2", "qkv", "proj")


def soft_ce(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """Cross-entropy between the student's logits and the teacher's
    softmax, averaged over the batch."""
    s = student_logits / temperature
    t = teacher_logits / temperature
    t_prob = torch.softmax(t, dim=-1)
    s_logprob = torch.log_softmax(s, dim=-1)
    return -torch.mean(torch.sum(t_prob * s_logprob, dim=-1))


def hard_ce(logits: torch.Tensor, target: torch.Tensor,
            label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy with integer class targets (optionally label-smoothed)
    or soft targets of the logits' shape."""
    logprob = torch.log_softmax(logits, dim=-1)
    if target.ndim == logits.ndim:
        return torch.mean(-torch.sum(target * logprob, dim=-1))
    nll = -torch.gather(logprob, -1, target[..., None].long())[..., 0]
    if label_smoothing > 0:
        smooth = -torch.mean(logprob, dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    return torch.mean(nll)


def kd_soft_and_hard(student_out, hard_target: torch.Tensor,
                     teacher_logits: torch.Tensor) -> torch.Tensor:
    """Soft KD on the distillation head plus hard CE on the class head; a
    distilled student passes `(cls_logits, dist_logits)`."""
    if isinstance(student_out, tuple):
        cls_out, dist_out = student_out
        return soft_ce(dist_out, teacher_logits) + hard_ce(cls_out,
                                                           hard_target)
    return (soft_ce(student_out, teacher_logits)
            + hard_ce(student_out, hard_target))


def dampening_loss(params: Mapping[str, torch.Tensor], bits: int,
                   weighting: float = 0.0) -> torch.Tensor:
    """`weighting * sum((sg(statsq_quantize(w)) - clip(w, -s, s(1 - 1e-6)))^2)`
    over the `kernel`s of fc1, fc2, qkv and proj, by parameter name; 0 when
    `weighting` is 0.  The scale s is detached, so the gradient flows only
    through the clipped passthrough (JAX's `jnp.clip`: half at a bound)."""
    if weighting == 0.0:
        return torch.zeros(())
    total = 0.0
    for name, w in params.items():
        parts = name.split(".")
        if parts[-1] == "kernel" and any(n in _DAMPENED for n in parts):
            wq = statsq_quantize(w, bits).detach()
            s = statsq_scale(w)
            total = total + torch.sum(
                (wq - _clip(w, -s, s * (1.0 - _CLIP_HI_EPS))) ** 2)
    return weighting * total
