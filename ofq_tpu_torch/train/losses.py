"""Distillation and classification losses (port of
`ofq_tpu/train/losses.py:17-151`): pure functions of the student's outputs,
the targets and the teacher's outputs (logits, the attentions' Gram
telemetry, the token features); and the oscillation-dampening regularizer
on the StatsQ kernels."""

from __future__ import annotations

from typing import Mapping, Sequence

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


def _normed_l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a / ||a|| - b / ||b|| ||_2 over all elements."""
    a = a / torch.linalg.vector_norm(a)
    b = b / torch.linalg.vector_norm(b)
    return torch.linalg.vector_norm(a - b)


def direction_matching(student_scores: Sequence[torch.Tensor],
                       teacher_scores: Sequence[torch.Tensor]
                       ) -> torch.Tensor:
    """The normalized L2 distances summed over layers, entries <= -100
    (masked scores) set to 0 on both sides."""
    total = 0.0
    for s, t in zip(student_scores, teacher_scores):
        s = torch.where(s <= -1e2, torch.zeros_like(s), s)
        t = torch.where(t <= -1e2, torch.zeros_like(t), t)
        total = total + _normed_l2_distance(s, t)
    return total


def kd_soft_hard_qk(student_out, student_attn_info, hard_target,
                    teacher_logits, teacher_attn_info,
                    include_v: bool = False) -> torch.Tensor:
    """`kd_soft_and_hard` plus the direction matching of the q and k (and
    with `include_v` the v) Grams; an info is a per-layer tuple (attn,
    q q^T, k k^T, v v^T)."""
    base = kd_soft_and_hard(student_out, hard_target, teacher_logits)
    parts = (1, 2, 3) if include_v else (1, 2)
    extra = 0.0
    for i in parts:
        extra = extra + direction_matching(
            [info[i] for info in student_attn_info],
            [info[i] for info in teacher_attn_info])
    return base + extra


def kl_token_mse(student_logits, student_tokens, teacher_logits,
                 teacher_tokens, alpha: float = 0.5,
                 kd_type: str = "last") -> torch.Tensor:
    """Soft KD plus `alpha` times the MSE of the token features, of the
    last block ('last') or averaged over all blocks ('all'); the student's
    extra leading tokens are cut to the teacher's N."""
    kl = soft_ce(student_logits, teacher_logits)
    if kd_type == "last":
        s = (student_tokens[-1] if isinstance(student_tokens, (list, tuple))
             else student_tokens)
        t = (teacher_tokens[-1] if isinstance(teacher_tokens, (list, tuple))
             else teacher_tokens)
        mse = torch.mean((s[:, -t.shape[1]:] - t) ** 2)
    elif kd_type == "all":
        if len(student_tokens) != len(teacher_tokens):
            raise ValueError("kd_type='all' needs as many student blocks as "
                             "teacher blocks")
        mse = 0.0
        for s, t in zip(student_tokens, teacher_tokens):
            mse = mse + torch.mean((s[:, -t.shape[1]:] - t) ** 2)
        mse = mse / len(student_tokens)
    else:
        raise NotImplementedError(kd_type)
    return kl + alpha * mse


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
