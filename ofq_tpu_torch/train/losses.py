"""Distillation and classification losses (port of
`ofq_tpu/train/losses.py:17-151`): pure functions of the student's outputs,
the targets and the teacher's outputs (logits, the attentions' Gram
telemetry, the token features); and the oscillation-dampening regularizer
on the StatsQ kernels.

Over a mesh (`mesh`, `layout`) the direction matching is the global
batch's: a layer's three squared sums (the student's, the teacher's and
their normalized difference's) are summed over the data group
(`collectives.reduce_from_data`: forward a sum, backward the identity,
so each rank's rows take their share of the global term's gradient) and,
for a cut attention, whose Grams hold the rank's heads (the whole
teacher's cut to them), over the model group too (`reduce_from_model`);
the student's norm, which every rank's slice and rows read, sums its
cotangent back over the same groups (`copy_to_model`, `copy_to_data`).
An attention left whole counts once on a model group.  Every rank holds
the same global term; the train step weighs its gradient by the data
group's size (`train/loop.py`).  The dampening term sums the sliced kernels' terms over the group
in one such reduction (a row-parallel kernel at the whole kernel's
StatsQ scale) and adds the whole kernels' once.  The logits and the
token features (`kd_token`) are whole on every rank.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..parallel.collectives import copy_to_data, reduce_from_data
from ..parallel.tensor import copy_to_model, reduce_from_model
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


def _spread_normed_l2_distance(a, b, model, data) -> torch.Tensor:
    """`_normed_l2_distance` of two tensors spread over the mesh: their
    head axis (1) cut over `model`'s group (None: whole), their rows over
    `data`'s (None: one process).  Each squared sum is summed over both
    groups; ||a|| feeds every rank's part of the difference, so its
    cotangent (each rank's share) is summed over both too."""
    def total(t):
        return reduce_from_data(reduce_from_model(torch.sum(t * t), model),
                                data)

    na = copy_to_data(copy_to_model(torch.sqrt(total(a)), model), data)
    nb = torch.sqrt(total(b))
    return torch.sqrt(total(a / na - b / nb))


def direction_matching(student_scores: Sequence[torch.Tensor],
                       teacher_scores: Sequence[torch.Tensor],
                       mesh=None) -> torch.Tensor:
    """The normalized L2 distances summed over layers, entries <= -100
    (masked scores) set to 0 on both sides.  With `mesh`, the scores are
    this rank's rows of the global batch's, and a student's (B, H, ...)
    Gram of fewer heads than the teacher's is this rank's heads of a cut
    attention (module docstring)."""
    data = mesh if mesh is not None and mesh.data_world > 1 else None
    total = 0.0
    for s, t in zip(student_scores, teacher_scores):
        cut = mesh is not None and s.shape[1] != t.shape[1]
        if cut:
            h = s.shape[1]
            t = t.narrow(1, mesh.model_index * h, h)
        s = torch.where(s <= -1e2, torch.zeros_like(s), s)
        t = torch.where(t <= -1e2, torch.zeros_like(t), t)
        total = total + (
            _spread_normed_l2_distance(s, t, mesh if cut else None, data)
            if cut or data is not None else _normed_l2_distance(s, t))
    return total


def gram_matching(student_attn_info, teacher_attn_info,
                  include_v: bool = False, mesh=None) -> torch.Tensor:
    """The direction matching of the q and k (and with `include_v` the v)
    Grams of a per-layer info (attn, q q^T, k k^T, v v^T); `mesh` as
    `direction_matching`'s."""
    parts = (1, 2, 3) if include_v else (1, 2)
    extra = 0.0
    for i in parts:
        extra = extra + direction_matching(
            [info[i] for info in student_attn_info],
            [info[i] for info in teacher_attn_info], mesh)
    return extra


def kd_soft_hard_qk(student_out, student_attn_info, hard_target,
                    teacher_logits, teacher_attn_info,
                    include_v: bool = False, mesh=None) -> torch.Tensor:
    """`kd_soft_and_hard` plus `gram_matching`."""
    return kd_soft_and_hard(student_out, hard_target, teacher_logits) + (
        gram_matching(student_attn_info, teacher_attn_info, include_v, mesh))


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
                   weighting: float = 0.0, layout=None) -> torch.Tensor:
    """`weighting * sum((sg(statsq_quantize(w)) - clip(w, -s, s(1 - 1e-6)))^2)`
    over the `kernel`s of fc1, fc2, qkv and proj, by parameter name; 0 when
    `weighting` is 0.  The scale s is detached, so the gradient flows only
    through the clipped passthrough (JAX's `jnp.clip`: half at a bound).
    `layout`: `params` are a sharded model's (module docstring)."""
    if weighting == 0.0:
        return torch.zeros(())
    whole, sliced = 0.0, 0.0
    for name, w in params.items():
        parts = name.split(".")
        if parts[-1] == "kernel" and any(n in _DAMPENED for n in parts):
            cut = None if layout is None else layout.cuts.get(name)
            row = layout.mesh if cut is not None and cut.row_parallel \
                else None
            wq = statsq_quantize(w, bits, mesh=row).detach()
            s = statsq_scale(w, mesh=row)
            term = torch.sum(
                (wq - _clip(w, -s, s * (1.0 - _CLIP_HI_EPS))) ** 2)
            if cut is None:
                whole = whole + term
            else:
                sliced = sliced + term
    if torch.is_tensor(sliced):
        whole = whole + reduce_from_model(sliced, layout.mesh)
    return weighting * whole
