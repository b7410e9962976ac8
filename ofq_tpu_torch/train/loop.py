"""The QAT train step (port of `ofq_tpu/train/loop.py:25-188`).

One step: the student forward in train mode (distilled: `(cls, dist)`
logits; the image quantizer's sticky sign updates), the float teacher
forward in eval mode under `torch.no_grad()`, the loss, the backward
through every STE and kernel, AdamW, and the update added in place to
each parameter (fp32 or fp64, as JAX adds it in at least fp32).  Eager PyTorch, no host synchronisation: the
metrics come back as device tensors.

Not in the port yet, and refused: EMA, CGA, the oscillation hook, the
dampening loss, token/q-k distillation, bf16 master weights.  The step
draws no random numbers (dropout and drop-path are refused by the model).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.registry import resolve_device
from .losses import hard_ce, kd_soft_and_hard, soft_ce
from .optim import AdamW
from .state import TrainState

LOSS_KINDS = ("ce", "kd_soft", "kd_soft_hard")


def global_norm(grads) -> torch.Tensor:
    """optax.global_norm: the L2 norm of every leaf's entries together."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(grads))))


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def make_train_step(model: torch.nn.Module, optimizer: AdamW, *,
                    teacher: Optional[torch.nn.Module] = None,
                    loss_kind: str = "kd_soft_hard",
                    label_smoothing: float = 0.0, device="cuda",
                    ema_decay=None, cga=None, oscillation=None,
                    dampening=None, master_dtype=None) -> Callable:
    """Build `train_step(state, batch) -> (state, metrics)`.

    `batch` is {"image": (B, H, W, 3) NHWC, "label": (B,) class ids}, as
    numpy arrays or tensors; `metrics` holds `loss` and `grad_norm`.
    Runs on CUDA unless `device="cpu"`; the model (and teacher) must
    already live there.
    """
    if loss_kind not in LOSS_KINDS:
        raise NotImplementedError(
            f"loss_kind={loss_kind!r}: the port has {LOSS_KINDS} "
            "(ROADMAP.md, Queue 1)")
    for name, value in (("ema_decay", ema_decay), ("cga", cga),
                        ("oscillation", oscillation),
                        ("dampening", dampening),
                        ("master_dtype", master_dtype)):
        if value is not None:
            raise NotImplementedError(
                f"{name} is not in the port yet (ROADMAP.md, Queue 1)")
    if loss_kind != "ce" and teacher is None:
        raise ValueError(f"loss_kind={loss_kind!r} needs a teacher")
    dev = resolve_device(device)
    if any(p.dtype not in (torch.float32, torch.float64)
           for p in model.parameters()):
        raise NotImplementedError(
            "parameters in fp32 or fp64 only; bf16 master weights are not "
            "in the port yet (ROADMAP.md, Queue 1)")
    p0 = next(model.parameters())
    if p0.device.type != dev.type:
        raise ValueError(f"the model lives on {p0.device}, not on {dev}")

    def loss_fn(x, label):
        out = model(x)
        if loss_kind == "ce":
            return hard_ce(_first(out), label, label_smoothing)
        with torch.no_grad():
            t_logits = _first(teacher(x))
        if loss_kind == "kd_soft":
            return soft_ce(_first(out), t_logits)
        return kd_soft_and_hard(out, label, t_logits)

    def train_step(state: TrainState, batch):
        model.train()
        if teacher is not None:
            teacher.eval()
        x = torch.as_tensor(np.asarray(batch["image"])
                            if not torch.is_tensor(batch["image"])
                            else batch["image"]).to(p0.device, p0.dtype)
        label = torch.as_tensor(np.asarray(batch["label"])
                                if not torch.is_tensor(batch["label"])
                                else batch["label"]).to(p0.device)
        names = list(state.params)
        tensors = [state.params[n] for n in names]
        loss = loss_fn(x, label)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        # a parameter the loss does not reach (a detached scale) has a
        # zero gradient, as under jax.grad
        grads = {n: torch.zeros_like(t) if g is None else g
                 for n, t, g in zip(names, tensors, grads)}
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
            # parameters are fp32 or fp64: the >= fp32 add is in place
            torch._foreach_add_(tensors, [updates[n] for n in names])
        state.opt_state = opt_state
        state.step += 1
        metrics = {"loss": loss.detach(),
                   "grad_norm": global_norm(grads.values())}
        return state, metrics

    return train_step
