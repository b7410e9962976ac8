"""Straight-through-estimator primitives (port of `ofq_tpu/quant/ste.py`).

Each function computes exactly the JAX expression, `stop_gradient` becoming
`.detach()`, so forward values agree bit for bit (e.g. `passthrough` returns
`x + (target - x)`, which can differ from `target` by an ulp) and the
gradient identities are ready for the training slice.
"""

from __future__ import annotations

import functools

import torch


def round_pass(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, identity gradient."""
    return x + (torch.round(x) - x).detach()


def grad_scale(x: torch.Tensor, scale) -> torch.Tensor:
    """Identity forward; gradient multiplied by `scale`."""
    return x * scale + (x - x * scale).detach()


def clip_lower(x: torch.Tensor, eps) -> torch.Tensor:
    """Forward `where(x > eps, x, eps)`, identity gradient."""
    clipped = torch.where(x > eps, x, torch.full_like(x, eps))
    return x + (clipped - x).detach()


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """Promote, never demote: the quantizer-math dtype."""
    return torch.promote_types(dtype, torch.float32)


def as_dtype(dtype) -> torch.dtype | None:
    """A compute dtype given as JAX names it ('bfloat16') or as a torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of `dtype` (a weakly
    typed constant): rounded to that dtype first.  torch would multiply a
    bf16 tensor by the scalar in fp32, e.g. by 8 ** -0.5 instead of its
    bf16 value 0.353515625.  Cached: the attention forwards ask for the
    same few values on every call."""
    return float(torch.tensor(value, dtype=dtype))


def passthrough(target: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward `target`, gradient flows to `x` with identity Jacobian."""
    return x + (target - x).detach()


def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on these tensors: grad mode on and
    one of them requires grad.  The custom-VJP Functions are applied only
    then; otherwise their forward runs directly (the same values), which
    keeps the autograd machinery off the serving path."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
