"""Straight-through-estimator primitives (port of `ofq_tpu/quant/ste.py`).

Each function computes exactly the JAX expression, `stop_gradient` becoming
`.detach()`, so forward values agree bit for bit (e.g. `passthrough` returns
`x + (target - x)`, which can differ from `target` by an ulp) and the
gradient identities are ready for the training slice.
"""

from __future__ import annotations

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


def passthrough(target: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward `target`, gradient flows to `x` with identity Jacobian."""
    return x + (target - x).detach()
