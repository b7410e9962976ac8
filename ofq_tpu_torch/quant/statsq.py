"""StatsQ weight fake-quantization (port of `ofq_tpu/quant/statsq.py:31-80`).

Per-output-column scale `s = 2 * mean|W|` (floored at 1e-12), scaled
weights clamped to `[-1, 1 - 1e-6]`, mid-rise levels
`(round(c * n - 0.5) + 0.5) / n` with `n = 2^(b-1)`, straight-through
gradient.  Kernels are in the Flax `(in, out)` layout, so the statistics
reduce over axis 0; the QKR product `W_qk` reduces over axis -1.
"""

from __future__ import annotations

import torch

from .ste import at_least_f32, passthrough

_CLIP_HI_EPS = 1e-6


def statsq_scale(w: torch.Tensor, *, reduce_axis: int = 0) -> torch.Tensor:
    """Detached per-output-channel scale `2 * mean|w|`, at least 1e-12."""
    s = 2.0 * torch.mean(torch.abs(w), dim=reduce_axis, keepdim=True)
    s = torch.clamp_min(s, 1e-12)
    return s.detach()


def statsq_b4_round(w: torch.Tensor, num_bits: int, *,
                    reduce_axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-round image `clip(w/s) * n - 0.5` and its scale, in >= fp32."""
    w32 = w.to(at_least_f32(w.dtype))
    s = statsq_scale(w32, reduce_axis=reduce_axis)
    clipped = torch.clamp(w32 / s, -1.0, 1.0 - _CLIP_HI_EPS)
    n = float(2 ** (num_bits - 1))
    return clipped * n - 0.5, s


def statsq_quantize(w: torch.Tensor, num_bits: int, *,
                    reduce_axis: int = 0) -> torch.Tensor:
    """Fake-quantize a kernel with StatsQ; gradient is the identity."""
    b4_round, s = statsq_b4_round(w, num_bits, reduce_axis=reduce_axis)
    n = float(2 ** (num_bits - 1))
    q = (s * ((torch.round(b4_round) + 0.5) / n)).to(w.dtype)
    return passthrough(q.detach(), w)
