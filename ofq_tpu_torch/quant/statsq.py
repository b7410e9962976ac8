"""StatsQ weight fake-quantization (port of `ofq_tpu/quant/statsq.py:31-95`,
the 4-D variant `statsq_quantize_4d` among it) and CGA's band tests on its
pre-round image (`:98-178`).

Per-output-column scale `s = 2 * mean|W|` (floored at 1e-12), scaled
weights clamped to `[-1, 1 - 1e-6]`, mid-rise levels
`(round(c * n - 0.5) + 0.5) / n` with `n = 2^(b-1)`, straight-through
gradient.  Kernels are in the Flax `(in, out)` layout, so the statistics
reduce over axis 0; the QKR product `W_qk` reduces over axis -1.  A
row-parallel kernel's rows are sharded over the mesh's 'model' axis: with
its `mesh` the scale is the whole kernel's, its rows gathered over the
model group (the single process's bits), and CGA's level range spans the
whole tensor (its min and max reduced over the group).
"""

from __future__ import annotations

import torch

from ..parallel.tensor import gather_rows, model_max, model_min
from .ste import at_least_f32, passthrough

_CLIP_HI_EPS = 1e-6


def statsq_scale(w: torch.Tensor, *, reduce_axis: int = 0,
                 mesh=None) -> torch.Tensor:
    """Detached per-output-channel scale `2 * mean|w|`, at least 1e-12;
    with `mesh`, `w` is this rank's rows of a kernel sharded along
    `reduce_axis` over the model group, and the mean is the whole
    kernel's (`gather_rows`)."""
    if mesh is not None:
        w = gather_rows(w, mesh, reduce_axis)
    s = 2.0 * torch.mean(torch.abs(w), dim=reduce_axis, keepdim=True)
    s = torch.clamp_min(s, 1e-12)
    return s.detach()


def statsq_b4_round(w: torch.Tensor, num_bits: int, *, reduce_axis: int = 0,
                    mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-round image `clip(w/s) * n - 0.5` and its scale, in >= fp32
    (`mesh`: the group's scale, `statsq_scale`)."""
    w32 = w.to(at_least_f32(w.dtype))
    s = statsq_scale(w32, reduce_axis=reduce_axis, mesh=mesh)
    clipped = torch.clamp(w32 / s, -1.0, 1.0 - _CLIP_HI_EPS)
    n = float(2 ** (num_bits - 1))
    return clipped * n - 0.5, s


def statsq_quantize(w: torch.Tensor, num_bits: int, *,
                    reduce_axis: int = 0, mesh=None) -> torch.Tensor:
    """Fake-quantize a kernel with StatsQ; gradient is the identity
    (`mesh`: the group's scale, `statsq_scale`)."""
    b4_round, s = statsq_b4_round(w, num_bits, reduce_axis=reduce_axis,
                                  mesh=mesh)
    n = float(2 ** (num_bits - 1))
    q = (s * ((torch.round(b4_round) + 0.5) / n)).to(w.dtype)
    return passthrough(q.detach(), w)


def statsq_quantize_4d(w: torch.Tensor, num_bits: int) -> torch.Tensor:
    """The 4-D StatsQ of the reference's `StatsQuantizer_4d`
    (`ofq_tpu/quant/statsq.py:83-95`): one scale per axis-2 slice, `2 *
    mean|w|` over axes (0, 1, 3), at least 1e-12 (in w's dtype), the
    scaled values clipped to `[-1, 1 - 1e-6]`, the mid-rise levels; the
    gradient is the identity."""
    s = 2.0 * torch.mean(torch.abs(w), dim=(0, 1, 3), keepdim=True)
    s = torch.maximum(s, torch.tensor(1e-12, dtype=w.dtype,
                                      device=w.device)).detach()
    clipped = torch.clamp(w / s, -1.0, 1.0 - _CLIP_HI_EPS)
    n = float(2 ** (num_bits - 1))
    q = s * ((torch.round(clipped * n - 0.5) + 0.5) / n)
    return passthrough(q.detach(), w)


def cga_band_mask(b4_round: torch.Tensor, num_bits: int,
                  boundary_range: float, *, level_lo: int | None = None,
                  level_hi: int | None = None) -> torch.Tensor:
    """True where the pre-round value sits in a rounding-decision band:
    `floor(b4_round)` in [level_lo, level_hi] and `|frac - 0.5| <=
    boundary_range` (the bands are disjoint for boundary_range < 0.5).
    The levels default to the in-forward range [-2^(b-1), 2^(b-1) - 2]."""
    if level_lo is None:
        level_lo = -(2 ** (num_bits - 1))
    if level_hi is None:
        level_hi = 2 ** (num_bits - 1) - 2
    floor = torch.floor(b4_round)
    frac = b4_round - floor
    in_band = (frac >= 0.5 - boundary_range) & (frac <= 0.5 + boundary_range)
    return in_band & (floor >= level_lo) & (floor <= level_hi)


def statsq_quantize_cga(w: torch.Tensor, num_bits: int,
                        boundary_range: float, *, training: bool,
                        reduce_axis: int = 0) -> torch.Tensor:
    """StatsQ with in-forward CGA (`qk_reparam_type=1`).  The band masking
    only feeds a value that is detached before the straight-through
    passthrough, so value and gradient are plain StatsQ's; CGA acts in the
    train step (`train/cga.py`)."""
    del boundary_range, training
    return statsq_quantize(w, num_bits, reduce_axis=reduce_axis)


def outer_freeze_mask(w: torch.Tensor, num_bits: int, boundary_range: float,
                      *, reduce_axis: int = 0, mesh=None,
                      row_parallel: bool = False) -> torch.Tensor:
    """CGA's freeze mask, exact fp32 0/1: 1 where a weight is frozen, 0
    where its pre-round value lies in a band whose level is in
    [min(round(b4)), max(round(b4)) - 1] over the whole tensor.  The band
    test runs on `statsq_b4_round`, at least fp32 even for bf16 weights;
    the level range stays on the device (no host sync).  With `mesh`, `w`
    is this rank's slice of a kernel sharded over the model group: the
    range is the whole kernel's, and so is the scale of a
    `row_parallel` kernel."""
    with torch.no_grad():
        b4_round, _ = statsq_b4_round(w, num_bits, reduce_axis=reduce_axis,
                                      mesh=mesh if row_parallel else None)
        rounded = torch.round(b4_round)
        floor = torch.floor(b4_round)
        frac = b4_round - floor
        in_band = ((frac >= 0.5 - boundary_range)
                   & (frac <= 0.5 + boundary_range))
        in_range = ((floor >= model_min(torch.amin(rounded), mesh))
                    & (floor <= model_max(torch.amax(rounded), mesh) - 1.0))
        return 1.0 - (in_band & in_range).to(torch.float32)
