"""The StatsQ weight-quantized matmul of every composed QLinear (port of
`ofq_tpu/ops/statsq_matmul.py`).

`impl` selects the backend:
  'xla'    -- the composition: `statsq_quantize(W)` (STE), then one product
              with fp32 sums (`preferred_element_type=at_least_f32`);
  'pallas' -- K4 (`ops/pallas_statsq.py`): W quantized inside the kernel.
Both take `compute_dtype` as JAX does: x and the quantized weight are cast
to it and the result is returned in it.  Under tensor parallelism (`tp`,
as `ops/fused_qlinear.py`'s) the composition puts
`parallel.copy_to_model` on a column-parallel product's >= fp32 input and
`parallel.reduce_from_model` on a row-parallel product's >= fp32 output
(with the group's StatsQ scale), so that the all-reduces run on unrounded
sums; 'pallas' does the same inside K4's autograd function.
"""

from __future__ import annotations

import torch

from ..parallel.tensor import copy_to_model, reduce_from_model, tp_roles
from ..quant.statsq import statsq_quantize
from ..quant.ste import at_least_f32
from .pallas_statsq import pallas_statsq_fwd, pallas_statsq_matmul

_DEFAULT_IMPL = "xla"


def set_default_impl(impl: str) -> None:
    """The backend taken when `statsq_matmul` is given `impl=None`."""
    global _DEFAULT_IMPL
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl={impl!r}: 'xla' or 'pallas'")
    _DEFAULT_IMPL = impl


def statsq_matmul(x: torch.Tensor, kernel: torch.Tensor, bits: int, *,
                  impl: str | None = None, compute_dtype=None,
                  fwd=pallas_statsq_fwd, tp=None) -> torch.Tensor:
    """`x @ statsq_quantize(kernel)` with STE gradients.  x: (..., K);
    kernel: (K, N).  `fwd` is K4's wrapper or its plain version (the
    'pallas' backend only); `tp` (role, mesh) under tensor parallelism."""
    impl = impl or _DEFAULT_IMPL
    if impl == "pallas":
        return pallas_statsq_matmul(x, kernel, bits,
                                    compute_dtype=compute_dtype, fwd=fwd,
                                    tp=tp)
    row, col = tp_roles(tp)
    wq = statsq_quantize(kernel, bits, mesh=row)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        wq = wq.to(compute_dtype)
    acc = at_least_f32(x.dtype)
    xa = copy_to_model(x.to(acc), col)
    y = reduce_from_model(torch.matmul(xa, wq.to(acc)), row)
    return y.to(compute_dtype) if compute_dtype is not None else y
