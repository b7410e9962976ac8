"""Hand-written CUDA kernels and their plain PyTorch versions.

Importing this package builds nothing; a kernel is compiled by `nvcc` at
its first launch on a CUDA tensor (see `_build.py`).  `int8_mm`, the
integer product of the int8 path (`torch._int_mm`, a library call: the JAX
package hands it to XLA, no Pallas kernel), is counted beside them.
"""

from .fused_attention import qkr_attention_bwd, qkr_attention_fwd
from .fused_qlinear import fused_qlinear_fwd
from .int8_qlinear import int8_mm
from .pallas_statsq import pallas_statsq_dx, pallas_statsq_fwd
from . import window_attention
from .window_attention import (window_attn_packed, window_attn_packed_aligned,
                               window_attn_units)

_COUNTED = (fused_qlinear_fwd, qkr_attention_fwd, qkr_attention_bwd,
            pallas_statsq_fwd, pallas_statsq_dx, window_attn_units,
            *window_attention.FORM_LAUNCHES.values(), window_attn_packed,
            window_attn_packed_aligned, int8_mm)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0
        if hasattr(fn, "launch_shapes"):
            fn.launch_shapes.clear()


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by wrapper name; K6's ablation
    forms as `window_attn_units_<form>`."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


__all__ = ["fused_qlinear_fwd", "int8_mm", "launch_counts", "pallas_statsq_dx",
           "pallas_statsq_fwd", "qkr_attention_bwd", "qkr_attention_fwd",
           "reset_launch_counts", "window_attn_packed",
           "window_attn_packed_aligned", "window_attn_units"]
