"""Hand-written CUDA kernels and their plain PyTorch versions.

Importing this package builds nothing; a kernel is compiled by `nvcc` at
its first launch on a CUDA tensor (see `_build.py`).
"""

from .fused_attention import qkr_attention_fwd
from .fused_qlinear import fused_qlinear_fwd


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    fused_qlinear_fwd.launches = 0
    fused_qlinear_fwd.launch_shapes.clear()
    qkr_attention_fwd.launches = 0


__all__ = ["fused_qlinear_fwd", "qkr_attention_fwd", "reset_launch_counts"]
