"""ofq_tpu_torch: the PyTorch/CUDA port of `ofq_tpu` for NVIDIA Hopper.

A second package beside the JAX one.  It mirrors `ofq_tpu`'s layout
(`quant/`, `nn/`, `ops/`, `models/`, `serve.py`) and keeps its parameter
names (the Flax tree paths, e.g. `blocks_3.attn.quan_qkx.s`) and its
`(in, out)` kernel layout, so weights carry across with a flatten-and-copy
(`convert.load_flax_params`).

The serving forward of DeiT W2A2 QKR runs two hand-written CUDA kernels
(`ops/fused_qlinear.py`, `ops/fused_attention.py`); every kernel has a
plain PyTorch version beside it, used for tensors on the CPU.  Nothing in
this package imports JAX or `ofq_tpu`, and importing it builds nothing:
the kernels are compiled with `nvcc` at their first launch.
"""

__version__ = "0.1.0"
