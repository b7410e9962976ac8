"""ofq_tpu_torch: the PyTorch/CUDA port of `ofq_tpu` for NVIDIA Hopper.

A second package beside the JAX one.  It mirrors `ofq_tpu`'s layout
(`quant/`, `nn/`, `ops/`, `models/`, `serve.py`) and keeps its parameter
names (the Flax tree paths, e.g. `blocks_3.attn.quan_qkx.s`) and its
`(in, out)` kernel layout, so weights carry across with a flatten-and-copy
(`convert.load_flax_params`).

DeiT W2A2 QKR serves and trains, and Swin-T (W2A2 QKR and float) serves,
through hand-written CUDA kernels (`ops/fused_qlinear.py`,
`ops/fused_attention.py`, `ops/pallas_statsq.py`, and the Swin
window-attention lab kernels of `ops/window_attention.py`); every kernel
has a plain PyTorch version beside it, used for tensors on the CPU.  The
int8 path (`matmul_impl="int8"`) runs every quantized product on the
integer codes (`ops/int8_qlinear.py`, `torch._int_mm` on the card), and
a trained student freezes into a packed artifact (`deploy.py`) served
through the same integer core (`serve.Predictor.from_packed`).  The
models take the LN->BN swap (`norm_layer="batchnorm"`) and the MLP
activations of the policy's `act_layer`; the train step, the oscillation
hook and per-layer gradient norms (`train/`).
Nothing in this package imports JAX or `ofq_tpu`, and importing it builds
nothing: the kernels are compiled with `nvcc` at their first launch.
"""

__version__ = "0.1.0"
