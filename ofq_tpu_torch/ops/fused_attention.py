"""Fused quantized attention core, forward: scores -> softmax -> LSQ -> @ v
(port of `ofq_tpu/ops/fused_attention.py`, forward).

    scores = lhs @ rhs^T * sm_scale
    p      = softmax(scores, axis=-1)
    pq     = round(clip(p / s_n, 0, 2^bits - 1)) * s_n   (per query row n,
                                                        s_n floored at 1e-5)
    out    = pq @ v

every sum in fp32, as in the TPU kernel.

lhs is the QKR input shared across heads, (B, N, K), or per head,
(B, N, H, K); rhs (B, N, H, K); v (B, N, H, d); s (N,); out (B, N, H, d),
all in the JAX package's natural layout.  `qkr_attention_fwd` launches the
hand-written kernel `csrc/fused_attention.cu` on CUDA tensors and runs
`qkr_attention_fwd_reference` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_S_EPS = 1e-5
# the card's per-block shared memory limit (H100: 227 KB)
_MAX_SMEM = 232448


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x - max) / sum, the division form of jax.nn.softmax."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def qkr_attention_fwd_reference(lhs, rhs, v, s, bits, sm_scale, quantize):
    """Plain PyTorch version of the kernel, on fp32 tensors, with fp32 sums
    as in `ofq_tpu.ops.fused_attention._fwd_kernel`."""
    spec = "bnk,bmhk->bhnm" if lhs.ndim == 3 else "bnhk,bmhk->bhnm"
    p = softmax(torch.einsum(spec, lhs, rhs) * sm_scale)
    if quantize:
        s_row = torch.clamp_min(s, _S_EPS)[None, None, :, None]
        p = torch.round(torch.clamp(p / s_row, 0.0, 2 ** bits - 1)) * s_row
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def _launch(lhs, rhs, v, s, bits, sm_scale, quantize):
    B, N, H, K = rhs.shape
    d = v.shape[-1]
    lhs_shape = (B, N, K) if lhs.ndim == 3 else (B, N, H, K)
    args = {"lhs": (lhs, lhs_shape), "rhs": (rhs, (B, N, H, K)),
            "v": (v, (B, N, H, d)), "s": (s, (N,))}
    for name, (t, shape) in args.items():
        if (t.device != rhs.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"qkr_attention_fwd: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {rhs.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load("fused_attention")
    smem_fn = lib.ofq_qkr_attention_smem_bytes
    smem_fn.restype = ctypes.c_longlong
    smem_fn.argtypes = [ctypes.c_int]
    if smem_fn(N) > _MAX_SMEM:
        raise ValueError(
            f"qkr_attention_fwd: N={N} keys need {smem_fn(N)} bytes of "
            f"shared memory per block, more than the card's {_MAX_SMEM}")
    fn = lib.ofq_qkr_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    out = torch.empty((B, N, H, d), dtype=torch.float32, device=rhs.device)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lhs.data_ptr(), int(lhs.ndim == 4), rhs.data_ptr(),
                 v.data_ptr(), s.data_ptr(), out.data_ptr(), B, N, H, K, d,
                 float(2 ** bits - 1), float(sm_scale), int(bool(quantize)),
                 stream)
    _build.check(lib, err, "qkr_attention_fwd")
    qkr_attention_fwd.launches += 1
    return out


def qkr_attention_fwd(lhs, rhs, v, s, bits, sm_scale, quantize):
    """The kernel's wrapper: a CUDA tensor goes to the CUDA kernel (which
    raises if it cannot build or launch), a CPU tensor to the plain
    version."""
    if rhs.is_cuda:
        return _launch(lhs, rhs, v, s, bits, sm_scale, quantize)
    return qkr_attention_fwd_reference(lhs, rhs, v, s, bits, sm_scale,
                                       quantize)


# launches of the CUDA kernel; the CPU and comparison paths do not count
qkr_attention_fwd.launches = 0


def quantized_attention_core(lhs, rhs, v, s, *, bits: int, sm_scale: float,
                             quantize_softmax: bool = True,
                             fwd=qkr_attention_fwd):
    """Port of `ofq_tpu.ops.fused_attention.quantized_attention_core`
    (forward): computes in fp32, returns v's dtype, (B, N, H, d).  `fwd`
    is the kernel's wrapper, or its plain version for comparison on the
    card."""
    f32 = [t.to(torch.float32).contiguous() for t in (lhs, rhs, v, s)]
    out = fwd(*f32, bits, sm_scale, quantize_softmax)
    return out.to(v.dtype)
