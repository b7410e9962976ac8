"""Fully-fused quantized linear: LSQ(activation) + StatsQ(weight) + matmul
(port of `ofq_tpu/ops/fused_qlinear.py`, forward).

    xq = s_x * round(clamp(u)),      u = (x + b_pre) / s_x
    wq = s_w * (2*round(c*n - .5)+1) / (2n)
    y  = xq @ wq + (b_post @ wq + bias)
       = [s_x (.) s_w/(2n)] * (XI @ WI) + bvec

`fused_qlinear_fwd` is the kernel's wrapper: on a CUDA tensor it launches
the hand-written kernel `csrc/fused_qlinear.cu` (built at first use), on a
CPU tensor it runs `fused_qlinear_fwd_reference`, the same arithmetic in
plain PyTorch.  `s_w` (with its 1e-12 floor) and `bvec` are computed by
torch ops before the launch, as in JAX.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..quant.lsq import thresholds
from ..quant.statsq import _CLIP_HI_EPS, statsq_scale
from . import _build

_S_EPS = 1e-5


def _w_levels_int(w, sw, n):
    """Odd-integer weight levels: 2*round(clip(w/s)*n - .5) + 1."""
    c = torch.clamp(w / sw, -1.0, 1.0 - _CLIP_HI_EPS)
    return 2.0 * torch.round(c * n - 0.5) + 1.0


def _wq_value(w, sw, n):
    return sw * (_w_levels_int(w, sw, n) / (2.0 * n))


def fused_qlinear_fwd_reference(x2, s_tok, n_tok, b_pre, w, s_w, bvec,
                                a_lo, a_hi, n_w):
    """Plain PyTorch version of the kernel.  x2 (M, K); s_tok (n_tok,),
    row r uses s_tok[r % n_tok]; b_pre (K,); w (K, N); s_w (1, N);
    bvec (N,).  Returns y (M, N)."""
    rows = torch.arange(x2.shape[0], device=x2.device) % n_tok
    s_row = s_tok[rows].reshape(-1, 1)
    u = (x2 + b_pre) / s_row
    xi = torch.round(torch.clamp(u, a_lo, a_hi))
    acc = xi @ _w_levels_int(w, s_w, n_w)
    return acc * s_row * (s_w / (2.0 * n_w)) + bvec


def _launch(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi, n_w):
    M, K = x2.shape
    N = w.shape[1]
    args = {"x2": (x2, (M, K)), "s_tok": (s_tok, (n_tok,)),
            "b_pre": (b_pre, (K,)), "w": (w, (K, N)), "s_w": (s_w, (1, N)),
            "bvec": (bvec, (N,))}
    for name, (t, shape) in args.items():
        if (t.device != x2.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"fused_qlinear_fwd: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {x2.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if M % n_tok:
        raise ValueError(f"fused_qlinear_fwd: M={M} is not a multiple of "
                         f"n_tok={n_tok}")
    lib = _build.load("fused_qlinear")
    fn = lib.ofq_fused_qlinear_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                   + [ctypes.c_void_p])
    y = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x2.data_ptr(), s_tok.data_ptr(), n_tok, b_pre.data_ptr(),
                 w.data_ptr(), s_w.data_ptr(), bvec.data_ptr(), y.data_ptr(),
                 M, K, N, float(a_lo), float(a_hi), float(n_w), stream)
    _build.check(lib, err, "fused_qlinear_fwd")
    fused_qlinear_fwd.launches += 1
    fused_qlinear_fwd.launch_shapes[(M, K, N)] += 1
    return y


def fused_qlinear_fwd(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi,
                      n_w):
    """The kernel's wrapper: a CUDA tensor goes to the CUDA kernel (which
    raises if it cannot build or launch), a CPU tensor to the plain
    version."""
    if x2.is_cuda:
        return _launch(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi,
                       n_w)
    return fused_qlinear_fwd_reference(x2, s_tok, n_tok, b_pre, w, s_w,
                                       bvec, a_lo, a_hi, n_w)


# launches of the CUDA kernel, in total and by (M, K, N); the CPU and
# comparison paths do not count
fused_qlinear_fwd.launches = 0
fused_qlinear_fwd.launch_shapes = collections.Counter()


def fused_qlinear(x, kernel, s, b_pre, b_post, bias=None, *, w_bits: int,
                  a_bits: int, all_positive: bool = False,
                  fwd=fused_qlinear_fwd):
    """Fused QLinear forward (port of `ofq_tpu.ops.fused_qlinear.fused_qlinear`).

    x: (..., n_tok, K); kernel: (K, N); s: (n_tok,) per-token LSQ scale;
    b_pre/b_post: (K,) shifts; bias: (N,) or None.  Computes in fp32 and
    returns x's dtype.  `fwd` is the kernel's wrapper, or its plain version
    for comparison on the card.
    """
    a_lo, a_hi = thresholds(a_bits, all_positive)
    n_w = float(2 ** (w_bits - 1))
    K = x.shape[-1]
    n_tok = x.shape[-2]
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    s_eff = torch.clamp_min(s.to(torch.float32), _S_EPS).contiguous()
    w = kernel.to(torch.float32).contiguous()
    sw = statsq_scale(w)
    bvec = b_post.to(torch.float32) @ _wq_value(w, sw, n_w)
    if bias is not None:
        bvec = bvec + bias.to(torch.float32)
    y2 = fwd(x2, s_eff, n_tok, b_pre.to(torch.float32).contiguous(), w,
             sw.contiguous(), bvec.contiguous(), a_lo, a_hi, n_w)
    return y2.reshape(*x.shape[:-1], kernel.shape[1]).to(x.dtype)
