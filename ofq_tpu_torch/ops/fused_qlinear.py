"""Fully-fused quantized linear: LSQ(activation) + StatsQ(weight) + matmul
(port of `ofq_tpu/ops/fused_qlinear.py`).

    xq = s_x * round(clamp(u)),      u = (x + b_pre) / s_x
    wq = s_w * (2*round(c*n - .5)+1) / (2n)
    y  = xq @ wq + (b_post @ wq + bias)
       = [s_x (.) s_w/(2n)] * (XI @ WI) + bvec

`fused_qlinear_fwd` is the kernel's wrapper: on a CUDA tensor it launches
the hand-written kernel `csrc/fused_qlinear.cu` (built at first use), on a
CPU tensor it runs `fused_qlinear_fwd_reference`, the same arithmetic in
plain PyTorch.  `s_w` (with its 1e-12 floor) and `bvec` are computed by
torch ops before the launch, as in JAX.  The kernel forms both code sets
on the card and multiplies them with `wgmma` (bf16 codes, fp32 sums) on
the tensor cores; the integer sums are exact while
K * max|XI| * max|WI| < 2^24, so it gives the plain version's bits.

`fused_qlinear` reaches the kernel through `_FusedQLinear`, a
`torch.autograd.Function` whose backward is the JAX package's closed-form
`_fused_bwd` (XLA ops there, torch ops here; no Pallas kernel):

    dxq = g @ wq^T ; dx = dxq * 1[u in range] ; db_pre = sum_m dx
    ds  = gf * sum_{b,k} (in ? round(u)-u : clamp(u)) * dxq   per token
    dW  = (xq + b_post)^T @ g  (STE; scale detached)
    db_post = (sum_m g) @ wq^T ; dbias = sum_m g

Under tensor parallelism (`tp=(role, mesh)`, the mesh's model group):
a column-parallel layer ('col', fc1: its columns sharded, its input
whole) all-reduces `dxq` once in the backward and forms dx, ds, db_pre
and db_post (= sum_m dxq) from the whole `dxq`; a row-parallel layer
('row', proj and fc2: its rows and input channels sharded) takes the
whole kernel's StatsQ scale in the forward and the backward (its rows
gathered), forms bvec from the gathered kernel and b_post, runs the
kernel on its codes' units so that it returns the exact integer sums of
its rows, all-reduces those (exact) and applies the epilogue to the whole
sums (`_row_parallel_forward`: the single process's output bit for bit),
and takes its `ds` grad-scale factor at the whole input width (the
caller sums `ds` over the group: `parallel.copy_to_model` on s).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..parallel.tensor import gather_rows, model_sum, tp_roles
from ..quant.lsq import act_grad_scale_factor, thresholds
from ..quant.statsq import _CLIP_HI_EPS, statsq_scale
from ..quant.ste import needs_grad
from . import _build
from .fused_attention import check_args, on_card, refuse_graph_cut

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
    bvec (N,).  Returns y (M, N).  The kernel takes s_tok and s_w
    positive, as `_fused_forward` floors them (its code tables rest on
    the codes rising with x and w)."""
    rows = torch.arange(x2.shape[0], device=x2.device) % n_tok
    s_row = s_tok[rows].reshape(-1, 1)
    u = (x2 + b_pre) / s_row
    xi = torch.round(torch.clamp(u, a_lo, a_hi))
    acc = xi @ _w_levels_int(w, s_w, n_w)
    return acc * s_row * (s_w / (2.0 * n_w)) + bvec


def _launch(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi, n_w):
    """Check the operands and launch the kernel, counted."""
    M, K = x2.shape
    N = w.shape[1]
    check_args("fused_qlinear_fwd", x2, x2=(x2, (M, K)),
               s_tok=(s_tok, (n_tok,)), b_pre=(b_pre, (K,)),
               w=(w, (K, N)), s_w=(s_w, (1, N)), bvec=(bvec, (N,)))
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


def launch_shape(M, K, N, n_tok, a_lo, a_hi, n_w):
    """The launch the kernel takes for these shapes on the current card:
    dict(bn, grid, tiles, panel, stages); grid (N tiles, blocks per N
    tile), tiles the M tiles each persistent block walks, panel whether it
    keeps its N tile's W codes, stages the raw slots of its rings."""
    fn = _build.load("fused_qlinear").ofq_fused_qlinear_shape
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 6)()
    fn(M, K, N, n_tok, float(a_lo), float(a_hi), float(n_w),
       ctypes.cast(out, ctypes.c_void_p))
    return dict(bn=out[0], grid=(out[1], out[2]), tiles=out[3],
                panel=bool(out[4]), stages=out[5])


def fused_qlinear_fwd(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi,
                      n_w):
    """The kernel's wrapper: a CUDA tensor goes to the CUDA kernel (which
    raises if it cannot build or launch), a CPU tensor to the plain
    version."""
    refuse_graph_cut("fused_qlinear_fwd", x2, s_tok, b_pre, w, s_w, bvec)
    if on_card(x2):
        return _launch(x2, s_tok, n_tok, b_pre, w, s_w, bvec, a_lo, a_hi,
                       n_w)
    return fused_qlinear_fwd_reference(x2, s_tok, n_tok, b_pre, w, s_w,
                                       bvec, a_lo, a_hi, n_w)


# launches of the CUDA kernel, in total and by (M, K, N); the CPU and
# comparison paths do not count
fused_qlinear_fwd.launches = 0
fused_qlinear_fwd.launch_shapes = collections.Counter()


def _prep(x, s):
    """x (..., n_tok, K) -> fp32 (M, K); the per-row scale, floored."""
    K = x.shape[-1]
    n_tok = x.shape[-2]
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    s_eff = torch.clamp_min(s.to(torch.float32), _S_EPS).contiguous()
    return x2, s_eff, n_tok


def _fused_forward(x, kernel, s, b_pre, b_post, bias, w_bits, a_bits,
                   all_positive, fwd, tp=None):
    """The forward of `_fused_fwd`: s_w, bvec and the operands prepared by
    torch ops, then the kernel (or its plain version, `fwd`); a
    row-parallel layer through `_row_parallel_forward`."""
    row, _ = tp_roles(tp)
    a_lo, a_hi = thresholds(a_bits, all_positive)
    n_w = float(2 ** (w_bits - 1))
    x2, s_eff, n_tok = _prep(x, s)
    w = kernel.to(torch.float32).contiguous()
    sw = statsq_scale(w, mesh=row)
    b_pre = b_pre.to(torch.float32).contiguous()
    if row is not None:
        bvec = (gather_rows(b_post.to(torch.float32), row)
                @ _wq_value(gather_rows(w, row), sw, n_w))
        y2 = _row_parallel_forward(x2, s_eff, n_tok, b_pre, w, sw, bvec,
                                   bias, a_lo, a_hi, n_w, fwd, row)
    else:
        bvec = b_post.to(torch.float32) @ _wq_value(w, sw, n_w)
        if bias is not None:
            bvec = bvec + bias.to(torch.float32)
        y2 = fwd(x2, s_eff, n_tok, b_pre, w, sw.contiguous(),
                 bvec.contiguous(), a_lo, a_hi, n_w)
    return y2.reshape(*x.shape[:-1], kernel.shape[1]).to(x.dtype)


def _row_parallel_forward(x2, s_eff, n_tok, b_pre, w, sw, bvec, bias, a_lo,
                          a_hi, n_w, fwd, mesh):
    """A row-parallel layer's output, the single process's bits: `sw` and
    `bvec` are the whole kernel's.  The kernel runs on its codes' own
    units -- x as u = (x + b_pre) / s with unit scales and no shift, w as
    (w / s_w) * 2n (a power of two: w / s_w exactly) with the scale 2n --
    so that it returns the integer sums XI @ WI of this rank's rows, exact
    in fp32; those are summed over the model group (exact); then the plain
    version's epilogue, acc * s * (s_w / 2n) + bvec (+ the layer's bias),
    on the whole sums."""
    s_full = s_eff.repeat(x2.shape[0] // n_tok).reshape(-1, 1)
    u = (x2 + b_pre) / s_full
    acc = fwd(u.contiguous(), torch.ones_like(s_eff), n_tok,
              torch.zeros_like(b_pre), ((w / sw) * (2.0 * n_w)).contiguous(),
              torch.full_like(sw, 2.0 * n_w).contiguous(),
              torch.zeros(w.shape[1], dtype=torch.float32, device=w.device),
              a_lo, a_hi, n_w)
    if bias is not None:
        bvec = bvec + bias.to(torch.float32)
    return model_sum(acc, mesh) * s_full * (sw / (2.0 * n_w)) + bvec


class _FusedQLinear(torch.autograd.Function):
    """The custom VJP of `ofq_tpu.ops.fused_qlinear._fused`: the kernel
    forward, residuals (x, kernel, s, b_pre, b_post), and `_fused_bwd` in
    torch ops."""

    @staticmethod
    def forward(ctx, x, kernel, s, b_pre, b_post, bias, w_bits, a_bits,
                all_positive, fwd, tp):
        ctx.save_for_backward(x, kernel, s, b_pre, b_post)
        ctx.cfg = (w_bits, a_bits, all_positive, bias is not None,
                   None if bias is None else bias.dtype, tp)
        return _fused_forward(x, kernel, s, b_pre, b_post, bias, w_bits,
                              a_bits, all_positive, fwd, tp)

    @staticmethod
    def backward(ctx, g):
        x, kernel, s, b_pre, b_post = ctx.saved_tensors
        w_bits, a_bits, all_positive, has_bias, bias_dtype, tp = ctx.cfg
        row, col = tp_roles(tp)
        a_lo, a_hi = thresholds(a_bits, all_positive)
        n_w = float(2 ** (w_bits - 1))
        gf = act_grad_scale_factor(
            x.shape, a_bits, all_positive, -2,
            None if row is None else (x.ndim - 1, row.model_parallel))
        x2, s_eff, n_tok = _prep(x, s)
        s_full = s_eff.repeat(x2.shape[0] // n_tok).reshape(-1, 1)
        g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
        w = kernel.to(torch.float32)
        wq = _wq_value(w, statsq_scale(w, mesh=row), n_w)

        u = (x2 + b_pre.to(torch.float32)) / s_full
        in_range = (u >= a_lo) & (u <= a_hi)
        dxq = g2 @ wq.T
        if col is not None:
            # the columns' partial products, summed once over the group
            dxq = model_sum(dxq, col)
        dx2 = torch.where(in_range, dxq, torch.zeros_like(dxq))
        db_pre = torch.sum(dx2, dim=0)
        t = torch.where(in_range, torch.round(u) - u,
                        torch.clamp(u, a_lo, a_hi))
        ds_elem = (t * dxq).reshape(x.shape)
        axes = tuple(a for a in range(x.ndim) if a != x.ndim - 2)
        # no masking where s was floored at eps: clip_lower passes the
        # identity gradient, as in the composition
        ds = (torch.sum(ds_elem, dim=axes) * gf).to(s.dtype)
        # the matmul input of the composed form is (xq + b_post)
        xq = (s_full * torch.round(torch.clamp(u, a_lo, a_hi))
              + b_post.to(torch.float32))
        dkernel = (xq.T @ g2).to(kernel.dtype)
        g_sum = torch.sum(g2, dim=0)
        db_post = (g_sum @ wq.T if col is None
                   else torch.sum(dxq, dim=0)).to(b_post.dtype)
        dbias = g_sum.to(bias_dtype) if has_bias else None
        dx = dx2.reshape(x.shape).to(x.dtype)
        return (dx, dkernel, ds, db_pre.to(b_pre.dtype), db_post, dbias,
                None, None, None, None, None)


def fused_qlinear(x, kernel, s, b_pre, b_post, bias=None, *, w_bits: int,
                  a_bits: int, all_positive: bool = False,
                  fwd=fused_qlinear_fwd, tp=None):
    """Fused QLinear (port of `ofq_tpu.ops.fused_qlinear.fused_qlinear`),
    differentiable in every tensor argument.

    x: (..., n_tok, K); kernel: (K, N); s: (n_tok,) per-token LSQ scale;
    b_pre/b_post: (K,) shifts; bias: (N,) or None.  Computes in fp32 and
    returns x's dtype.  `fwd` is the kernel's wrapper, or its plain version
    for comparison on the card.  `tp`: the layer's role under tensor
    parallelism (module docstring).
    """
    args = (x, kernel, s, b_pre, b_post, bias, w_bits, a_bits,
            all_positive, fwd, tp)
    if needs_grad(x, kernel, s, b_pre, b_post, bias):
        return _FusedQLinear.apply(*args)
    return _fused_forward(*args)
