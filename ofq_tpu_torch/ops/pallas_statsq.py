"""StatsQ weight fake-quant fused into the matmul (port of
`ofq_tpu/ops/pallas_statsq.py`).

    K4  y[m, n]  = sum_k x[m, k] * Q(W)[k, n]     `pallas_statsq_fwd`
    K5  dx[m, k] = sum_n g[m, n] * Q(W)[k, n]     `pallas_statsq_dx`
    Q(W) = s * ((round(clip(W / s, -1, 1 - 1e-6) * n - 0.5) + 0.5) / n)

with the per-column scale s = 2 mean|W| (`statsq_scale`, detached)
computed before the launch, as in JAX.  Each wrapper launches its
hand-written CUDA kernels (`csrc/pallas_statsq.cu`, built at first use) on
a CUDA tensor: a pre-pass forms Q(W) in W's dtype (fp32) once per call
into a scratch buffer the wrapper allocates, then a register-tiled
CUDA-core product sums each output in fp32 in ascending contraction order
and rounds it once to x's dtype (fp32 or bf16).  A CPU tensor goes to the
plain PyTorch version (`*_reference`).

`pallas_statsq_matmul` reaches K4 through `_PallasStatsQMatmul`, the custom
VJP of the JAX package, whose backward is XLA there and torch ops here:

    dx = g @ Q(W)^T   (Q(W) cast to the compute dtype, fp32 sums, x's dtype)
    dW = x^T @ g      (STE; fp32 sums, W's dtype)

K5 computes the same dx product with Q(W) kept in fp32; no VJP of the JAX
package calls it (its `_vjp_bwd` measured XLA faster), and neither does the
port's.

Under tensor parallelism (`tp=(role, mesh)`, as `fused_qlinear`'s): a
row-parallel product (proj, fc2) takes the group's scale, runs K4 on x
upcast to fp32 (exact; K4 sums in fp32 in both streams, so its fp32
output is the bf16 stream's sum before the rounding) and all-reduces
those fp32 partial sums over the model group before rounding once to x's
dtype; a column-parallel one (fc1) all-reduces its fp32 dx in the
backward before the rounding.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..parallel.tensor import model_sum, tp_roles
from ..quant.statsq import _CLIP_HI_EPS, statsq_scale
from ..quant.ste import needs_grad
from . import _build
from .fused_attention import (check_args, on_card, refuse_graph_cut,
                              stream_dtype)


def _quant_tile(w, s, n_levels):
    """The StatsQ levels of `w` (K, N) for the scale `s` (1, N), in w's
    dtype: the expression of the JAX kernels' `_quant_tile`."""
    clipped = torch.clamp(w / s, -1.0, 1.0 - _CLIP_HI_EPS)
    return s * ((torch.round(clipped * n_levels - 0.5) + 0.5) / n_levels)


def _acc32(a, b):
    """`a @ b` as `dot(..., preferred_element_type=float32)`: exact widening
    of bf16 operands, products and sums in at least fp32, the result in
    fp32 (an fp64 product, on the CPU, rounded to fp32 as JAX does)."""
    hi = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.float32)
    return torch.matmul(a.to(hi), b.to(hi)).to(torch.float32)


def pallas_statsq_fwd_reference(x2, w, s, n_levels):
    """Plain PyTorch version of K4: x2 (M, K), w (K, N), s (1, N) ->
    (M, N) in x2's dtype."""
    return _acc32(x2, _quant_tile(w, s, n_levels)).to(x2.dtype)


def pallas_statsq_dx_reference(g2, w, s, n_levels, x_dtype):
    """Plain PyTorch version of K5: g2 (M, N), w (K, N), s (1, N) ->
    (M, K) in `x_dtype`."""
    return _acc32(g2, _quant_tile(w, s, n_levels).T).to(x_dtype)


def launch_config(M, C, bf16):
    """How the product launches for an (M, C) output (K4: C = N, K5: C =
    K) in fp32 or (bf16=True) the bf16 stream, as the built library reports
    it (`ofq_pallas_statsq_launch`): the block tile, threads, grid, dynamic
    shared memory in bytes and blocks per SM (the CUDA runtime's
    occupancy, registers counted)."""
    info = (ctypes.c_int * 6)()
    fn = _build.load("pallas_statsq").ofq_pallas_statsq_launch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    smem = fn(M, C, int(bf16), info)
    return dict(tile=(info[0], info[1]), threads=info[2],
                grid=(info[3], info[4]), smem=smem, blocks_per_sm=info[5])


def _launch(fn_name, what, a, w, s, n_levels, out_shape, M, K, N):
    lib = _build.load("pallas_statsq")
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    # the pre-pass's Q(W) (K4) or Q(W)^T (K5), read by the product
    levels = torch.empty(K * N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(), s.data_ptr(),
                 levels.data_ptr(), out.data_ptr(), M, K, N, float(n_levels),
                 int(a.dtype == torch.bfloat16), stream)
    _build.check(lib, err, what)
    return out


def pallas_statsq_fwd(x2, w, s, n_levels):
    """K4's wrapper: a CUDA tensor goes to the CUDA kernel (which raises if
    it cannot build or launch), a CPU tensor to the plain version."""
    refuse_graph_cut("pallas_statsq_fwd", x2, w, s)
    if not on_card(x2):
        return pallas_statsq_fwd_reference(x2, w, s, n_levels)
    M, K = x2.shape
    N = w.shape[1]
    check_args("pallas_statsq_fwd", x2, x2=(x2, (M, K), stream_dtype(x2)),
               w=(w, (K, N)), s=(s, (1, N)))
    y = _launch("ofq_pallas_statsq_fwd", "pallas_statsq_fwd", x2, w, s,
                n_levels, (M, N), M, K, N)
    pallas_statsq_fwd.launches += 1
    pallas_statsq_fwd.launch_shapes[(M, K, N)] += 1
    return y


def pallas_statsq_dx(g2, w, s, n_levels, x_dtype):
    """K5's wrapper: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
    the plain version.  On the card the output dtype is g2's (`x_dtype`
    must equal it)."""
    refuse_graph_cut("pallas_statsq_dx", g2, w, s)
    if not on_card(g2):
        return pallas_statsq_dx_reference(g2, w, s, n_levels, x_dtype)
    M, N = g2.shape
    K = w.shape[0]
    if x_dtype != g2.dtype:
        raise ValueError(f"pallas_statsq_dx: the kernel writes g2's dtype "
                         f"{g2.dtype}, asked for {x_dtype}")
    check_args("pallas_statsq_dx", g2, g2=(g2, (M, N), stream_dtype(g2)),
               w=(w, (K, N)), s=(s, (1, N)))
    dx = _launch("ofq_pallas_statsq_dx", "pallas_statsq_dx", g2, w, s,
                 n_levels, (M, K), M, K, N)
    pallas_statsq_dx.launches += 1
    pallas_statsq_dx.launch_shapes[(M, K, N)] += 1
    return dx


# launches of the CUDA kernels, in total and by (M, K, N); the CPU and
# comparison paths do not count
pallas_statsq_fwd.launches = 0
pallas_statsq_fwd.launch_shapes = collections.Counter()
pallas_statsq_dx.launches = 0
pallas_statsq_dx.launch_shapes = collections.Counter()


def _forward(x2, w, s, bits, fwd, row):
    """K4 (or its plain version) on x2; a row-parallel product's fp32
    partial sums reduced over the model group, then rounded to x2's
    dtype."""
    n = float(2 ** (bits - 1))
    if row is None:
        return fwd(x2.contiguous(), w.contiguous(), s.contiguous(), n)
    hi = torch.promote_types(x2.dtype, torch.float32)
    y = fwd(x2.to(hi).contiguous(), w.contiguous(), s.contiguous(), n)
    return model_sum(y, row).to(x2.dtype)


class _PallasStatsQMatmul(torch.autograd.Function):
    """The custom VJP of `ofq_tpu.ops.pallas_statsq._pallas_statsq_matmul`:
    the K4 forward with the detached scale, residuals (x2, w, s), and
    `_vjp_bwd` in torch ops.  `fwd` is K4's wrapper or its plain version;
    `tp` the module docstring's."""

    @staticmethod
    def forward(ctx, x2, w, bits, compute_dtype, fwd, tp):
        row, _ = tp_roles(tp)
        s = statsq_scale(w, mesh=row)
        ctx.save_for_backward(x2, w, s)
        ctx.cfg = (bits, compute_dtype, tp)
        return _forward(x2, w, s, bits, fwd, row)

    @staticmethod
    def backward(ctx, g):
        x2, w, s = ctx.saved_tensors
        bits, compute_dtype, tp = ctx.cfg
        _, col = tp_roles(tp)
        wq = _quant_tile(w, s, float(2 ** (bits - 1)))
        if compute_dtype is not None:
            wq = wq.to(compute_dtype)
        dx = _acc32(g, wq.T)
        if col is not None:
            dx = model_sum(dx, col)
        dx = dx.to(x2.dtype)
        dw = _acc32(x2.T, g).to(w.dtype)
        return dx, dw, None, None, None, None


def pallas_statsq_matmul(x, kernel, bits, *, compute_dtype=None,
                         fwd=pallas_statsq_fwd, tp=None):
    """`x @ StatsQ(kernel)` with StatsQ(W) formed inside K4 (port of
    `ofq_tpu.ops.pallas_statsq.pallas_statsq_matmul`).  x: (..., K),
    cast to `compute_dtype` when given; kernel: (K, N).  Returns x's
    (compute) dtype.  `fwd` is K4's wrapper, or its plain version for
    comparison on the card; `tp` the layer's role under tensor
    parallelism (module docstring)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if compute_dtype is not None:
        x2 = x2.to(compute_dtype)
    if needs_grad(x2, kernel):
        y = _PallasStatsQMatmul.apply(x2, kernel, bits, compute_dtype, fwd,
                                      tp)
    else:
        row, _ = tp_roles(tp)
        y = _forward(x2, kernel, statsq_scale(kernel, mesh=row), bits, fwd,
                     row)
    return y.reshape(*lead, kernel.shape[1])
