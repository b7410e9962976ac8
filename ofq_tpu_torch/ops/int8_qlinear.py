"""Integer-core QLinear: int8 x int8 -> int32 products on the real codes
(port of `ofq_tpu/ops/int8_qlinear.py:1-419`).

The QAT forward's fake-quant values are exact scaled integers:
  LSQ activations:  xq = s_a * X_int,  X_int in [thd_neg, thd_pos]
  StatsQ weights:   w_q = (s_w / 2n) * W_int,  W_int = 2k+1 odd, n = 2^(b-1)
so a QLinear forward factorizes exactly as
  y = (X_int @ W_int) * (s_a[token] * s_w[out] / 2n) + b_post @ w_q
with the integer product summed exactly in int32.  The JAX package hands
that product to XLA (`dot_general(int8, int8, preferred_element_type=
int32)`), not to a Pallas kernel; here it is `int8_mm`, which runs
`torch._int_mm` (cuBLASLt's int8 tensor-core GEMM) on a CUDA tensor and its
plain version `int8_mm_reference` on a CPU tensor.  Both are exact, so the
two give the same bits.  The scale epilogue (`acc * s_eff * col + bq`) is
eager elementwise work on the fp32 accumulator, as in JAX.

Eligibility (`int8_eligible`): weight bits 2..4 (|2k+1| <= 15) and
activation codes that fit int8.  The backward is the composed path's STE
algebra, recomputed from the chain's input: stream-dtype products with
fp32 sums (`g * col` folded into the lhs, so no dequantized kernel is
formed), the LSQ mask and the scale gradient with its grad-scale factor,
and bias gradients summed in fp32.

Every product here is 2-D (`torch.matmul` on flattened operands) or an
explicit two-operand einsum, so the card harness's summation-order gates
(`chip_smoke.rounded_once`, `summed_in_chunks`) reach each float product;
the integer product is out of their reach by construction (see
`int8_mm_reference`).

Under tensor parallelism (`int8_qlinear`'s `tp`, as `ops/fused_qlinear.py`
takes it) a column-parallel layer (fc1, `qkv` without QKR) runs its
columns' codes with their own scales and sums its input's cotangent once
over the model group (fp32, rounded after); a row-parallel one (proj,
fc2) takes the whole kernel's StatsQ codes and scale (its rows gathered:
`gather_rows`), runs the product on its rows' codes, sums the int32
partial products over the group (exact) and applies the epilogue once
to the whole sums, with `bq` from the gathered `b_post` (the single
process's output bit for bit); its input scale's grad-scale factor counts
the whole input width (the caller sums `ds` over the group).  QKR's v
and per-head x W_qk products are column-parallel on the rank's columns or
heads; their shared inputs' cotangents are summed by the caller
(`nn/attention.py:qkr_quant_chain`).

Frozen serving (`frozen_*`): the kernel holds dequantized StatsQ values
restored from a packed artifact (`deploy.py`) and the codes are
reconstructed from the artifact's stored scale, never recomputed (StatsQ
is not idempotent).  Inference only.  The full-LSQ forms
(`lsq_int8_eligible`, `frozen_lsq_*`, `ofq_tpu/ops/int8_qlinear.py:
422-455`) rebuild a full-LSQ kernel's codes from its learned per-column
scale (`weight_quant.s`): w_q = max(s, 1e-5) * k with k an integer.
"""

from __future__ import annotations

import collections

import torch

from ..parallel.tensor import gather_rows, model_sum, tp_roles
from ..quant.lsq import (_broadcast_scale, _clip, act_grad_scale_factor,
                         thresholds)
from ..quant.statsq import statsq_b4_round
from ..quant.ste import at_least_f32, clip_lower, grad_scale, round_pass
from .fused_attention import on_card, refuse_graph_cut
from .pallas_statsq import _acc32

_S_EPS = 1e-5
F32 = torch.float32
# the plain product's fp64 matrix product, bound here so that a harness
# that patches torch.matmul / torch.einsum / `@` (the card's summation-order
# gates) never reaches it
_MM = torch.mm
# cuBLASLt's int8 GEMM through `torch._int_mm` on CUDA: it refuses M <= 16
# and K or N not a multiple of 8; M is also taken to a multiple of 8, at
# least 32, so that every leading dimension is aligned.  B goes column-major
# (the (N, K) codes contiguous, cuBLASLt's "TN" int8 layout);
# `chip_smoke.phase_int8_mm` times it against row-major B at every path
# shape (PERF.md)
_INT_MM_MIN_ROWS, _INT_MM_ALIGN = 32, 8


# ------------------------------------------------------ the int product
def _check_k(K: int) -> None:
    """Every sum of K int8 products fits int32: K * 128 * 128 < 2^31."""
    if K * 128 * 128 >= 2 ** 31:
        raise ValueError(f"int8_mm: K = {K} overflows int32")


def int8_mm_reference(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Plain version of `int8_mm`: a8 (M, K) int8 @ b8 (K, N) int8 -> (M, N)
    int32, as an fp64 product of the codes, exact while every partial sum
    stays below 2^53 (|sum| <= K * 128 * 128 < 2^31)."""
    _check_k(a8.shape[-1])
    return _MM(a8.to(torch.float64), b8.to(torch.float64)).to(torch.int32)


def _pad_to(t, rows, cols):
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    out = torch.zeros(rows, cols, dtype=t.dtype, device=t.device)
    out[:r, :c] = t
    return out


def int8_mm(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """a8 (M, K) int8 @ b8 (K, N) int8 -> (M, N) int32, exact.  A CUDA
    tensor goes to `torch._int_mm` (which raises rather than fall back); a
    CPU tensor to `int8_mm_reference`.  A shape `_int_mm` refuses (M < 32
    or any of M, K, N not a multiple of 8) is padded here with zero codes,
    which add nothing to any sum, and the result cut back: never the plain
    product on the card.  B is handed over column-major, copied to that
    layout when it is not (a weight's codes: K x N bytes)."""
    if not on_card(a8):
        return int8_mm_reference(a8, b8)
    M, K = a8.shape
    N = b8.shape[1]
    if (a8.dtype, b8.dtype) != (torch.int8, torch.int8) or b8.shape[0] != K \
            or a8.device != b8.device:
        raise ValueError(f"int8_mm: int8 (M, K) @ (K, N) on one device, got "
                         f"{a8.dtype} {tuple(a8.shape)} on {a8.device}, "
                         f"{b8.dtype} {tuple(b8.shape)} on {b8.device}")
    _check_k(K)
    align = lambda v: -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN  # noqa: E731
    Mp, Kp, Np = max(align(M), _INT_MM_MIN_ROWS), align(K), align(N)
    a = _pad_to(a8, Mp, Kp).contiguous()
    b = _pad_to(b8, Kp, Np)
    if b.stride(0) != 1:
        b = b.t().contiguous().t()
    try:
        y = torch._int_mm(a, b)
    except RuntimeError as e:
        raise RuntimeError(f"int8_mm: torch._int_mm refused ({M}, {K}) @ "
                           f"({K}, {N}) (padded ({Mp}, {Kp}) @ ({Kp}, "
                           f"{Np}), b strides {b.stride()}): {e}") from e
    int8_mm.launches += 1
    int8_mm.launch_shapes[(M, K, N)] += 1
    return y[:M, :N] if (Mp, Np) != (M, N) else y


int8_mm.launches = 0
int8_mm.launch_shapes = collections.Counter()


def _codes8(codes: torch.Tensor) -> torch.Tensor:
    """Integer-valued float codes -> int8 (exact: |codes| <= 128)."""
    return codes.to(torch.int8)


def _code_product(xi, w_int, mm):
    """sum_k xi[..., k] * w_int[k, n] as int32 (..., N) through `mm`
    (`int8_mm` or `int8_mm_reference`); xi and w_int hold integer codes.
    The 2-D product of the flattened rows gives (..., N) as a free view.
    The int8 casts have no gradient: called with grad mode on, on a tensor
    that requires grad, it raises instead of cutting the graph (the
    autograd Functions call it with grad mode off; the frozen forms are
    inference only)."""
    refuse_graph_cut("int8 code product", xi, w_int)
    a = _codes8(xi).reshape(-1, xi.shape[-1])
    # the weight codes cast through their transpose: B column-major
    b = _codes8(w_int.T).T
    return mm(a, b).reshape(*xi.shape[:-1], w_int.shape[-1])


def _act_int(x1, s_eff, bit, all_positive):
    """Integer LSQ codes of the biased input, in the input's dtype."""
    thd_neg, thd_pos = thresholds(bit, all_positive)
    return torch.round(torch.clamp(x1 / s_eff, thd_neg, thd_pos))


def _weight_int(kernel, bits, reduce_axis=0):
    """Odd integer StatsQ codes W_int = 2k+1 and the scale s_w, from the
    op sequence of the port's live StatsQ (`statsq_b4_round`), so the codes
    are the composed path's levels: (in, out) QLinear kernels reduce over
    axis 0 (scale flattened to (out,)), the (H*C, C) QKR product over
    axis -1 (per-row scale kept 2-D)."""
    b4, s_w = statsq_b4_round(kernel, bits, reduce_axis=reduce_axis)
    w_int = 2.0 * torch.round(b4) + 1.0
    return (w_int, s_w.reshape(-1)) if reduce_axis == 0 else (w_int, s_w)


def _col(s_w, bits):
    return (s_w / (2.0 * float(2 ** (bits - 1)))).to(F32)


def _rows(t):
    """t (..., K) -> (M, K)."""
    return t.reshape(-1, t.shape[-1])


def _lead_sum(t, keep):
    """fp32 sum of t over every axis but the last `keep`."""
    t = t.to(F32)
    lead = tuple(range(t.ndim - keep))
    return torch.sum(t, dim=lead) if lead else t


def _unbroadcast(t, shape):
    """Sum `t` down to `shape` (same ndim, 1s on broadcast axes)."""
    axes = tuple(a for a in range(t.ndim) if shape[a] == 1 and t.shape[a] != 1)
    return torch.sum(t, dim=axes, keepdim=True) if axes else t


def int8_eligible(w_bits: int, a_bits: int,
                  all_positive: bool = False) -> bool:
    """Codes that fit int8: |W_int| = |2k+1| <= 2^w_bits - 1 (W2..W4), and
    signed activation codes for a <= 8, unsigned ones ([0, 2^a - 1]) for
    a <= 7."""
    act_ok = a_bits <= (7 if all_positive else 8)
    return 2 <= w_bits <= 4 and act_ok


# ------------------------------------------------ int8_qlinear (training)
def _s_eff(s, x1):
    s_b = _broadcast_scale(s, x1.shape, -2)
    return torch.clamp_min(s_b, _S_EPS).to(x1.dtype)


def _tp_weight_int(kernel, w_bits, row):
    """The codes of this rank's rows of `kernel` and the column scale, from
    the whole kernel (its rows gathered over the model group `row`), and
    the whole codes; `row` None: the kernel's own."""
    if row is None:
        w_int, s_w = _weight_int(kernel.to(F32), w_bits)
        return w_int, _col(s_w, w_bits), w_int
    whole, s_w = _weight_int(gather_rows(kernel, row).to(F32), w_bits)
    n = kernel.shape[0]
    return whole.narrow(0, row.model_index * n, n), _col(s_w, w_bits), whole


class _Int8QLinear(torch.autograd.Function):
    """`ofq_tpu.ops.int8_qlinear.int8_qlinear` and its custom VJP: bias ->
    LSQ -> bias -> x @ StatsQ(kernel) on the integer codes, the input's
    residuals only (x, kernel, s, the biases); `tp` the module
    docstring's."""

    @staticmethod
    def forward(ctx, x, kernel, s, b_pre, b_post, w_bits, a_bits,
                all_positive, mm, tp):
        ctx.save_for_backward(x, kernel, s, b_pre, b_post)
        ctx.cfg = (w_bits, a_bits, all_positive, tp)
        row, _ = tp_roles(tp)
        x1 = x + b_pre.to(x.dtype)
        s_eff = _s_eff(s, x1)
        xi = _act_int(x1, s_eff, a_bits, all_positive)
        w_int, col, whole = _tp_weight_int(kernel, w_bits, row)
        acc = model_sum(_code_product(xi, w_int, mm), row)
        # b_post @ w_q == (b_post @ W_int) * col: the batch-independent
        # (out,) correction without a dequantized kernel
        bq = torch.matmul(gather_rows(b_post, row).to(F32), whole) * col
        return (acc.to(F32) * s_eff.to(F32) * col + bq).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, kernel, s, b_pre, b_post = ctx.saved_tensors
        w_bits, a_bits, all_positive, tp = ctx.cfg
        row, cols = tp_roles(tp)
        thd_neg, thd_pos = thresholds(a_bits, all_positive)
        gf = act_grad_scale_factor(
            x.shape, a_bits, all_positive, -2,
            None if row is None else (x.ndim - 1, row.model_parallel))
        x1 = x + b_pre.to(x.dtype)
        s_eff = _s_eff(s, x1)
        u = x1 / s_eff
        in_range = (u >= thd_neg) & (u <= thd_pos)
        xi = torch.round(torch.clamp(u, thd_neg, thd_pos))
        x2 = xi * s_eff + b_post.to(x.dtype)
        w_int, col, _ = _tp_weight_int(kernel, w_bits, row)
        # g @ w_q^T == (g * col) @ W_int^T, stream-dtype operands, fp32 sums
        # (a column-parallel layer's partial sums summed over the group)
        gcol = (g.to(F32) * col).to(g.dtype)
        dx2 = model_sum(_acc32(_rows(gcol), w_int.to(g.dtype).T), cols)
        dx2 = dx2.to(g.dtype).reshape(x.shape)
        dkernel = _acc32(_rows(x2).T, _rows(g))
        db_post = _lead_sum(dx2, 1)
        dx1 = torch.where(in_range, dx2, torch.zeros_like(dx2))
        # the LSQ scale's terms are formed in at least fp32, as the port's
        # `_LsqFused` forms them (XLA keeps a bf16 product that only feeds
        # an fp32 sum in fp32)
        hi = at_least_f32(x.dtype)
        ds_elem = (torch.where(in_range, xi - u, torch.clamp(
            u, thd_neg, thd_pos)).to(hi) * dx2.to(hi)).to(F32)
        axes = tuple(a for a in range(x.ndim) if a != x.ndim - 2)
        ds = (torch.sum(ds_elem, dim=axes).reshape(s.shape) * gf).to(s.dtype)
        db_pre = _lead_sum(dx1, 1)
        return (dx1, dkernel.to(kernel.dtype), ds, db_pre.to(b_pre.dtype),
                db_post.to(b_post.dtype), None, None, None, None, None)


def int8_qlinear(x, kernel, s, b_pre, b_post, w_bits, a_bits, all_positive,
                 mm=int8_mm, tp=None):
    """QLinear's bias -> LSQ -> bias -> @ StatsQ(kernel) (no output bias)
    with the product on the integer codes; `mm` is `int8_mm` or its plain
    version; `tp` the layer's role under tensor parallelism (module
    docstring)."""
    return _Int8QLinear.apply(x, kernel, s, b_pre, b_post, w_bits, a_bits,
                              all_positive, mm, tp)


# ------------------------------------------------- the shared QKR chain
def qkr_int8_codes(x1, s, input_bits):
    """Integer LSQ codes of the (pre-biased) QKR input and the effective
    scale, with LsqAct(channel_axis=-2, signed)'s forward and gradient:
    per-token grad-scale factor, eps clip with identity gradient, STE
    round."""
    gf = act_grad_scale_factor(x1.shape, input_bits, False, -2)
    s_b = _broadcast_scale(s, x1.shape, -2)
    s_eff = grad_scale(clip_lower(s_b, _S_EPS), gf).to(x1.dtype)
    thd_neg, thd_pos = thresholds(input_bits, False)
    xi = round_pass(_clip(x1 / s_eff, thd_neg, thd_pos))
    return xi, s_eff


class _Int8StatsQLinear(torch.autograd.Function):
    """`(xi * s_eff + bx) @ StatsQ(kernel)` on integer-valued `xi`
    (`ofq_tpu.ops.int8_qlinear.int8_statsq_linear`): the int product with
    the column scale after it, the bias folded to `(bx @ W_int) * col`;
    xi kept as an int8 residual.  The arithmetic runs in `dt`, the
    stream's dtype; the cotangents of xi and s_eff come back in their own
    dtypes (fp32 copies of a sharded chain's bf16 inputs take their
    partial sums unrounded: `nn/attention.py:qkr_quant_chain`)."""

    @staticmethod
    def forward(ctx, xi, s_eff, bx, kernel, w_bits, mm, dt):
        ctx.dtypes = (xi.dtype, s_eff.dtype)
        xi, s_eff = xi.to(dt), s_eff.to(dt)
        w_int, s_w = _weight_int(kernel.to(F32), w_bits)
        acc = _code_product(xi, w_int, mm)
        col = _col(s_w, w_bits)
        dot = (acc.to(F32) * col).to(dt)
        bq = (torch.matmul(bx.to(F32), w_int) * col).to(dt)
        ctx.save_for_backward(_codes8(xi), s_eff, bx, kernel, dot)
        ctx.cfg = w_bits
        return dot * s_eff + bq

    @staticmethod
    def backward(ctx, g):
        xi8, s_eff, bx, kernel, dot = ctx.saved_tensors
        w_bits = ctx.cfg
        xi_dt, s_dt = ctx.dtypes
        w_int, s_w = _weight_int(kernel.to(F32), w_bits)
        col = _col(s_w, w_bits)
        gs = (g * s_eff).to(g.dtype)
        gcol = (gs.to(F32) * col).to(g.dtype)
        dxi = _acc32(_rows(gcol), w_int.to(g.dtype).T).to(xi_dt)
        ds_full = torch.sum(g.to(F32) * dot.to(F32), dim=-1, keepdim=True)
        ds_eff = _unbroadcast(ds_full, s_eff.shape).to(s_dt)
        gsum = _lead_sum(g, 1)                                   # (out,)
        dbx = torch.matmul(gsum * col, w_int.T).to(bx.dtype)     # (in,)
        x2 = (xi8.to(g.dtype) * s_eff + bx.to(g.dtype)).to(g.dtype)
        dkernel = _acc32(_rows(x2).T, _rows(g))
        return (dxi.reshape(xi8.shape), ds_eff, dbx, dkernel.to(kernel.dtype),
                None, None, None)


def int8_statsq_linear(xi, s_eff, bx, kernel, w_bits, mm=int8_mm, dt=None):
    """`dt`: the stream's dtype, xi's by default."""
    return _Int8StatsQLinear.apply(xi, s_eff, bx, kernel, w_bits, mm,
                                   dt or xi.dtype)


def _qkx_parts(w_qk3, w_bits):
    """Codes and column scale of the (H, C, C) product, derived on its flat
    (H*C, C) view (rows are the (h, i) pairs), as the composed path's
    `statsq_quantize(w_qk.reshape(H*C, C), reduce_axis=-1)`: (H*C, C)
    codes and (H, C) fp32 column scales."""
    H, C, _ = w_qk3.shape
    w_int, s_w = _weight_int(w_qk3.to(F32).reshape(H * C, C), w_bits,
                             reduce_axis=-1)
    return w_int, _col(s_w, w_bits).reshape(H, C)


def _qkx_codes(xi, w_int, mm):
    """acc[b, n, h, i] = sum_j xi[b, n, j] * W[h, i, j] as int32: one
    (B*N, C) @ (C, H*C) product on the (j, h*i) view of the flat (H*C, C)
    codes; the (B, N, H, C) result is a free view."""
    B, N, _ = xi.shape
    HC, C = w_int.shape
    return _code_product(xi, w_int.T, mm).reshape(B, N, HC // C, C)


class _Int8StatsQQkx(torch.autograd.Function):
    """`einsum('bnj,hij->bnhi', xi * s_eff + bx, StatsQ(w_qk))` on the
    integer codes (`ofq_tpu.ops.int8_qlinear.int8_statsq_qkx`); w_qk the
    raw (H, C, C) product, its StatsQ per row of the (H*C, C) view; `dt`
    and the cotangents' dtypes as `_Int8StatsQLinear`'s."""

    @staticmethod
    def forward(ctx, xi, s_eff, bx, w_qk, w_bits, mm, dt):
        ctx.dtypes = (xi.dtype, s_eff.dtype)
        xi, s_eff = xi.to(dt), s_eff.to(dt)
        w_int, col = _qkx_parts(w_qk, w_bits)
        H, C = col.shape
        acc = _qkx_codes(xi, w_int, mm)
        dot = (acc.to(F32) * col).to(dt)
        w3 = w_int.reshape(H, C, C)
        bq = (torch.einsum("j,hij->hi", bx.to(F32), w3) * col).to(dt)
        ctx.save_for_backward(_codes8(xi), s_eff, bx, w_qk, dot)
        ctx.cfg = w_bits
        return dot * s_eff[..., None] + bq

    @staticmethod
    def backward(ctx, g):
        xi8, s_eff, bx, w_qk, dot = ctx.saved_tensors
        xi_dt, s_dt = ctx.dtypes
        w_int, col = _qkx_parts(w_qk, ctx.cfg)
        B, N, H, C = g.shape
        # dxi = einsum('bnhi,hij->bnj', g * s_eff * w_q): the column scale
        # folded into the lhs, stream-dtype operands, fp32 sums
        gs = (g * s_eff[..., None]).to(g.dtype)
        gcol = (gs.to(F32) * col).to(g.dtype)
        dxi = _acc32(gcol.reshape(B * N, H * C),
                     w_int.to(g.dtype)).to(xi_dt).reshape(B, N, C)
        ds_full = torch.sum(g.to(F32) * dot.to(F32), dim=(-2, -1))[..., None]
        ds_eff = _unbroadcast(ds_full, s_eff.shape).to(s_dt)
        gsum = _lead_sum(g, 2)                                   # (H, C)
        dbx = torch.einsum("hi,hij->j", gsum * col,
                           w_int.reshape(H, C, C)).to(bx.dtype)
        # dW_qk = einsum('bnj,bnhi->hij', x2, g) (StatsQ STE), x2 from the
        # int8 residual
        x2 = (xi8.to(g.dtype) * s_eff + bx.to(g.dtype)).to(g.dtype)
        dw = _acc32(g.reshape(B * N, H * C).T, _rows(x2))
        return (dxi, ds_eff, dbx, dw.reshape(H, C, C).to(w_qk.dtype), None,
                None, None)


def int8_statsq_qkx(xi, s_eff, bx, w_qk, w_bits, mm=int8_mm, dt=None):
    """`dt`: the stream's dtype, xi's by default."""
    return _Int8StatsQQkx.apply(xi, s_eff, bx, w_qk, w_bits, mm,
                                dt or xi.dtype)


# ------------------------------------------------------ frozen serving
def frozen_weight_int(w_q: torch.Tensor, w_scale: torch.Tensor, bits: int):
    """Integer codes of a dequantized StatsQ kernel from its stored
    artifact scale: w_q = s * (2k+1) / 2n, so round(w_q * 2n / s) is 2k+1
    exactly.  StatsQ is not idempotent, so `s` must be the artifact's."""
    n = float(2 ** (bits - 1))
    col = torch.clamp_min(w_scale.to(F32), 1e-12) / (2.0 * n)
    return torch.round(w_q.to(F32) / col), col


def int8_code_dot(xi, w_int, col, mm=int8_mm):
    """The int product on given codes, fp32 (..., out), column-rescaled."""
    return _code_product(xi, w_int, mm).to(F32) * col.reshape(-1)


def frozen_int8_linear(xi, s_eff, bx, w_q, w_scale, bits, mm=int8_mm):
    """Frozen-serving analog of `int8_statsq_linear` (codes from the
    stored scale)."""
    w_int, col = frozen_weight_int(w_q, w_scale, bits)
    bq = torch.matmul(bx.to(F32), w_int) * col.reshape(-1)
    return (int8_code_dot(xi, w_int, col, mm).to(xi.dtype) * s_eff
            + bq.to(xi.dtype))


def frozen_int8_qkx(xi, s_eff, bx, w_qk3, qk_scale, bits, mm=int8_mm):
    """Frozen-serving analog of `int8_statsq_qkx` on the dequantized
    (H, C, C) artifact product, codes from the stored per-row scale
    `qk_scale` (H*C, 1)."""
    H, C, _ = w_qk3.shape
    n = float(2 ** (bits - 1))
    col = (torch.clamp_min(qk_scale.to(F32), 1e-12).reshape(H, C)
           / (2.0 * n))
    w_int = torch.round(w_qk3.to(F32) / col[..., None])
    acc = _qkx_codes(xi, w_int.reshape(H * C, C), mm)
    dot = acc.to(F32) * col
    bq = torch.einsum("j,hij->hi", bx.to(F32), w_int) * col
    return (dot * s_eff[..., None].to(F32) + bq).to(xi.dtype)


def _frozen_int_core(x, w_int, col, s, b_pre, b_post, *, a_bits,
                     all_positive, mm=int8_mm):
    """Inference-only integer-core tail: activation codes, the int product
    on the given weight codes, scales and the bias correction in fp32."""
    x1 = x + b_pre.to(x.dtype)
    s_eff = _s_eff(s, x1)
    xi = _act_int(x1, s_eff, a_bits, all_positive)
    acc = _code_product(xi, w_int, mm)
    bq = torch.matmul(b_post.to(F32), w_int) * col.reshape(-1)
    y = acc.to(F32) * s_eff.to(F32) * col.reshape(-1) + bq
    return y.to(x.dtype)


def frozen_int8_forward(x, w_q, w_scale, s, b_pre, b_post, *, w_bits,
                        a_bits, all_positive, mm=int8_mm):
    """Inference-only integer-core QLinear on a frozen (dequantized)
    kernel: `int8_qlinear`'s factorization with W_int from the stored
    scale."""
    w_int, col = frozen_weight_int(w_q, w_scale, w_bits)
    return _frozen_int_core(x, w_int, col, s, b_pre, b_post, a_bits=a_bits,
                            all_positive=all_positive, mm=mm)


def lsq_int8_eligible(w_bits: int, a_bits: int,
                      act_all_positive: bool = False,
                      w_all_positive: bool = False) -> bool:
    """Full-LSQ integer-core eligibility: signed LSQ weight codes span
    [-2^(b-1), 2^(b-1) - 1] (int8 for b <= 8), unsigned (--wq_asym) ones
    [0, 2^b - 1] (b <= 7); activations as `int8_eligible`."""
    act_ok = a_bits <= (7 if act_all_positive else 8)
    return 2 <= w_bits <= (7 if w_all_positive else 8) and act_ok


def frozen_lsq_weight_int(w_q: torch.Tensor, w_s: torch.Tensor):
    """Integer codes of a dequantized full-LSQ kernel from its learned
    scale: w_q = max(s, 1e-5) * k exactly (`deploy._lsq_encode` /
    `_lsq_decode`), so round(w_q / max(s, 1e-5)) is k.  Returns (codes,
    the (1, out) column scale)."""
    col = torch.clamp_min(w_s.to(F32).reshape(1, -1), _S_EPS)
    return torch.round(w_q.to(F32) / col), col


def frozen_lsq_int8_forward(x, w_q, w_s, s, b_pre, b_post, *, a_bits,
                            all_positive, mm=int8_mm):
    """`frozen_int8_forward` for a full-LSQ kernel: the codes from the
    restored `weight_quant.s` in place of a StatsQ scale."""
    w_int, col = frozen_lsq_weight_int(w_q, w_s)
    return _frozen_int_core(x, w_int, col, s, b_pre, b_post, a_bits=a_bits,
                            all_positive=all_positive, mm=mm)


__all__ = ["frozen_int8_forward", "frozen_int8_linear", "frozen_int8_qkx",
           "frozen_lsq_int8_forward", "frozen_lsq_weight_int",
           "frozen_weight_int", "int8_code_dot", "int8_eligible", "int8_mm",
           "int8_mm_reference", "int8_qlinear", "int8_statsq_linear",
           "int8_statsq_qkx", "lsq_int8_eligible", "qkr_int8_codes"]
