"""Attention: query-key reparameterized quantized attention and the float
attention of the teacher (port of `ofq_tpu/nn/attention.py:57-202,
205-234, 271-334, 455-572`).

The per-head product `W_qk[h] = Wq[h]^T @ Wk[h]` is StatsQ-quantized as
one (H*C, C) matrix with per-row scales, and the attention logits become
`xq @ (W_qk xq^T)`.  Three implementations of the attention tail, chosen by
`attn_impl`:
  * the composition (einsum -> softmax -> LSQ -> dropout -> einsum),
  * 'fused': the CUDA kernels of `ops/fused_attention.py` (K2 forward, K3
    backward), and
  * 'remat': the tail's arithmetic under `torch.utils.checkpoint`
    (`remat_attention_tail`), its (B, H, N, N) intermediates recomputed in
    the backward instead of kept.
The last two have no attention dropout: in train mode with `attn_drop > 0`
the composition runs, as JAX's eligibility rule says
(`ofq_tpu/nn/attention.py:509-521`); `proj_drop` applies on every path.
Masks come from the generator handed to `forward` (`nn/dropout.py`).
The QKR chain has three implementations of its v and qkx products
(`qkr_quant_chain`): the composition; with `matmul_impl='int8'`, products
on the shared input's integer codes (`ops/int8_qlinear.py`); and, for a
frozen deployment artifact (`frozen_wqk`: the quantized product is stored
as `w_qk_frozen`, there are no q/k kernels) with `frozen_int_bits`, the
same products on codes rebuilt from the artifact's stored scales.
Calibration always runs the composition, so `quan_softmax.s` is set from
the probabilities themselves, never through the kernel (the rule the JAX
package enforces in `_SoftmaxScaleParam`).  Under `compute_dtype`
('bfloat16') the chain and both tails run in that dtype, as in JAX: the
composed tail's softmax in bf16, the fused tail as JAX's bf16 kernels
compute it (fp32 scores and softmax, the quantized probabilities rounded to
bf16 before `@ v`).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.fused_attention import (qkr_attention_bwd,
                                   qkr_attention_bwd_reference,
                                   qkr_attention_fwd,
                                   qkr_attention_fwd_reference,
                                   quantized_attention_core, softmax)
from ..ops.int8_qlinear import (frozen_int8_linear, frozen_int8_qkx,
                                int8_eligible, int8_statsq_linear,
                                int8_statsq_qkx, qkr_int8_codes)
from ..quant.lsq import grad_scale_factor
from ..quant.statsq import statsq_quantize
from ..quant.ste import as_dtype, clip_lower, grad_scale, weak_scalar
from .bias import LearnableBias
from .dropout import dropout
from .linear import Dense, QLinear, check_bits, int_product
from .quantizers import LsqAct


def qkr_int8_flags(mod) -> tuple[bool, bool]:
    """(codes, frozen_int) of a QKR attention (`ofq_tpu.nn.attention.
    qkr_int8_flags`): whether its v and qkx products run on the integer
    codes, and whether those codes' weights come from a frozen artifact.
    One definition for QAttentionQKR and QSwinAttentionQKR; off while
    calibrating, so calibration runs the composition."""
    if mod.calibrating:
        return False, False
    use_int8 = (mod.matmul_impl == "int8" and not mod.frozen_wqk
                and int8_eligible(mod.weight_bits, mod.input_bits))
    frozen_int = (mod.frozen_wqk and mod.frozen_int_bits is not None
                  and int8_eligible(mod.frozen_int_bits, mod.input_bits))
    return use_int8 or frozen_int, frozen_int


def _w_qk(mod, H, C, d, codes):
    """The (H, C, C) per-head product: the stored `w_qk_frozen` of an
    artifact, else Wq^T Wk from the q/k kernels, StatsQ-quantized per row
    of its (H*C, C) view unless the integer branch quantizes it itself."""
    if mod.frozen_wqk:
        return mod.w_qk_frozen
    qh = mod.q_kernel.reshape(C, H, d)
    kh = mod.k_kernel.reshape(C, H, d)
    w_qk = torch.einsum("ihd,jhd->hij", qh, kh)
    if codes:
        return w_qk
    w_qk = statsq_quantize(w_qk.reshape(H * C, C), mod.weight_bits,
                           reduce_axis=-1)
    return w_qk.reshape(H, C, C)


def qkr_quant_chain(mod: "QAttentionQKR", x: torch.Tensor):
    """Shared QKR scaffold (`ofq_tpu.nn.attention.qkr_quant_chain`): the
    input quantization shared by the v and qkx products, the v path, the
    per-head W_qk product and the 4-D qkx bias/LSQ chain; the products
    composed, on the integer codes (int8), or on an artifact's codes
    (frozen int).

    Returns xq (B, N, C), v (B, N, H, d), qkx (B, N, H, C)."""
    B, N, C = x.shape
    H = mod.num_heads
    d = C // H
    cd = mod.compute_dtype
    codes, frozen_int = qkr_int8_flags(mod)
    x1 = mod.quant_x_move_b4(x)
    # the fp view (the attention lhs) is built from the composed primitives
    # on every branch, so the s and bx gradients its consumers give are
    # summed in fp32 under the bf16 stream (the fused LSQ VJP, `bias_add`)
    xq = mod.quant_x_move_aft(mod.quant_x(x1))
    if codes:
        mm = int_product(mod)
        s = mod.quant_x.s if mod.quant_x.learnable else mod.quant_x.s.detach()
        xi, s_eff = qkr_int8_codes(x1, s, mod.input_bits)
        bx = mod.quant_x_move_aft.bias

    if frozen_int:
        v_out = (frozen_int8_linear(xi, s_eff, bx, mod.v_kernel,
                                    mod.v_kernel_scale, mod.frozen_int_bits,
                                    mm) + mod.v_bias.to(xi.dtype))
    elif codes:
        v_out = (int8_statsq_linear(xi, s_eff, bx, mod.v_kernel,
                                    mod.weight_bits, mm)
                 + mod.v_bias.to(xi.dtype))
    else:
        vq = (mod.v_kernel if mod.frozen_wqk
              else statsq_quantize(mod.v_kernel, mod.weight_bits))
        if cd is not None:
            vq = vq.to(cd)
        v_out = _matmul(xq, vq) + mod.v_bias.to(xq.dtype)
    v_out = mod.move_v_aft(mod.quan_v(mod.move_v_b4(v_out)))
    v = v_out.reshape(B, N, H, d)

    w_qk = _w_qk(mod, H, C, d, codes)
    if frozen_int:
        qkx = frozen_int8_qkx(xi, s_eff, bx, w_qk, mod.w_qk_scale,
                              mod.frozen_int_bits, mm)
    elif codes:
        qkx = int8_statsq_qkx(xi, s_eff, bx, w_qk, mod.weight_bits, mm)
    else:
        if cd is not None:
            w_qk = w_qk.to(cd)
        dt = torch.promote_types(xq.dtype, w_qk.dtype)
        qkx = torch.einsum("bnj,hij->bnhi", xq.to(dt), w_qk.to(dt))
    qkx = mod.move_qkx_aft(mod.quan_qkx(mod.move_qkx_b4(qkx)))
    return xq, v, qkx


def _matmul(a, b):
    """`a @ b` in the promoted dtype, as jnp's `@`."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _tail_scale(scale_param, shape, bits, aq_learnable):
    """The composition's scale semantics for the fused and remat tails (eps
    clip with identity gradient and the grad-scale factor, so a tail's ds
    is the cotangent of the pre-processed scale); `shape` (B, H, N, N)."""
    gf = grad_scale_factor(shape, bits, True, -2)
    s = grad_scale(clip_lower(scale_param, 1e-5), gf)
    return s if aq_learnable else s.detach()


def _fused_attention(lhs, rhs, v, scale_param, *, bits, sm_scale,
                     quantize_softmax, aq_learnable=True,
                     fwd=qkr_attention_fwd, bwd=qkr_attention_bwd):
    """Glue for the fused core: `_tail_scale`, then the kernels.
    lhs (B, N, K) or (B, N, H, K); rhs/v (B, N, H, .)."""
    B, N, H, _ = rhs.shape
    if quantize_softmax:
        s = _tail_scale(scale_param, (B, H, N, N), bits, aq_learnable)
    else:
        s = torch.ones(N, dtype=torch.float32, device=rhs.device)
    return quantized_attention_core(
        lhs, rhs, v, s, bits=bits, sm_scale=sm_scale,
        quantize_softmax=quantize_softmax, fwd=fwd, bwd=bwd)


def remat_attention_tail(lhs, rhs, v, scale_param, *, bits, sm_scale,
                         quantize_softmax, aq_learnable, einsum_spec,
                         bias=None, mask=None):
    """The attention tail under `torch.utils.checkpoint` (JAX's
    `_remat_attention_tail`, and with `bias` and `mask` Swin's
    `_remat_swin_tail`): scores * sm_scale (+ the relative-position bias,
    + the shift mask over its (nW, n, n) windows) -> softmax -> the raw
    LSQ of the probabilities -> @ v, the (B, H, N, N) intermediates
    recomputed in the backward.  The scale is pre-processed outside the
    checkpoint (`_tail_scale`).  Returns (B, N, H, d)."""
    B, N, H, _ = rhs.shape
    s = (_tail_scale(scale_param, (B, H, N, N), bits, aq_learnable)
         if quantize_softmax else None)

    def tail(lhs, rhs, v, s, bias):
        attn = torch.einsum(einsum_spec, lhs, rhs)
        attn = attn * weak_scalar(sm_scale, attn.dtype)
        if bias is not None:
            attn = attn + bias.to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B // nW, nW, H, N, N)
            attn = (attn + mask[None, :, None].to(attn.dtype)).reshape(
                B, H, N, N)
        attn = softmax(attn)
        if quantize_softmax:
            thd = 2 ** bits - 1
            sb = s[None, None, :, None].to(attn.dtype)
            u = torch.clamp(attn / sb, 0, thd)
            attn = (u + (torch.round(u) - u).detach()) * sb
        return torch.einsum("bhnm,bmhd->bnhd", attn, v)

    return checkpoint(tail, lhs, rhs, v, s, bias, use_reentrant=False)


class QAttentionQKR(nn.Module):
    """Query-key reparameterized quantized attention, with JAX's attention
    and projection dropout (`attn_drop`, `proj_drop`).

    `n_tokens` is the sequence length N; the per-token scales
    (`quant_x.s`, `quan_softmax.s`: (N,); `quan_qkx.s`: (N*H,)) depend on it.
    `sm_scale` is `(C // H) ** -0.5` although the QKR contraction runs over
    C, as in the reference.  `frozen_wqk` (a deployment artifact: weight
    bits 32, `w_qk_frozen` (H, C, C) in place of the q/k kernels) and
    `frozen_int_bits` (with `v_kernel_scale` (1, C) and `w_qk_scale`
    (H*C, 1), the artifact's scales) as in JAX; `proj` follows them.
    """

    def __init__(self, dim: int, num_heads: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int,
                 quantize_softmax: bool = True,
                 aq_learnable: bool = True,
                 matmul_impl: str | None = None,
                 attn_impl: str | None = None, compute_dtype=None,
                 frozen_wqk: bool = False,
                 frozen_int_bits: int | None = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        check_bits(frozen_wqk, weight_bits=weight_bits,
                   input_bits=input_bits)
        if attn_impl not in (None, "xla", "fused", "remat"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: the port has the composition, "
                "'fused' and 'remat'")
        compute_dtype = as_dtype(compute_dtype)
        C, H = dim, num_heads
        self.num_heads = H
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.quantize_softmax = quantize_softmax
        self.aq_learnable = aq_learnable
        self.attn_impl = attn_impl
        self.matmul_impl = matmul_impl
        self.compute_dtype = compute_dtype
        self.frozen_wqk = frozen_wqk
        self.frozen_int_bits = frozen_int_bits
        self.use_kernels = True
        self.calibrating = False

        lrn = dict(learnable=aq_learnable)
        self.quant_x_move_b4 = LearnableBias(C)
        self.quant_x = LsqAct(input_bits, n_tokens, channel_axis=-2, **lrn)
        self.quant_x_move_aft = LearnableBias(C)
        self.v_kernel = nn.Parameter(torch.zeros(C, C))
        self.v_bias = nn.Parameter(torch.zeros(C))
        self.move_v_b4 = LearnableBias(C)
        self.quan_v = LsqAct(input_bits, C, channel_axis=-1, **lrn)
        self.move_v_aft = LearnableBias(C)
        if frozen_wqk:
            self.w_qk_frozen = nn.Parameter(torch.zeros(H, C, C))
            if frozen_int_bits is not None and int8_eligible(
                    frozen_int_bits, input_bits):
                self.v_kernel_scale = nn.Parameter(torch.ones(1, C))
                self.w_qk_scale = nn.Parameter(torch.ones(H * C, 1))
        else:
            self.q_kernel = nn.Parameter(torch.zeros(C, C))
            self.k_kernel = nn.Parameter(torch.zeros(C, C))
        self.move_qkx_b4 = LearnableBias(H * C, apply_shape=(H, C))
        self.quan_qkx = LsqAct(input_bits, n_tokens * H, channel_axis=(1, 2),
                               **lrn)
        self.move_qkx_aft = LearnableBias(H * C, apply_shape=(H, C))
        if quantize_softmax:
            self.quan_softmax = LsqAct(input_bits, n_tokens, all_positive=True,
                                       channel_axis=-2, **lrn)
        self.proj = QLinear(C, C, n_tokens, weight_bits=weight_bits,
                            input_bits=input_bits, aq_learnable=aq_learnable,
                            matmul_impl=matmul_impl,
                            compute_dtype=compute_dtype, frozen=frozen_wqk,
                            frozen_int_bits=frozen_int_bits)

    def tail_eligible(self) -> bool:
        """Whether the 'fused' or 'remat' tail runs: never while
        calibrating, and not with attention dropout in train mode, which
        needs the probabilities (JAX's `fused_ok`)."""
        return (self.attn_impl in ("fused", "remat") and not self.calibrating
                and (self.attn_drop == 0.0 or not self.training))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        scale = (C // H) ** -0.5
        xq, v, qkx = qkr_quant_chain(self, x)
        sp = self.quan_softmax.s if self.quantize_softmax else None
        tail = dict(bits=self.input_bits, sm_scale=scale,
                    quantize_softmax=self.quantize_softmax,
                    aq_learnable=self.aq_learnable)
        if self.tail_eligible() and self.attn_impl == "fused":
            kernels = ((qkr_attention_fwd, qkr_attention_bwd)
                       if self.use_kernels else
                       (qkr_attention_fwd_reference,
                        qkr_attention_bwd_reference))
            out = _fused_attention(xq, qkx, v, sp, fwd=kernels[0],
                                   bwd=kernels[1], **tail)
        elif self.tail_eligible():
            out = remat_attention_tail(xq, qkx, v, sp,
                                       einsum_spec="bnc,bmhc->bhnm", **tail)
        else:
            attn = torch.einsum("bnc,bmhc->bhnm", xq, qkx)
            attn = softmax(attn * weak_scalar(scale, attn.dtype))
            if self.quantize_softmax:
                attn = self.quan_softmax(attn)
            attn = dropout(attn, self.attn_drop, generator,
                           train=self.training)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        out = self.proj(out.reshape(B, N, C))
        return dropout(out, self.proj_drop, generator, train=self.training)


class Attention(nn.Module):
    """Float multi-head self-attention (`ofq_tpu.nn.attention.Attention`,
    no Gram telemetry): qkv Dense -> einsum -> the division-form softmax ->
    attention dropout -> einsum -> proj Dense -> projection dropout."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        q, k, v = (t.reshape(B, N, H, d)
                   for t in torch.split(self.qkv(x), C, dim=-1))
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        attn = softmax(attn * weak_scalar(d ** -0.5, attn.dtype))
        attn = dropout(attn, self.attn_drop, generator, train=self.training)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return dropout(self.proj(out), self.proj_drop, generator,
                       train=self.training)
