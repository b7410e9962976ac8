"""Query-key reparameterized quantized attention (port of
`ofq_tpu/nn/attention.py:57-202, 205-234, 271-292, 455-572`, eval forward).

The per-head product `W_qk[h] = Wq[h]^T @ Wk[h]` is StatsQ-quantized as
one (H*C, C) matrix with per-row scales, and the attention logits become
`xq @ (W_qk xq^T)`.  Two implementations of the attention tail, chosen by
`attn_impl`:
  * the composition (einsum -> softmax -> LSQ -> einsum), and
  * 'fused': the CUDA kernel of `ops/fused_attention.py`.
Calibration always runs the composition, so `quan_softmax.s` is set from
the probabilities themselves, never through the kernel (the rule the JAX
package enforces in `_SoftmaxScaleParam`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_attention import (qkr_attention_fwd,
                                   qkr_attention_fwd_reference,
                                   quantized_attention_core, softmax)
from ..quant.lsq import grad_scale_factor
from ..quant.statsq import statsq_quantize
from ..quant.ste import clip_lower, grad_scale
from .bias import LearnableBias
from .linear import QLinear, check_bits
from .quantizers import LsqAct


def qkr_quant_chain(mod: "QAttentionQKR", x: torch.Tensor):
    """Shared QKR scaffold, composed branch: the input quantization shared
    by the v and qkx products, the v path, the quantized per-head W_qk
    product and the 4-D qkx bias/LSQ chain.

    Returns xq (B, N, C), v (B, N, H, d), qkx (B, N, H, C)."""
    B, N, C = x.shape
    H = mod.num_heads
    d = C // H
    xq = mod.quant_x_move_aft(mod.quant_x(mod.quant_x_move_b4(x)))

    vq = statsq_quantize(mod.v_kernel, mod.weight_bits)
    v_out = torch.matmul(xq, vq.to(xq.dtype)) + mod.v_bias.to(xq.dtype)
    v_out = mod.move_v_aft(mod.quan_v(mod.move_v_b4(v_out)))
    v = v_out.reshape(B, N, H, d)

    qh = mod.q_kernel.reshape(C, H, d)
    kh = mod.k_kernel.reshape(C, H, d)
    w_qk = torch.einsum("ihd,jhd->hij", qh, kh).reshape(H * C, C)
    w_qk = statsq_quantize(w_qk, mod.weight_bits, reduce_axis=-1)
    w_qk = w_qk.reshape(H, C, C).to(xq.dtype)

    qkx = torch.einsum("bnj,hij->bnhi", xq, w_qk)
    qkx = mod.move_qkx_aft(mod.quan_qkx(mod.move_qkx_b4(qkx)))
    return xq, v, qkx


def _fused_attention(lhs, rhs, v, scale_param, *, bits, sm_scale,
                     quantize_softmax, fwd):
    """Glue for the fused core: the composition's scale semantics (eps clip
    and grad-scale factor, identity forward up to rounding), then the
    kernel.  lhs (B, N, K) or (B, N, H, K); rhs/v (B, N, H, .)."""
    B, N, H, _ = rhs.shape
    if quantize_softmax:
        gf = grad_scale_factor((B, H, N, N), bits, True, -2)
        s = grad_scale(clip_lower(scale_param, 1e-5), gf)
    else:
        s = torch.ones(N, dtype=torch.float32, device=rhs.device)
    return quantized_attention_core(
        lhs, rhs, v, s, bits=bits, sm_scale=sm_scale,
        quantize_softmax=quantize_softmax, fwd=fwd)


class QAttentionQKR(nn.Module):
    """Query-key reparameterized quantized attention (eval, no dropout).

    `n_tokens` is the sequence length N; the per-token scales
    (`quant_x.s`, `quan_softmax.s`: (N,); `quan_qkx.s`: (N*H,)) depend on it.
    `sm_scale` is `(C // H) ** -0.5` although the QKR contraction runs over
    C, as in the reference.
    """

    def __init__(self, dim: int, num_heads: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int,
                 quantize_softmax: bool = True,
                 matmul_impl: str | None = None,
                 attn_impl: str | None = None):
        super().__init__()
        check_bits(weight_bits=weight_bits, input_bits=input_bits)
        if attn_impl not in (None, "xla", "fused"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r}: the port has the composition and "
                "'fused'")
        C, H = dim, num_heads
        self.num_heads = H
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.quantize_softmax = quantize_softmax
        self.attn_impl = attn_impl
        self.use_kernels = True
        self.calibrating = False

        self.quant_x_move_b4 = LearnableBias(C)
        self.quant_x = LsqAct(input_bits, n_tokens, channel_axis=-2)
        self.quant_x_move_aft = LearnableBias(C)
        self.v_kernel = nn.Parameter(torch.zeros(C, C))
        self.v_bias = nn.Parameter(torch.zeros(C))
        self.move_v_b4 = LearnableBias(C)
        self.quan_v = LsqAct(input_bits, C, channel_axis=-1)
        self.move_v_aft = LearnableBias(C)
        self.q_kernel = nn.Parameter(torch.zeros(C, C))
        self.k_kernel = nn.Parameter(torch.zeros(C, C))
        self.move_qkx_b4 = LearnableBias(H * C, apply_shape=(H, C))
        self.quan_qkx = LsqAct(input_bits, n_tokens * H, channel_axis=(1, 2))
        self.move_qkx_aft = LearnableBias(H * C, apply_shape=(H, C))
        if quantize_softmax:
            self.quan_softmax = LsqAct(input_bits, n_tokens, all_positive=True,
                                       channel_axis=-2)
        self.proj = QLinear(C, C, n_tokens, weight_bits=weight_bits,
                            input_bits=input_bits, matmul_impl=matmul_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        scale = (C // H) ** -0.5
        xq, v, qkx = qkr_quant_chain(self, x)
        if self.attn_impl == "fused" and not self.calibrating:
            sp = self.quan_softmax.s if self.quantize_softmax else None
            out = _fused_attention(
                xq, qkx, v, sp, bits=self.input_bits, sm_scale=scale,
                quantize_softmax=self.quantize_softmax,
                fwd=(qkr_attention_fwd if self.use_kernels
                     else qkr_attention_fwd_reference))
        else:
            attn = softmax(torch.einsum("bnc,bmhc->bhnm", xq, qkx) * scale)
            if self.quantize_softmax:
                attn = self.quan_softmax(attn)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(B, N, C))
