"""Attention: the quantized attentions, with and without the query-key
reparameterization, and the float attention of the teacher (port of
`ofq_tpu/nn/attention.py`).

`QAttention` (no reparameterization) quantizes the qkv and proj linears
(`QLinear`, or `LsqLinear` under full-LSQ weights), q and k per token, v
per channel and the probabilities per row; its fused tail runs K2 and K3
in their per-head form (lhs = q, (B, N, H, d)).

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
With `qqkkvv` each attention also returns its Gram telemetry (`forward(x,
generator, info=True)` gives `(out, info)`): (attn, q q^T, k k^T, v v^T)
/ sqrt(d) per head, of the float q, k, v (`Attention`), of the quantized
ones (`QAttention`), or, under QKR, of the un-reparameterized q and k
projections of the shared quantized input and the quantized v; the
probabilities are then needed, so the tail is the composition.
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

Under tensor parallelism (`parallel.shard_model`: `tp` the mesh) a
`QAttentionQKR` holds `num_heads` of the model's heads (`head_dim` stays
the model's) and the columns, shifts and scales of those heads; its
shared quantized input passes `parallel.copy_to_model` (the v product,
the per-head `x W_qk` and the tail's lhs each give a partial gradient,
summed once over the model group), its softmax scale too (its `ds` sums
over heads; the grad-scale factor counts the model's heads), its
attention dropout mask is cut to its heads, and `proj` is
row-parallel; on the int8 branch the v and qkx products run on its
columns' and heads' codes, their shared codes, scale and shift passing
`copy_to_model`.  With `qqkkvv` its Grams are its heads'.  A sharded `QAttention` holds the q, k and v columns of its heads in a
column-parallel `qkv` (whose input gradient the group sums), its per-token
q and k scales and its softmax scale whole with their `ds` summed over
the group (the grad-scale factors count the model's heads), its heads'
slices of `quan_v` and the shifts, and a row-parallel `proj`.  The float
`Attention` holds its heads' q, k and v columns of a column-parallel
`qkv` and a row-parallel `proj`, its attention dropout mask cut to its
heads.  The checkpointed tail of a sharded attention, as the fused one,
takes its softmax scale through `copy_to_model` with the grad-scale
factor of the model's heads (`tail_scale_param`).  An attention the
group's width does not divide keeps `tp` None and runs whole on every
rank.
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
from ..parallel.tensor import copy_to_model
from ..quant.lsq import act_grad_scale_factor
from ..quant.statsq import statsq_quantize
from ..quant.ste import (as_dtype, at_least_f32, clip_lower, grad_scale,
                         weak_scalar)
from .bias import LearnableBias
from .dropout import dropout
from .linear import Dense, LsqLinear, QLinear, int_product
from .quantizers import LsqAct


def qkr_int8_flags(mod) -> tuple[bool, bool]:
    """(codes, frozen_int) of a QKR attention (`ofq_tpu.nn.attention.
    qkr_int8_flags`): whether its v and qkx products run on the integer
    codes, and whether those codes' weights come from a frozen artifact.
    One definition for QAttentionQKR and QSwinAttentionQKR; off while
    calibrating, so calibration runs the composition."""
    if mod.calibrating or mod.qqkkvv:
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

    Returns xq (B, N, C), v (B, N, H, d), qkx (B, N, H, C) (H: this
    rank's heads under tensor parallelism).  At 32 input bits every
    activation quantizer is the identity."""
    B, N, C = x.shape
    H = mod.num_heads
    d = mod.head_dim
    cd = mod.compute_dtype
    codes, frozen_int = qkr_int8_flags(mod)
    x1 = mod.quant_x_move_b4(x)
    # the fp view (the attention lhs) is built from the composed primitives
    # on every branch, so the s and bx gradients its consumers give are
    # summed in fp32 under the bf16 stream (the fused LSQ VJP, `bias_add`)
    xq = mod.quant_x_move_aft(mod.quant_x(x1))
    xq_v = xq_k = xq
    if mod.tp is not None and cd is None:
        # sharded heads: the three products' partial gradients summed once
        xq = xq_v = xq_k = copy_to_model(xq, mod.tp)
    elif mod.tp is not None and xq.requires_grad:
        # in the bf16 stream each product (v, qkx, the scores) takes xq in
        # fp32, its output rounded to bf16 as a bf16 product rounds it, and
        # its partial gradient is summed over the group in fp32 and rounded
        # once: each product's whole gradient is rounded to bf16 alone, as
        # in one process (without a gradient the products take one
        # process's bf16 operands)
        xq_v, xq_k, xq = (copy_to_model(xq.float(), mod.tp)
                          for _ in range(3))
    if codes:
        mm = int_product(mod)
        s = mod.quant_x.s if mod.quant_x.learnable else mod.quant_x.s.detach()
        xi, s_eff = qkr_int8_codes(x1, s, mod.input_bits)
        bx = mod.quant_x_move_aft.bias
        dt = xi.dtype
        if mod.tp is not None:
            # the v and qkx products on this rank's columns and heads: the
            # partial cotangents of their shared codes, scale and shift
            # summed once over the model group (in at least fp32, rounded
            # to the stream's dtype once, as one process rounds its whole
            # sums)
            hi = at_least_f32(dt)
            xi, s_eff, bx = (copy_to_model(t.to(hi), mod.tp)
                             for t in (xi, s_eff, bx))

    if frozen_int:
        v_out = (frozen_int8_linear(xi, s_eff, bx, mod.v_kernel,
                                    mod.v_kernel_scale, mod.frozen_int_bits,
                                    mm) + mod.v_bias.to(xi.dtype))
    elif codes:
        v_out = (int8_statsq_linear(xi, s_eff, bx, mod.v_kernel,
                                    mod.weight_bits, mm, dt)
                 + mod.v_bias.to(dt))
    else:
        vq = (mod.v_kernel if mod.frozen_wqk or mod.weight_bits >= 32
              else statsq_quantize(mod.v_kernel, mod.weight_bits))
        if cd is not None:
            vq = vq.to(cd)
        v_out = _matmul(xq_v, vq)
        if cd is not None:
            v_out = v_out.to(cd)
        v_out = v_out + mod.v_bias.to(v_out.dtype)
    v_out = mod.move_v_aft(mod.quan_v(mod.move_v_b4(v_out)))
    v = v_out.reshape(B, N, H, d)

    w_qk = _w_qk(mod, H, C, d, codes)
    if frozen_int:
        qkx = frozen_int8_qkx(xi, s_eff, bx, w_qk, mod.w_qk_scale,
                              mod.frozen_int_bits, mm)
    elif codes:
        qkx = int8_statsq_qkx(xi, s_eff, bx, w_qk, mod.weight_bits, mm, dt)
    else:
        if cd is not None:
            w_qk = w_qk.to(cd)
        dt = torch.promote_types(xq_k.dtype, w_qk.dtype)
        qkx = torch.einsum("bnj,hij->bnhi", xq_k.to(dt), w_qk.to(dt))
        if cd is not None:
            qkx = qkx.to(cd)
    qkx = mod.move_qkx_aft(mod.quan_qkx(mod.move_qkx_b4(qkx)))
    return xq, v, qkx


def gram_info(attn, q, k, v):
    """(attn, q q^T, k k^T, v v^T) / sqrt(d) per head of (B, N, H, d)
    q, k, v: JAX's `jnp.einsum(...) * (1.0 / jnp.sqrt(d))`, whose factor
    is an fp32 array (fp64 under x64), so a bf16 Gram comes out fp32."""
    d = q.shape[-1]
    dt = at_least_f32(q.dtype)
    sq = float(1.0 / torch.sqrt(torch.tensor(float(d), dtype=dt)))

    def gram(t):
        return torch.einsum("bnhd,bmhd->bhnm", t, t).to(dt) * sq
    return attn, gram(q), gram(k), gram(v)


def _matmul(a, b):
    """`a @ b` in the promoted dtype, as jnp's `@`."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _tail_scale(scale_param, shape, bits, aq_learnable, model=None):
    """The composition's scale semantics for the fused and remat tails (eps
    clip with identity gradient and the grad-scale factor, so a tail's ds
    is the cotangent of the pre-processed scale); `shape` (B, H, N, N),
    `model` (1, parts) where the heads are sharded."""
    gf = act_grad_scale_factor(shape, bits, True, -2, model)
    s = grad_scale(clip_lower(scale_param, 1e-5), gf)
    return s if aq_learnable else s.detach()


def _fused_attention(lhs, rhs, v, scale_param, *, bits, sm_scale,
                     quantize_softmax, aq_learnable=True,
                     fwd=qkr_attention_fwd, bwd=qkr_attention_bwd,
                     model=None):
    """Glue for the fused core: `_tail_scale`, then the kernels.
    lhs (B, N, K) or (B, N, H, K); rhs/v (B, N, H, .)."""
    B, N, H, _ = rhs.shape
    if quantize_softmax:
        s = _tail_scale(scale_param, (B, H, N, N), bits, aq_learnable, model)
    else:
        s = torch.ones(N, dtype=torch.float32, device=rhs.device)
    return quantized_attention_core(
        lhs, rhs, v, s, bits=bits, sm_scale=sm_scale,
        quantize_softmax=quantize_softmax, fwd=fwd, bwd=bwd)


def tail_scale_param(mod):
    """The softmax scale a fused or checkpointed tail of `mod` takes (None
    without a quantized softmax) and, where its heads are cut over the
    model group, the model axis of its grad-scale factor, the scale
    passing `copy_to_model` (the heads' partial ds summed over the
    group)."""
    sp = mod.quan_softmax.s if mod.quantize_softmax else None
    tp = getattr(mod, "tp", None)
    if tp is None or sp is None:
        return sp, None
    return copy_to_model(sp, tp), (1, tp.model_parallel)


def remat_attention_tail(lhs, rhs, v, scale_param, *, bits, sm_scale,
                         quantize_softmax, aq_learnable, einsum_spec,
                         bias=None, mask=None, model=None):
    """The attention tail under `torch.utils.checkpoint` (JAX's
    `_remat_attention_tail`, and with `bias` and `mask` Swin's
    `_remat_swin_tail`): scores * sm_scale (+ the relative-position bias,
    + the shift mask over its (nW, n, n) windows) -> softmax -> the raw
    LSQ of the probabilities -> @ v, the (B, H, N, N) intermediates
    recomputed in the backward.  The scale is pre-processed outside the
    checkpoint (`_tail_scale`; `model` as there).  Returns (B, N, H, d)."""
    B, N, H, _ = rhs.shape
    s = (_tail_scale(scale_param, (B, H, N, N), bits, aq_learnable, model)
         if quantize_softmax else None)

    def tail(lhs, rhs, v, s, bias):
        attn = score_product(einsum_spec, lhs, rhs)
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


def _check_attn_impl(attn_impl):
    if attn_impl not in (None, "xla", "fused", "remat"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: the port has the composition, "
            "'fused' and 'remat'")


def _tail_eligible(mod) -> bool:
    """Whether the 'fused' or 'remat' tail runs (JAX's `fused_ok`): never
    while calibrating, with the Gram telemetry, at 32 input bits (no
    softmax scale exists), or with attention dropout in train mode, all of
    which need the composition."""
    return (mod.attn_impl in ("fused", "remat") and not mod.calibrating
            and not mod.qqkkvv and mod.input_bits < 32
            and (mod.attn_drop == 0.0 or not mod.training))


def score_product(spec, lhs, rhs):
    """The attention scores `einsum(spec, lhs, rhs)`; a sharded QKR
    attention's fp32 lhs in the bf16 stream: the product in fp32, rounded
    to the stream's dtype."""
    if lhs.dtype == rhs.dtype:
        return torch.einsum(spec, lhs, rhs)
    return torch.einsum(spec, lhs, rhs.to(lhs.dtype)).to(rhs.dtype)


def _tp_softmax(attn, tp, spec, lhs, rhs):
    """`softmax` of a sharded attention's (B, h, N, M) scores
    (`einsum(spec, lhs, rhs)`, the heads on axis 2 of each 4-D operand),
    computed on a tensor of the model's heads laid out as one process's
    einsum lays them out (this rank's at their place, zeros elsewhere):
    the card's row sums take their order from the layout and a row's
    place in it, so this rank's rows get one process's bits (on 3 of 6
    heads the fp32 denominators of a few rows rounded to the other bf16
    neighbour)."""
    B, h, N, M = attn.shape
    lo = tp.model_index * h

    def whole(t):
        shape = list(t.shape)
        if t.ndim == 4:
            shape[2] *= tp.model_parallel
        return torch.empty(shape, dtype=attn.dtype, device="meta")

    probe = torch.einsum(spec, whole(lhs), whole(rhs))
    full = torch.empty_strided(probe.shape, probe.stride(), dtype=attn.dtype,
                               device=attn.device).zero_()
    full[:, lo:lo + h] = attn
    return softmax(full)[:, lo:lo + h]


def _attention_tail(mod, lhs, rhs, v, spec, scale, generator, grams=None):
    """The attention tail of a quantized attention on `lhs` and `rhs`
    (`spec`: their score einsum), through the fused kernels, the remat
    tail or the composition; returns (B, N, H, d) and the Gram info (None
    unless `grams` = (q, k, v) is given: the composition runs then)."""
    tp = getattr(mod, "tp", None)
    tail = dict(bits=mod.input_bits, sm_scale=scale,
                quantize_softmax=mod.quantize_softmax,
                aq_learnable=mod.aq_learnable)
    if _tail_eligible(mod):
        sp, model = tail_scale_param(mod)
        if mod.attn_impl == "fused":
            kernels = ((qkr_attention_fwd, qkr_attention_bwd)
                       if mod.use_kernels else
                       (qkr_attention_fwd_reference,
                        qkr_attention_bwd_reference))
            return _fused_attention(lhs, rhs, v, sp, fwd=kernels[0],
                                    bwd=kernels[1], model=model,
                                    **tail), None
        return remat_attention_tail(lhs, rhs, v, sp, einsum_spec=spec,
                                    model=model, **tail), None
    attn = score_product(spec, lhs, rhs)
    attn = attn * weak_scalar(scale, attn.dtype)
    attn = (softmax(attn) if tp is None
            else _tp_softmax(attn, tp, spec, lhs, rhs))
    info = None if grams is None else gram_info(attn, *grams)
    if mod.quantize_softmax:
        attn = mod.quan_softmax(attn)
    attn = dropout(attn, mod.attn_drop, generator, train=mod.training,
                   shard=None if tp is None else (1, tp))
    return torch.einsum("bhnm,bmhd->bnhd", attn, v), info


class QAttention(nn.Module):
    """Quantized multi-head attention without the reparameterization
    (`ofq_tpu.nn.attention.QAttention`): the `qkv` linear -> `move_qkv_b4`
    -> q, k, v split from the last axis in the natural (B, N, H, d) layout
    -> `quan_q`, `quan_k` per token (N scales), `quan_v` per channel (C)
    -> `move_*_aft` -> the tail on (q, k) per head -> `proj`.  At 32 input
    bits the activation quantizers and shifts do not exist.  The linears
    are `QLinear`s (`matmul_impl`, `compute_dtype`, `frozen`,
    `frozen_int_bits`) or, with `lsq_weights`, `LsqLinear`s
    (`wq_learnable`, `wq_all_positive`, `frozen_int_bits`)."""

    def __init__(self, dim: int, num_heads: int, n_tokens: int, *,
                 weight_bits: int, input_bits: int,
                 quantize_softmax: bool = True, aq_learnable: bool = True,
                 wq_learnable: bool = True, lsq_weights: bool = False,
                 wq_all_positive: bool = False,
                 matmul_impl: str | None = None,
                 attn_impl: str | None = None, compute_dtype=None,
                 frozen: bool = False, frozen_int_bits: int | None = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 qqkkvv: bool = False):
        super().__init__()
        _check_attn_impl(attn_impl)
        C, H = dim, num_heads
        d = C // H
        self.num_heads = H
        self.head_dim = d
        self.tp = None
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.weight_bits = weight_bits
        self.input_bits = input_bits
        self.quantize_softmax = quantize_softmax
        self.aq_learnable = aq_learnable
        self.attn_impl = attn_impl
        self.qqkkvv = qqkkvv
        self.use_kernels = True
        self.calibrating = False
        kw = dict(weight_bits=weight_bits, input_bits=input_bits,
                  aq_learnable=aq_learnable, frozen_int_bits=frozen_int_bits)
        if lsq_weights:
            cls = LsqLinear
            kw.update(wq_learnable=wq_learnable,
                      wq_all_positive=wq_all_positive)
        else:
            cls = QLinear
            kw.update(matmul_impl=matmul_impl,
                      compute_dtype=as_dtype(compute_dtype), frozen=frozen)
        self.qkv = cls(C, 3 * C, n_tokens, **kw)
        lrn = dict(learnable=aq_learnable)
        quantized = input_bits < 32
        if quantized:
            self.move_qkv_b4 = LearnableBias(3 * C)
        self.quan_q = LsqAct(input_bits, n_tokens, channel_axis=1, **lrn)
        self.quan_k = LsqAct(input_bits, n_tokens, channel_axis=1, **lrn)
        self.quan_v = LsqAct(input_bits, C, channel_axis=-1, **lrn)
        if quantized:
            self.move_q_aft = LearnableBias(C, apply_shape=(H, d))
            self.move_k_aft = LearnableBias(C, apply_shape=(H, d))
            self.move_v_aft = LearnableBias(C)
        if quantize_softmax:
            self.quan_softmax = LsqAct(input_bits, n_tokens,
                                       all_positive=True, channel_axis=-2,
                                       **lrn)
        self.proj = cls(C, C, n_tokens, **kw)

    def tail_eligible(self) -> bool:
        return _tail_eligible(self)

    def qkv_chain(self, x: torch.Tensor):
        """q, k, v (B, N, H, d), quantized and shifted (H: this rank's
        heads under tensor parallelism)."""
        B, N, _ = x.shape
        H, d = self.num_heads, self.head_dim
        qkv = self.qkv(x)
        if self.input_bits < 32:
            qkv = self.move_qkv_b4(qkv)
        qs, ks, v = torch.split(qkv, H * d, dim=-1)
        q = self.quan_q(qs.reshape(B, N, H, d))
        k = self.quan_k(ks.reshape(B, N, H, d))
        v = self.quan_v(v)
        if self.input_bits < 32:
            q, k, v = self.move_q_aft(q), self.move_k_aft(k), \
                self.move_v_aft(v)
        return q, k, v.reshape(B, N, H, d)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, info: bool = False):
        B, N, _ = x.shape
        q, k, v = self.qkv_chain(x)
        out, attn_info = _attention_tail(
            self, q, k, v, "bnhd,bmhd->bhnm", self.head_dim ** -0.5,
            generator, (q, k, v) if self.qqkkvv else None)
        out = self.proj(out.reshape(B, N, -1))
        out = dropout(out, self.proj_drop, generator, train=self.training)
        return (out, attn_info) if info else out


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
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 qqkkvv: bool = False):
        super().__init__()
        if frozen_wqk and qqkkvv:
            raise ValueError(
                "deployment artifacts carry only the quantized W_qk "
                "product; qqkkvv Gram telemetry needs the q/k kernels")
        _check_attn_impl(attn_impl)
        compute_dtype = as_dtype(compute_dtype)
        C, H = dim, num_heads
        self.num_heads = H
        self.head_dim = C // H
        self.tp = None
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
        self.qqkkvv = qqkkvv
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
        return _tail_eligible(self)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, info: bool = False):
        B, N, C = x.shape
        H, d = self.num_heads, self.head_dim
        xq, v, qkx = qkr_quant_chain(self, x)
        grams = None
        if self.qqkkvv:
            # q and k from the un-reparameterized projections of the
            # shared quantized input (JAX's QKR analog of the Grams)
            qf = torch.matmul(xq, self.q_kernel.to(xq.dtype))
            kf = torch.matmul(xq, self.k_kernel.to(xq.dtype))
            grams = (qf.reshape(B, N, H, d), kf.reshape(B, N, H, d), v)
        out, attn_info = _attention_tail(self, xq, qkx, v, "bnc,bmhc->bhnm",
                                         d ** -0.5, generator, grams)
        out = self.proj(out.reshape(B, N, H * d))
        out = dropout(out, self.proj_drop, generator, train=self.training)
        return (out, attn_info) if info else out


class Attention(nn.Module):
    """Float multi-head self-attention (`ofq_tpu.nn.attention.Attention`):
    qkv Dense -> einsum -> the division-form softmax -> attention dropout ->
    einsum -> proj Dense -> projection dropout; `qqkkvv` adds the Grams of
    q, k, v to the info."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 qqkkvv: bool = False):
        super().__init__()
        self.qqkkvv = qqkkvv
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp = None
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, info: bool = False):
        B, N, _ = x.shape
        H, d, tp = self.num_heads, self.head_dim, self.tp
        q, k, v = (t.reshape(B, N, H, d)
                   for t in torch.split(self.qkv(x), H * d, dim=-1))
        spec = "bnhd,bmhd->bhnm"
        attn = torch.einsum(spec, q, k)
        attn = attn * weak_scalar(d ** -0.5, attn.dtype)
        attn = (softmax(attn) if tp is None
                else _tp_softmax(attn, tp, spec, q, k))
        attn_info = gram_info(attn, q, k, v) if self.qqkkvv else None
        attn = dropout(attn, self.attn_drop, generator, train=self.training,
                       shard=None if tp is None else (1, tp))
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, H * d)
        out = dropout(self.proj(out), self.proj_drop, generator,
                      train=self.training)
        return (out, attn_info) if info else out
