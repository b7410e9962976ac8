"""Swin Transformer (Swin-T), float and W2A2 QKR quantized (port of
`ofq_tpu/models/swin.py:49-669`), for serving and training.

NHWC images in, logits out.  The token map stays 4-D, (B, H, W, C), from
the patch embedding to the final pooling; each block partitions it into
windows of `window_size`² tokens (padding the map to a multiple of the
window, and cyclically shifting it in every second block), runs windowed
attention with a learned relative-position bias (and, in shifted blocks,
the -100 mask between regions that the shift made neighbours), and puts
the windows back.  Patch merging halves the map between stages.  Every
norm (`patch_norm`, each block's two, each patch merging's on the 4-D
map, the final one) is a LayerNorm or, with `norm_layer='batchnorm'`,
the reference's --replace-ln-by-bn swap (`deit.BatchNorm`), as JAX's
`_norm` builds them.

Submodules carry the Flax names (`patch_embed`, `patch_norm`,
`features_<stage>_<block>` with `norm1`, `attn`, `norm2`, `mlp`,
`features_<i>` for a patch merging, `norm`, `head`), so the parameter
names are the JAX tree paths with '.' for '/'.  Each path is quantized or
float as the policy says (`default_swin_qmodules`): the W2A2 QKR student
of `train_scripts/swin_t/w2a2_swin_t.sh` (W8A8 patch embedding and head,
`QSwinAttentionQKR`, quantized MLPs and patch-merging reductions), the
same without `--qk_reparam` (`QSwinAttention`), or the float model, its
warm start and teacher.  As in JAX, a full-LSQ policy builds the StatsQ
linears (Swin reads no `lsq_weights`).  `forward(x, generator,
aux=True)` returns `(logits, the float attentions' Gram telemetry)` under
`qqkkvv` (None otherwise; the quantized window attentions give None).

The quantized MLPs and reductions see the 4-D map, so their per-"token"
LSQ scale runs along its width (one scale per column, shared by the rows),
as in the reference.  `compute_dtype='bfloat16'` runs the stream in bf16
from the cast after `patch_norm` to the final norm, as in JAX.  The
window-attention tail is the composition (the scores also take the bias
and the mask, which the lab kernels of `ops/window_attention.py` do not),
or with `attn_impl='remat'` the same arithmetic under
`torch.utils.checkpoint`, bias and mask inside (JAX's `_remat_swin_tail`;
the composition in train mode with attention dropout).

Under tensor parallelism (`parallel.shard_model`) a window attention
whose heads the model group's width divides holds its heads' columns of
the relative-position bias table and of its linears (`qkv` by head
without QKR), the shift mask stays whole and is added to every local
head, its attention dropout mask is the global draw cut to its heads,
and its `proj` is row-parallel; Swin-T's 3-head stage 0 at 2 ranks runs
whole on every rank.  The float window attention is cut the same way
(`qkv` by head, its bias table's head columns, a row-parallel `proj`),
and a checkpointed tail takes its softmax scale as the composition's
(`nn.attention.tail_scale_param`).  The MLPs on the 4-D map are column- and
row-parallel (fc2's per-width-column input scale sees its channels cut,
its `ds` summed over the group); the patch mergings stay whole.

Train mode: attention and projection dropout in every window attention,
dropout in the MLPs, and drop-path on each residual branch at
`drop_path_rate * i / max(total - 1, 1)` for the i-th block over all
stages, with masks from the `generator` handed to `forward`
(`nn/dropout.py`); the blocks of the stages in `remat_stages` are
recomputed in the backward, their masks replayed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import (QAttention, QAttentionQKR, gram_info,
                            qkr_quant_chain, remat_attention_tail,
                            score_product, tail_scale_param)
from ..nn.conv import PatchEmbedConv, QPatchEmbedConv
from ..nn.dropout import dropout
from ..nn.linear import Dense, Mlp, QHeadLinear, QLinear, QMlp
from ..ops.fused_attention import softmax
from ..quant.policy import QuantPolicy
from ..quant.ste import as_dtype, at_least_f32, weak_scalar
from .deit import KernelSwitch, make_norm, residual_branches, run_blocks


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    # dropout and stochastic depth act in train mode only, with masks from
    # the forward's generator
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    qqkkvv: bool = False
    ln_eps: float = 1e-5
    norm_layer: str = "layernorm"
    # quantized linears: None/'xla' (composition) | 'pallas' (K4) | 'int8'
    matmul_impl: Optional[str] = None
    compute_dtype: Optional[str] = None
    # the stages whose blocks run under torch.utils.checkpoint
    remat_stages: Tuple[int, ...] = ()
    # None/'xla' (composition) | 'remat' (the checkpointed tail)
    attn_impl: Optional[str] = None
    in_chans: int = 3

    @property
    def telemetry(self) -> bool:
        """The forward returns telemetry for kd_qk or kd_qkv."""
        return self.qqkkvv


SWIN_TINY = SwinConfig()

VARIANTS = {
    "swin_t": SWIN_TINY,
    "swin_tiny_patch4_window7_224": SWIN_TINY,
    # 2-stage toy for tests (not a reference model): 2x2 windows -> merge
    # -> a single window
    "swin_test": dataclasses.replace(
        SWIN_TINY, img_size=32, embed_dim=12, depths=(1, 1),
        num_heads=(2, 4), window_size=4, drop_path_rate=0.0),
}


# ---------------------------------------------------------------- geometry
def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """Static relative-position index table, (wh*ww*wh*ww,)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).reshape(-1)


def _shift_attn_mask(pad_h: int, pad_w: int, window: int,
                     shift: int) -> np.ndarray:
    """Static additive mask for shifted windows: (nW, ws*ws, ws*ws) with 0 /
    -100 entries."""
    img = np.zeros((pad_h, pad_w), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(pad_h // window, window, pad_w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C); H, W already padded."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // window) * (W // window), window * window, C)


def window_reverse(x: torch.Tensor, window: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def _pad_shift(x: torch.Tensor, window: int, shift: int):
    """Pad the map to a multiple of the window and roll it by -shift; no
    shift when one window covers the padded map."""
    B, H, W, C = x.shape
    pad_r = (window - W % window) % window
    pad_b = (window - H % window) % window
    if pad_r or pad_b:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    pad_h, pad_w = H + pad_b, W + pad_r
    if window >= pad_h or window >= pad_w:
        shift = 0
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    return x, pad_h, pad_w, shift


def _unshift_unpad(x: torch.Tensor, H: int, W: int, shift: int):
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x[:, :H, :W, :]


# ------------------------------------------------------------- attention
class WindowAttentionBase:
    """The geometry around a window attention (`WindowAttentionBase`):
    partition, shift mask, relative-position bias, reverse.  A mixin for
    nn.Modules that hold `window_size`, `shift_size`, `num_heads` and the
    `relative_position_bias_table` parameter ((2w-1)², H); the static
    index table and masks are made once per device and kept."""

    def _init_window(self, num_heads: int, window_size: int,
                     shift_size: int) -> None:
        self.window_size = window_size
        self.shift_size = shift_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        # (kind, geometry..., device) -> tensor; not a buffer, so it is no
        # entry of the state dict
        self._static = {}

    def _static_tensor(self, key, make, device):
        key = key + (str(device),)
        t = self._static.get(key)
        if t is None:
            t = self._static[key] = torch.from_numpy(make()).to(device)
        return t

    def rel_pos_bias(self) -> torch.Tensor:
        """The (1, H, n, n) bias gathered from the table (callers cast);
        H is the table's columns: this rank's heads under tensor
        parallelism."""
        w = self.window_size
        n = w * w
        table = self.relative_position_bias_table
        idx = self._static_tensor(("index", w), lambda: _rel_pos_index(w, w),
                                  table.device)
        bias = table[idx].reshape(n, n, table.shape[-1])
        return bias.permute(2, 0, 1)[None]

    def geometry(self, x: torch.Tensor):
        B, H, W, _ = x.shape
        w = self.window_size
        xs, pad_h, pad_w, shift = _pad_shift(x, w, self.shift_size)
        tokens = window_partition(xs, w)
        mask = None
        if shift > 0:
            mask = self._static_tensor(
                ("mask", pad_h, pad_w, shift),
                lambda: _shift_attn_mask(pad_h, pad_w, w, shift), x.device)
        return tokens, (B, H, W, pad_h, pad_w, shift), mask

    def finish(self, out_tokens: torch.Tensor, geom) -> torch.Tensor:
        B, H, W, pad_h, pad_w, shift = geom
        x = window_reverse(out_tokens, self.window_size, B, pad_h, pad_w)
        return _unshift_unpad(x, H, W, shift)

    def scores_tail(self, attn: torch.Tensor, mask, geom) -> torch.Tensor:
        """bias -> shift mask -> softmax on the scaled scores (B*nW, H, n, n),
        each added in the scores' dtype."""
        attn = attn + self.rel_pos_bias().to(attn.dtype)
        if mask is not None:
            BnW, nH, n, _ = attn.shape
            nW = mask.shape[0]
            attn = attn.reshape(BnW // nW, nW, nH, n, n)
            attn = attn + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(BnW, nH, n, n)
        return softmax(attn)


class SwinAttention(WindowAttentionBase, nn.Module):
    """Float shifted-window attention: qkv Dense -> q, k, v split from the
    last axis in the natural (B*nW, n, H, d) layout -> scores, bias, mask,
    softmax -> attention dropout -> @v -> proj Dense -> projection
    dropout."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, qqkkvv: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.qqkkvv = qqkkvv
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.tp = None
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self._init_window(num_heads, window_size, shift_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                info: bool = False):
        tokens, geom, mask = self.geometry(x)
        Bn, n, _ = tokens.shape
        H, d, tp = self.num_heads, self.head_dim, self.tp
        q, k, v = (t.reshape(Bn, n, H, d)
                   for t in torch.split(self.qkv(tokens), H * d, dim=-1))
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        attn = self.scores_tail(attn * weak_scalar(d ** -0.5, attn.dtype),
                                mask, geom)
        attn_info = gram_info(attn, q, k, v) if self.qqkkvv else None
        attn = dropout(attn, self.attn_drop, generator, train=self.training,
                       shard=None if tp is None else (1, tp))
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(Bn, n, H * d)
        out = dropout(self.proj(out), self.proj_drop, generator,
                      train=self.training)
        out = self.finish(out, geom)
        return (out, attn_info) if info else out


def _check_window_impl(attn_impl):
    if attn_impl not in (None, "xla", "remat"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r}: Swin's window attention runs the "
            "composition or 'remat' (the fused attention core is not "
            "supported for Swin, as in the JAX package)")


def _window_tail(mod, lhs, rhs, v, spec, mask, geom, generator):
    """The window attention's tail on (Bn, n, ...) `lhs`, `rhs`, `v`: the
    checkpointed tail with bias and mask inside, or the composition."""
    d = v.shape[-1]
    if mod.tail_eligible():
        sp, model = tail_scale_param(mod)
        return remat_attention_tail(
            lhs, rhs, v, sp, bits=mod.input_bits, sm_scale=d ** -0.5,
            quantize_softmax=mod.quantize_softmax,
            aq_learnable=mod.aq_learnable, einsum_spec=spec,
            bias=mod.rel_pos_bias(), mask=mask, model=model)
    attn = score_product(spec, lhs, rhs)
    attn = mod.scores_tail(attn * weak_scalar(d ** -0.5, attn.dtype), mask,
                           geom)
    if mod.quantize_softmax:
        attn = mod.quan_softmax(attn)
    tp = mod.tp
    attn = dropout(attn, mod.attn_drop, generator, train=mod.training,
                   shard=None if tp is None else (1, tp))
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


class QSwinAttention(WindowAttentionBase, QAttention):
    """Quantized window attention without the reparameterization (JAX's
    `QSwinAttention`): `QAttention`'s parameters and q, k, v chain on the
    (B*nW, n, C) window tokens (per-token scales of n = window² entries),
    StatsQ `QLinear`s, then the scores, bias, mask, softmax, `quan_softmax`,
    attention dropout, @v, `proj` and projection dropout; the composed or
    the checkpointed tail, as `QSwinAttentionQKR`.  Its info is None."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, *, attn_impl: Optional[str] = None,
                 frozen_wqk: bool = False, **kw):
        _check_window_impl(attn_impl)
        super().__init__(dim, num_heads, window_size * window_size,
                         attn_impl=attn_impl, frozen=frozen_wqk, **kw)
        self._init_window(num_heads, window_size, shift_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                info: bool = False):
        tokens, geom, mask = self.geometry(x)
        Bn, n, _ = tokens.shape
        q, k, v = self.qkv_chain(tokens)
        out = _window_tail(self, q, k, v, "bnhd,bmhd->bhnm", mask, geom,
                           generator)
        out = self.proj(out.reshape(Bn, n, -1))
        out = dropout(out, self.proj_drop, generator, train=self.training)
        out = self.finish(out, geom)
        return (out, None) if info else out


class QSwinAttentionQKR(WindowAttentionBase, QAttentionQKR):
    """QKR inside windowed attention: `QAttentionQKR`'s parameters and
    quantization chain on the (B*nW, n, C) window tokens, so every
    per-token LSQ scale has n = window² entries; then the scores, bias,
    mask, softmax, the all-positive per-row `quan_softmax`, attention
    dropout, @v, the `proj` QLinear and projection dropout.  The composed
    tail, or with `attn_impl='remat'` the checkpointed one (no attention
    dropout: in train mode with `attn_drop > 0` the composition runs, as
    in JAX)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, *, attn_impl: Optional[str] = None, **kw):
        _check_window_impl(attn_impl)
        super().__init__(dim, num_heads, window_size * window_size,
                         attn_impl=attn_impl, **kw)
        self._init_window(num_heads, window_size, shift_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                info: bool = False):
        tokens, geom, mask = self.geometry(x)
        Bn, n, _ = tokens.shape
        xq, v, qkx = qkr_quant_chain(self, tokens)
        out = _window_tail(self, xq, qkx, v, "bnc,bmhc->bhnm", mask, geom,
                           generator)
        out = self.proj(out.reshape(Bn, n, -1))
        out = dropout(out, self.proj_drop, generator, train=self.training)
        out = self.finish(out, geom)
        return (out, None) if info else out


# ------------------------------------------------------------- structure
def _quantized_kw(policy: QuantPolicy, cfg: SwinConfig,
                  frozen_name: str = "frozen") -> dict:
    """The quantized modules' settings; under a frozen policy (a deployment
    artifact) the weights are 32-bit dequantized levels and
    `frozen_int_bits` comes from the policy, as in JAX."""
    frozen = policy.weight_frozen
    return {"weight_bits": 32 if frozen else policy.weight.bit,
            "input_bits": policy.act.bit,
            "aq_learnable": policy.act.learnable,
            "matmul_impl": cfg.matmul_impl,
            "compute_dtype": cfg.compute_dtype, frozen_name: frozen,
            "frozen_int_bits": policy.frozen_int_bits if frozen else None}


class PatchMerging(nn.Module):
    """2x downsampling: odd sizes padded, the four neighbours of each 2x2
    patch concatenated (B, H/2, W/2, 4C), the norm (a BatchNorm's
    statistics over B, H/2, W/2), then the reduction to
    2C: a quantized QLinear with a bias (the reference's QLinear always
    has one) whose per-"token" LSQ scale runs along the merged map's width
    (`width` entries), or a float Dense without a bias."""

    def __init__(self, dim: int, cfg: SwinConfig, policy: QuantPolicy,
                 qpath: str, width: int):
        super().__init__()
        self.norm = make_norm(cfg.norm_layer, 4 * dim, cfg.ln_eps,
                              cfg.compute_dtype)
        if policy.quantizes(qpath):
            self.reduction = QLinear(4 * dim, 2 * dim, width,
                                     **_quantized_kw(policy, cfg))
        else:
            self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBlock(nn.Module):
    """Pre-norm Swin block on the 4-D map: window attention (QKR quantized
    or float) and the MLP (quantized, with per-width-column input scales,
    or float), each with a residual and drop-path at `drop_path`.
    `width` is the map's width."""

    def __init__(self, cfg: SwinConfig, policy: QuantPolicy, dim: int,
                 num_heads: int, shift: int, attn_path: str, mlp_path: str,
                 width: int, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        cd = cfg.compute_dtype
        geom = dict(window_size=cfg.window_size, shift_size=shift,
                    proj_drop=cfg.drop_rate)
        self.norm1 = make_norm(cfg.norm_layer, dim, cfg.ln_eps, cd)
        if policy.quantizes(attn_path):
            cls = (QSwinAttentionQKR if policy.qk_reparam
                   else QSwinAttention)
            self.attn = cls(
                dim, num_heads, quantize_softmax=policy.quantize_softmax,
                attn_impl=cfg.attn_impl, **geom,
                # --apply_q_attn_dropout gates the attention dropout
                attn_drop=(cfg.attn_drop_rate
                           if policy.attn_dropout_enabled else 0.0),
                **_quantized_kw(policy, cfg, "frozen_wqk"))
        else:
            self.attn = SwinAttention(dim, num_heads, qqkkvv=cfg.qqkkvv,
                                      attn_drop=cfg.attn_drop_rate, **geom)
        self.norm2 = make_norm(cfg.norm_layer, dim, cfg.ln_eps, cd)
        hidden = int(dim * cfg.mlp_ratio)
        if policy.quantizes(mlp_path):
            self.mlp = QMlp(dim, hidden, dim, width,
                            act_layer=policy.act_layer,
                            dropout_rate=cfg.drop_rate,
                            **_quantized_kw(policy, cfg))
        else:
            self.mlp = Mlp(dim, hidden, dim, dropout_rate=cfg.drop_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                info: bool = False):
        return residual_branches(self, x, generator, info)


class SwinTransformer(KernelSwitch, nn.Module):
    """Swin: (B, H, W, 3) NHWC -> (B, classes).  `block_names` lists the
    blocks and patch mergings in the order they run; `remat_names` the
    blocks checkpointed (those of `remat_stages`)."""

    # the JAX head is a default nn.Dense: lecun-normal (`init_weights`)
    FLOAT_HEAD_STD = None
    # Swin's quantized linears are StatsQ ones whatever the policy's modes
    lsq_weights = False

    def __init__(self, cfg: SwinConfig, policy: QuantPolicy):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.compute_dtype = as_dtype(cfg.compute_dtype)
        P = cfg.patch_size
        if policy.quantizes("features.0.0"):
            self.patch_embed = QPatchEmbedConv(
                cfg.in_chans, cfg.embed_dim, (P, P), (cfg.img_size,) * 2)
        else:
            self.patch_embed = PatchEmbedConv(cfg.in_chans, cfg.embed_dim,
                                              (P, P))
        self.patch_norm = make_norm(cfg.norm_layer, cfg.embed_dim,
                                    cfg.ln_eps)
        self.block_names = []
        self.remat_names = set()
        width = cfg.img_size // P
        dim = cfg.embed_dim
        feat_idx = 1
        total, block_id = sum(cfg.depths), 0
        for stage, depth in enumerate(cfg.depths):
            for blk in range(depth):
                name = f"features_{feat_idx}_{blk}"
                shift = 0 if blk % 2 == 0 else cfg.window_size // 2
                sd = cfg.drop_path_rate * block_id / max(total - 1, 1)
                self.add_module(name, SwinBlock(
                    cfg, policy, dim, cfg.num_heads[stage], shift,
                    f"features.{feat_idx}.{blk}.attn",
                    f"features.{feat_idx}.{blk}.mlp", width, sd))
                self.block_names.append(name)
                if stage in cfg.remat_stages:
                    self.remat_names.add(name)
                block_id += 1
            feat_idx += 1
            if stage < len(cfg.depths) - 1:
                name = f"features_{feat_idx}"
                width = (width + 1) // 2
                self.add_module(name, PatchMerging(
                    dim, cfg, policy, f"features.{feat_idx}.reduction",
                    width))
                self.block_names.append(name)
                feat_idx += 1
                dim *= 2
        self.norm = make_norm(cfg.norm_layer, dim, cfg.ln_eps,
                              cfg.compute_dtype)
        if policy.quantizes("head"):
            self.head = QHeadLinear(dim, cfg.num_classes)
        else:
            self.head = Dense(dim, cfg.num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                aux: bool = False):
        """`generator` (on x's device) draws the dropout and drop-path
        masks in train mode; required there when a rate is above 0.  With
        `aux`, (logits, the Gram telemetry under `qqkkvv`, else None)."""
        x = self.patch_norm(self.patch_embed(x))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = run_blocks(self, x, generator, aux)
        if aux:
            x, infos, _ = x
        x = self.norm(x)
        # global average pool; the head stays >= fp32
        x = torch.mean(x, dim=(1, 2))
        logits = self.head(x.to(at_least_f32(x.dtype)))
        if not aux:
            return logits
        return logits, (infos if self.cfg.qqkkvv else None)


def swin_model(variant: str, policy: QuantPolicy, **overrides: Any
               ) -> SwinTransformer:
    """Constructor by reference model name (parameters uninitialised:
    see `deit.init_weights`, `convert.load_flax_params`)."""
    base = VARIANTS[variant]
    cfg = dataclasses.replace(base, **overrides) if overrides else base
    return SwinTransformer(cfg, policy)
