"""DeiT / ViT, quantized or float (port of `ofq_tpu/models/deit.py:40-162,
178-363, 370-387`).

NHWC images in, logits out.  A distilled model returns `(cls + dist) / 2`
in eval mode and `(cls_logits, dist_logits)` in train mode
(`model.train()`), as the JAX model does with `train=True`.  Submodules
carry the Flax names (`patch_embed`, `blocks_<i>`, `norm1`, `attn`, `mlp`,
`norm`, `head`, `head_dist`), so the port's parameter and buffer names
are the JAX tree paths with '.' for '/'.  Each path is quantized or float
as the policy says: the quantized DeiT of the shipped recipes (W8A8 patch
embedding and heads, QKR attention -- or, without `qk_reparam`,
`QAttention` -- and quantized MLPs in every block; full-LSQ linears
under a policy whose weight and activation modes are both 'lsq') and the
float teacher (empty policy).  LayerNorm, or with
`norm_layer='batchnorm'` the reference's --replace-ln-by-bn swap at every
norm (`BatchNorm`, its running statistics buffers named as JAX's
`batch_stats`).

`forward(x, generator, aux=True)` returns `(logits, aux)` as JAX's model
does: aux is the per-block Gram telemetry (`qqkkvv`; None without it) or,
with `return_features`, `{"attn_infos": ..., "features": [the token
stream after each block]}`; without `aux` the logits alone.  In train mode, dropout after the
position embedding, in the attention and the MLP, and drop-path on each
residual branch at `drop_path_rate * i / max(depth - 1, 1)` for block i,
as in JAX, with masks from the `generator` handed to `forward`
(`nn/dropout.py`); `remat` recomputes every block's activations in the
backward (JAX's `nn.remat(Block)`), the recompute drawing the forward's
masks.

`compute_dtype='bfloat16'` runs the token stream in bf16 from the cast
after `pos_embed` to the final norm (matmuls, residuals, norms and the
activation fake-quant chains; norm statistics, LSQ scale gradients and
every matmul sum in fp32), with fp32 parameters, as JAX's
`DeiTConfig.compute_dtype` does; the patch embedding sees the fp32 image
and the heads stay >= fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch import nn

from ..nn.attention import Attention, QAttention, QAttentionQKR
from ..nn.conv import PatchEmbedConv, QPatchEmbedConv
from ..nn.dropout import checkpointed, drop_path, dropout
from ..nn.linear import Dense, Mlp, QHeadLinear, QMlp
from ..parallel.collectives import active_mesh, sum_over_ranks
from ..quant.policy import QuantPolicy
from ..quant.ste import as_dtype, at_least_f32


@dataclasses.dataclass(frozen=True)
class DeiTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    distilled: bool = True
    ln_eps: float = 1e-6
    in_chans: int = 3
    # 'layernorm', or 'batchnorm' (--replace-ln-by-bn: `BatchNorm` at
    # norm1, norm2 and the final norm)
    norm_layer: str = "layernorm"
    # dropout and stochastic depth, in train mode only (masks from the
    # forward's generator)
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # every block under torch.utils.checkpoint
    remat: bool = False
    # quantized linears: None/'xla' (composition) | 'pallas' (K4, the
    # StatsQ matmul kernel) | 'fused' (K1, the fused QLinear kernel) |
    # 'int8' (the products on the integer codes, `ops/int8_qlinear.py`)
    matmul_impl: Optional[str] = None
    # attention tail: None/'xla' (composition) | 'fused' (K2, K3) |
    # 'remat' (the composition's arithmetic under torch.utils.checkpoint)
    attn_impl: Optional[str] = None
    # None (fp32 stream) | 'bfloat16' (bf16 stream, fp32 parameters)
    compute_dtype: Optional[str] = None
    # the attentions' Gram telemetry (kd_qk, kd_qkv), in `aux`
    qqkkvv: bool = False
    # the token stream after each block in `aux` (kd_token)
    return_features: bool = False

    @property
    def telemetry(self) -> bool:
        """The forward returns telemetry for kd_qk, kd_qkv or kd_token."""
        return self.qqkkvv or self.return_features

    @property
    def n_tokens(self) -> int:
        grid = self.img_size // self.patch_size
        return grid * grid + (2 if self.distilled else 1)


DEIT_TINY = DeiTConfig(embed_dim=192, num_heads=3)
DEIT_SMALL = DeiTConfig(embed_dim=384, num_heads=6)
DEIT_BASE = DeiTConfig(embed_dim=768, num_heads=12)

VARIANTS = {
    "deit_tiny_distilled_patch16_224": DEIT_TINY,
    "deit_small_distilled_patch16_224": DEIT_SMALL,
    "deit_tiny_patch16_224": dataclasses.replace(DEIT_TINY, distilled=False),
    "deit_small_patch16_224": dataclasses.replace(DEIT_SMALL, distilled=False),
    "deit_base_distilled_patch16_224": DEIT_BASE,
    # 2-block toy for tests (not a reference model)
    "deit_test_distilled": DeiTConfig(
        img_size=32, patch_size=8, embed_dim=24, depth=2, num_heads=3),
}


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm` numerics: statistics in >= fp32 with the fast
    variance `E[x^2] - E[x]^2` (clamped at 0), then
    `(x - mean) * (rsqrt(var + eps) * scale) + bias` in >= fp32, returned
    in `compute_dtype` when given (Flax's pinned `dtype`, `make_norm`)."""

    def __init__(self, dim: int, eps: float, compute_dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = as_dtype(compute_dtype)
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(at_least_f32(x.dtype))
        mu = torch.mean(xf, dim=-1, keepdim=True)
        mu2 = torch.mean(xf * xf, dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(xf.dtype)
        y = (xf - mu) * mul + self.bias.to(xf.dtype)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class BatchNorm(nn.Module):
    """Feature-axis BatchNorm with torch `_BatchNorm` semantics (JAX's
    `TorchBatchNorm`): statistics over every axis but the last, in
    `promote(x.dtype, fp32)`; in train mode the biased batch variance
    normalizes and the unbiased one (n = x.numel() // C) feeds the running
    update at `momentum` (torch's convention, new = (1 - m) old + m batch),
    promoted to the statistics' dtype as in JAX; eps 1e-5 (torch's
    BatchNorm default, not the LN's).  `(x - mean) / sqrt(var + eps)`,
    not rsqrt (JAX's comment: the ulp flips STE masks over a trajectory),
    then `* scale + bias`, returned in `compute_dtype` when given, else in
    x's dtype.  `scale` and `bias` are parameters, `mean` and `var`
    buffers.

    Eval mode normalizes with the running statistics.  So does a
    calibrating forward, whatever the mode (JAX calibrates with
    `train=False`), and neither updates them.  A `checkpointed` block's
    recompute (`recomputing` set) uses the batch statistics and leaves
    the running ones alone: they move once per forward, as under JAX's
    `nn.remat`.

    In a data-parallel step (`parallel.collectives.data_parallel`) the
    train-mode statistics are the global batch's, as under JAX's SPMD:
    each rank's sums over its rows are summed over the ranks by an
    all-reduce whose backward all-reduces the cotangent (so each input's
    gradient takes every rank's term), the running update's `n` counts
    the global batch, and a recompute issues the same two all-reduces in
    the same order on every rank."""

    EPS, MOMENTUM = 1e-5, 0.1

    def __init__(self, dim: int, compute_dtype=None):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.calibrating = False
        self.recomputing = False
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.promote_types(x.dtype, torch.float32)
        if not self.training or self.calibrating:
            mean, var = self.mean.to(stat), self.var.to(stat)
        else:
            xf = x.to(stat)
            red = tuple(range(x.ndim - 1))
            mesh = active_mesh()
            n = x.numel() // x.shape[-1] * (mesh.data_world if mesh else 1)
            mean = sum_over_ranks(torch.sum(xf, dim=red), mesh) / n
            var = sum_over_ranks(torch.sum(torch.square(xf - mean), dim=red),
                                 mesh) / n
            if not self.recomputing:
                self._update(mean.detach(),
                             var.detach() * (n / max(n - 1, 1)))
        out = self.compute_dtype or x.dtype
        y = (x.to(stat) - mean) / torch.sqrt(var + self.EPS)
        y = y * self.scale.to(stat) + self.bias.to(stat)
        return y.to(out)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, unbiased: torch.Tensor) -> None:
        m = self.MOMENTUM
        for name, batch in (("mean", mean), ("var", unbiased)):
            old = getattr(self, name)
            new = (1 - m) * old + m * batch
            if new.dtype == old.dtype:
                old.copy_(new)
            else:
                setattr(self, name, new)


def make_norm(norm_layer: str, dim: int, eps: float, compute_dtype=None
              ) -> nn.Module:
    """The models' one norm constructor (JAX's `make_norm`): BatchNorm
    for 'batchnorm' (eps 1e-5 whatever the LN's), else LayerNorm at
    `eps`; both return `compute_dtype` when given."""
    if norm_layer == "batchnorm":
        return BatchNorm(dim, compute_dtype)
    return LayerNorm(dim, eps, compute_dtype)


class Block(nn.Module):
    """Pre-norm transformer block: quantized QKR attention or float
    attention, quantized or float MLP, as the policy says per path, each
    residual branch with drop-path at `drop_path`."""

    def __init__(self, cfg: DeiTConfig, policy: QuantPolicy, index: int,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        C = cfg.embed_dim
        hidden = int(C * cfg.mlp_ratio)
        n_tok = cfg.n_tokens
        cd = cfg.compute_dtype
        # deployment: the kernels already hold dequantized StatsQ values
        frozen = policy.weight_frozen
        wb = 32 if frozen else policy.weight.bit
        fib = policy.frozen_int_bits if frozen else None
        self.norm1 = make_norm(cfg.norm_layer, C, cfg.ln_eps, cd)
        lsq = policy.lsq_weights
        wq = dict(wq_learnable=policy.weight.learnable,
                  wq_all_positive=not policy.weight.symmetric)
        if policy.quantizes(f"blocks.{index}.attn"):
            kw = dict(weight_bits=wb, input_bits=policy.act.bit,
                      quantize_softmax=policy.quantize_softmax,
                      aq_learnable=policy.act.learnable,
                      matmul_impl=cfg.matmul_impl, attn_impl=cfg.attn_impl,
                      compute_dtype=cd, frozen_int_bits=fib,
                      # --apply_q_attn_dropout gates the attention dropout
                      attn_drop=(cfg.attn_drop_rate
                                 if policy.attn_dropout_enabled else 0.0),
                      proj_drop=cfg.drop_rate, qqkkvv=cfg.qqkkvv)
            if policy.qk_reparam:
                self.attn = QAttentionQKR(C, cfg.num_heads, n_tok,
                                          frozen_wqk=frozen, **kw)
            else:
                self.attn = QAttention(C, cfg.num_heads, n_tok, frozen=frozen,
                                       lsq_weights=lsq, **wq, **kw)
        else:
            self.attn = Attention(C, cfg.num_heads,
                                  attn_drop=cfg.attn_drop_rate,
                                  proj_drop=cfg.drop_rate, qqkkvv=cfg.qqkkvv)
        self.norm2 = make_norm(cfg.norm_layer, C, cfg.ln_eps, cd)
        if policy.quantizes(f"blocks.{index}.mlp"):
            self.mlp = QMlp(
                C, hidden, C, n_tok,
                weight_bits=wb, input_bits=policy.act.bit,
                act_layer=policy.act_layer,
                aq_learnable=policy.act.learnable,
                matmul_impl=cfg.matmul_impl, compute_dtype=cd,
                frozen=frozen, frozen_int_bits=fib,
                dropout_rate=cfg.drop_rate, lsq_weights=lsq, **wq)
        else:
            self.mlp = Mlp(C, hidden, C, dropout_rate=cfg.drop_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                info: bool = False):
        return residual_branches(self, x, generator, info)


def residual_branches(block: nn.Module, x: torch.Tensor,
                      generator: Optional[torch.Generator],
                      info: bool = False):
    """x + drop_path(attn(norm1(x))), then the same with the MLP: a DeiT or
    Swin block's forward; with `info`, (x, the attention's info)."""
    kw = dict(train=block.training)
    out = block.attn(block.norm1(x), generator, info=info)
    out, attn_info = out if info else (out, None)
    x = x + drop_path(out, block.drop_path, generator, **kw)
    x = x + drop_path(block.mlp(block.norm2(x), generator),
                      block.drop_path, generator, **kw)
    return (x, attn_info) if info else x


def run_blocks(model: nn.Module, x: torch.Tensor,
               generator: Optional[torch.Generator], aux: bool):
    """`model.block_names` in order, each of `model.remat_names` under
    `checkpointed` when grad is on; with `aux`, (x, [each block's info],
    [the stream after each block]) (a Swin patch merging adds neither),
    else x."""
    infos, feats = [], []
    for name in model.block_names:
        block = getattr(model, name)
        if not hasattr(block, "attn"):  # Swin's patch merging
            x = block(x)
            continue
        fn = functools.partial(block, info=True) if aux else block
        if name in model.remat_names and torch.is_grad_enabled():
            out = checkpointed(fn, x, generator, block)
        else:
            out = fn(x, generator)
        if aux:
            x, attn_info = out
            infos.append(attn_info)
            feats.append(x)
        else:
            x = out
    return (x, infos, feats) if aux else x


class KernelSwitch:
    """`use_kernels` for a whole model: whether CUDA tensors go through the
    hand-written kernels (the default) or through their plain PyTorch
    versions, for comparison.  Set on every submodule that has the flag."""

    def _kernel_users(self):
        return [m for m in self.modules()
                if m is not self and hasattr(m, "use_kernels")]

    @property
    def use_kernels(self) -> bool:
        return all(m.use_kernels for m in self._kernel_users())

    @use_kernels.setter
    def use_kernels(self, flag: bool) -> None:
        for m in self._kernel_users():
            m.use_kernels = bool(flag)


class VisionTransformer(KernelSwitch, nn.Module):
    """DeiT: (B, H, W, 3) NHWC -> (B, classes), or (cls, dist) logits for a
    distilled model in train mode."""

    # the reference's trunc_normal_(std=.02) on every nn.Linear, the float
    # heads included (`init_weights`)
    FLOAT_HEAD_STD = 0.02

    @property
    def lsq_weights(self) -> bool:
        """The quantized linears are full-LSQ (`LsqLinear`)."""
        return self.policy.lsq_weights

    def __init__(self, cfg: DeiTConfig, policy: QuantPolicy):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.compute_dtype = as_dtype(cfg.compute_dtype)
        C = cfg.embed_dim
        grid = cfg.img_size // cfg.patch_size
        if policy.quantizes("patch_embed.proj"):
            self.patch_embed = QPatchEmbedConv(
                cfg.in_chans, C, (cfg.patch_size,) * 2, (cfg.img_size,) * 2)
        else:
            self.patch_embed = PatchEmbedConv(cfg.in_chans, C,
                                              (cfg.patch_size,) * 2)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_tokens, C))
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        self.remat_names = set(self.block_names) if cfg.remat else set()
        for i, name in enumerate(self.block_names):
            dpr = cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
            self.add_module(name, Block(cfg, policy, i, dpr))
        self.norm = make_norm(cfg.norm_layer, C, cfg.ln_eps,
                              cfg.compute_dtype)
        self.head = self._head("head")
        if cfg.distilled:
            self.head_dist = self._head("head_dist")
        self._grid = grid

    def _head(self, path: str) -> nn.Module:
        C, classes = self.cfg.embed_dim, self.cfg.num_classes
        if self.policy.quantizes(path):
            return QHeadLinear(C, classes)
        return Dense(C, classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                aux: bool = False):
        """`generator` (on x's device) draws the dropout and drop-path
        masks in train mode; required there when a rate is above 0.  With
        `aux`, (logits, aux) (see the module docstring)."""
        B = x.shape[0]
        C = self.cfg.embed_dim
        patches = self.patch_embed(x).reshape(B, self._grid * self._grid, C)
        tokens = [self.cls_token.expand(B, 1, C).to(patches.dtype)]
        if self.cfg.distilled:
            tokens.append(self.dist_token.expand(B, 1, C).to(patches.dtype))
        x = torch.cat(tokens + [patches], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x = dropout(x, self.cfg.drop_rate, generator, train=self.training)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = run_blocks(self, x, generator, aux)
        if aux:
            x, infos, feats = x
        # the heads stay >= fp32
        x = self.norm(x)
        x = x.to(at_least_f32(x.dtype))
        if self.cfg.distilled:
            cls_logits = self.head(x[:, 0])
            dist_logits = self.head_dist(x[:, 1])
            logits = ((cls_logits, dist_logits) if self.training
                      else (cls_logits + dist_logits) / 2.0)
        else:
            logits = self.head(x[:, 0])
        if not aux:
            return logits
        infos = infos if self.cfg.qqkkvv else None
        if self.cfg.return_features:
            return logits, {"attn_infos": infos, "features": feats}
        return logits, infos


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std (Flax `truncated_normal`)."""
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=g)


# parameters drawn from truncated-normal 0.02: DeiT's tokens and position
# embedding, Swin's relative-position bias tables
_TRUNC_002 = ("cls_token", "dist_token", "pos_embed",
              "relative_position_bias_table")


def init_weights(model: nn.Module, generator: torch.Generator, *,
                 head_std: Optional[float] = None) -> nn.Module:
    """Random weights with the JAX package's initializers, drawn from
    `generator`: lecun-normal kernels (truncated normal, std
    1/sqrt(fan_in)/0.8796), truncated-normal 0.02 tokens, pos_embed and
    relative-position bias tables, zero biases and shifts, unit norm
    scales, 0.25 PReLU / RPReLU slopes, unit LSQ scales (until
    `calibrate`); BatchNorm's running statistics stay at mean 0, var 1.
    Quantized heads' kernels are
    zero as in JAX unless `head_std` is given; float heads' kernels are
    drawn with the model's `FLOAT_HEAD_STD` (DeiT: truncated-normal 0.02;
    None, Swin: lecun-normal) or `head_std`.  The draws differ from
    jax.random's: same distribution, not the same numbers."""
    lecun_std_unit = 1.0 / 0.87962566103423978
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = name.split(".")[0]
            head = owner in ("head", "head_dist")
            float_head = head and isinstance(getattr(model, owner), Dense)
            std = head_std
            if std is None and float_head:
                std = model.FLOAT_HEAD_STD
            if leaf in _TRUNC_002:
                _trunc_normal_(p, 0.02, generator)
            elif leaf.endswith("kernel") and head and (
                    std is not None or not float_head):
                if std is None:
                    p.zero_()
                else:
                    _trunc_normal_(p, std, generator)
            elif leaf.endswith("kernel"):
                fan_in = math.prod(p.shape[:-1])
                _trunc_normal_(p, lecun_std_unit / math.sqrt(fan_in),
                               generator)
            elif leaf == "alpha":
                # the MLP's PReLU / RPReLU slopes
                p.fill_(0.25)
            elif leaf in ("scale", "s") or leaf.endswith("_scale"):
                # LayerNorm scales, LSQ scales and a frozen artifact's
                # StatsQ scales (ones, as the JAX initializers give them)
                p.fill_(1.0)
            else:
                p.zero_()
    return model


def deit_model(variant: str, policy: QuantPolicy, **overrides: Any
               ) -> VisionTransformer:
    """Constructor by reference model name (parameters uninitialised:
    see `init_weights`, `convert.load_flax_params`)."""
    base = VARIANTS[variant]
    cfg = dataclasses.replace(base, **overrides) if overrides else base
    return VisionTransformer(cfg, policy)
