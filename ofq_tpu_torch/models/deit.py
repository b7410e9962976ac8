"""DeiT / ViT, quantized, eval forward (port of `ofq_tpu/models/deit.py:40-83,
178-363, 370-387`).

NHWC images in, logits out; a distilled model returns `(cls + dist) / 2`.
Submodules carry the Flax names (`patch_embed`, `blocks_<i>`, `norm1`,
`attn`, `mlp`, `norm`, `head`, `head_dist`), so the port's parameter names
are the JAX tree paths with '.' for '/'.  The slice covers the quantized
DeiT of the shipped recipes: W8A8 patch embedding and heads, QKR attention
and quantized MLPs in every block, LayerNorm, no dropout or drop-path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from ..nn.attention import QAttentionQKR
from ..nn.conv import QPatchEmbedConv
from ..nn.linear import QHeadLinear, QMlp
from ..quant.policy import QuantPolicy


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
    # quantized linears: None/'xla' (composition) | 'fused' (CUDA kernel)
    matmul_impl: Optional[str] = None
    # attention tail: None/'xla' (composition) | 'fused' (CUDA kernel)
    attn_impl: Optional[str] = None

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
    `(x - mean) * (rsqrt(var + eps) * scale) + bias`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = torch.mean(xf, dim=-1, keepdim=True)
        mu2 = torch.mean(xf * xf, dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(xf.dtype)
        return (xf - mu) * mul + self.bias.to(xf.dtype)


def _not_in_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP.md, Queue 1)")


class Block(nn.Module):
    """Pre-norm transformer block, quantized QKR attention and MLP."""

    def __init__(self, cfg: DeiTConfig, policy: QuantPolicy, index: int):
        super().__init__()
        C = cfg.embed_dim
        if not (policy.quantizes(f"blocks.{index}.attn")
                and policy.quantizes(f"blocks.{index}.mlp")):
            raise _not_in_slice("a float attention or MLP block")
        if not policy.qk_reparam:
            raise _not_in_slice("QAttention (non-QKR)")
        if policy.lsq_weights:
            raise _not_in_slice("full-LSQ weights (LsqLinear)")
        n_tok = cfg.n_tokens
        self.norm1 = LayerNorm(C, cfg.ln_eps)
        self.attn = QAttentionQKR(
            C, cfg.num_heads, n_tok, weight_bits=policy.weight.bit,
            input_bits=policy.act.bit,
            quantize_softmax=policy.quantize_softmax,
            matmul_impl=cfg.matmul_impl, attn_impl=cfg.attn_impl)
        self.norm2 = LayerNorm(C, cfg.ln_eps)
        self.mlp = QMlp(
            C, int(C * cfg.mlp_ratio), C, n_tok,
            weight_bits=policy.weight.bit, input_bits=policy.act.bit,
            act_layer=policy.act_layer,
            matmul_impl=cfg.matmul_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """Quantized DeiT, eval forward: (B, H, W, 3) NHWC -> (B, classes)."""

    def __init__(self, cfg: DeiTConfig, policy: QuantPolicy):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        C = cfg.embed_dim
        if not (policy.quantizes("patch_embed.proj")
                and policy.quantizes("head")
                and (policy.quantizes("head_dist") or not cfg.distilled)):
            raise _not_in_slice("a float patch embedding or head")
        grid = cfg.img_size // cfg.patch_size
        self.patch_embed = QPatchEmbedConv(
            cfg.in_chans, C, (cfg.patch_size,) * 2, (cfg.img_size,) * 2)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_tokens, C))
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        for name in self.block_names:
            self.add_module(name, Block(cfg, policy, int(name[7:])))
        self.norm = LayerNorm(C, cfg.ln_eps)
        self.head = QHeadLinear(C, cfg.num_classes)
        if cfg.distilled:
            self.head_dist = QHeadLinear(C, cfg.num_classes)
        self._grid = grid

    def _kernel_users(self):
        return [m for m in self.modules()
                if m is not self and hasattr(m, "use_kernels")]

    @property
    def use_kernels(self) -> bool:
        """Whether CUDA tensors go through the hand-written kernels (the
        default) or through their plain PyTorch versions, for comparison."""
        return all(m.use_kernels for m in self._kernel_users())

    @use_kernels.setter
    def use_kernels(self, flag: bool) -> None:
        for m in self._kernel_users():
            m.use_kernels = bool(flag)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        C = self.cfg.embed_dim
        patches = self.patch_embed(x).reshape(B, self._grid * self._grid, C)
        tokens = [self.cls_token.expand(B, 1, C).to(patches.dtype)]
        if self.cfg.distilled:
            tokens.append(self.dist_token.expand(B, 1, C).to(patches.dtype))
        x = torch.cat(tokens + [patches], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.norm(x)
        if self.cfg.distilled:
            return (self.head(x[:, 0]) + self.head_dist(x[:, 1])) / 2.0
        return self.head(x[:, 0])


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal(0, std) truncated at +-2 std (Flax `truncated_normal`)."""
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=g)


def init_weights(model: VisionTransformer, generator: torch.Generator, *,
                 head_std: Optional[float] = None) -> VisionTransformer:
    """Random weights with the JAX package's initializers, drawn from
    `generator`: lecun-normal kernels (truncated normal, std
    1/sqrt(fan_in)/0.8796), truncated-normal 0.02 tokens and pos_embed,
    zero biases, unit LayerNorm scales, unit LSQ scales (until
    `calibrate`).  The heads' kernels are zero as in JAX unless `head_std`
    is given.  The draws differ from jax.random's: same distribution, not
    the same numbers."""
    lecun_std_unit = 1.0 / 0.87962566103423978
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = name.split(".")[0]
            if leaf in ("cls_token", "dist_token", "pos_embed"):
                _trunc_normal_(p, 0.02, generator)
            elif leaf.endswith("kernel") and owner in ("head", "head_dist"):
                if head_std is None:
                    p.zero_()
                else:
                    _trunc_normal_(p, head_std, generator)
            elif leaf.endswith("kernel"):
                fan_in = math.prod(p.shape[:-1])
                _trunc_normal_(p, lecun_std_unit / math.sqrt(fan_in),
                               generator)
            elif leaf in ("scale", "s"):
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
