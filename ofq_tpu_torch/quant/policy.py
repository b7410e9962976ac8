"""Quantization policy (port of `ofq_tpu/quant/policy.py:23-111`).

Models take a `QuantPolicy` at construction and build quantized or float
submodules per path, with the reference's path strings
("blocks.3.attn", "patch_embed.proj", "head", ...).  The deploy-artifact
fields of the JAX policy (`weight_frozen`, `frozen_int_bits`) and the CGA
fields (`qk_reparam_type`, `boundary_range`) belong to later slices.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-site quantizer settings (one of weight or activation)."""

    mode: str = "statsq"  # 'statsq' | 'lsq' | 'identity'
    bit: int = 8
    per_channel: bool = True
    learnable: bool = True
    all_positive: bool = False
    symmetric: bool = True


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Model-wide quantization policy; empty `qmodules` is a float model."""

    weight: QuantSpec = QuantSpec(mode="statsq", bit=8)
    act: QuantSpec = QuantSpec(mode="lsq", bit=8)
    qmodules: tuple[str, ...] = ()
    qk_reparam: bool = False
    act_layer: str = "gelu"
    # --apply_q_attn_dropout: 0/3 quantize the post-softmax attention
    q_attn_mode: int = 0

    @property
    def quantize_softmax(self) -> bool:
        return self.q_attn_mode in (0, 3)

    def quantizes(self, path: str) -> bool:
        return path in self.qmodules

    @property
    def lsq_weights(self) -> bool:
        return self.weight.mode == "lsq" and self.act.mode == "lsq"


def default_deit_qmodules(depth: int = 12,
                          distilled: bool = True) -> tuple[str, ...]:
    """The qmodules list of configs/ours_imagenet_recipe.attn_q.yml."""
    mods = ["patch_embed.proj"]
    for i in range(depth):
        mods += [f"blocks.{i}.attn", f"blocks.{i}.mlp"]
    mods.append("head")
    if distilled:
        mods.append("head_dist")
    return tuple(mods)


def w2a2_qkr_policy(depth: int = 12, distilled: bool = True) -> QuantPolicy:
    """The policy of train_scripts/deit_s/w2a2_deit_s.sh
    (`--wq-bitw 2 --aq-bitw 2 --qk_reparam`)."""
    return QuantPolicy(
        weight=QuantSpec(mode="statsq", bit=2, learnable=False),
        act=QuantSpec(mode="lsq", bit=2),
        qmodules=default_deit_qmodules(depth, distilled),
        qk_reparam=True)
