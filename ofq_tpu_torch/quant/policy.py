"""Quantization policy (port of `ofq_tpu/quant/policy.py:23-131`).

Models take a `QuantPolicy` at construction and build quantized or float
submodules per path, with the reference's path strings
("blocks.3.attn", "patch_embed.proj", "head", and Swin's torchvision
feature paths "features.1.0.attn", "features.2.reduction", ...).  The
deployment fields serve a packed artifact (`deploy.py`): `weight_frozen`
(the kernels already hold dequantized StatsQ values, so weight fake-quant
is skipped and QKR reads a stored `w_qk_frozen`) and `frozen_int_bits`
(with it, the integer codes are rebuilt from the artifact's stored scales
and the products run on them, `ops/int8_qlinear.py`).  The CGA fields:
`boundary_range` is the finetune's freeze band, which `make_train_step(
cga=...)` takes from the policy (with `qk_reparam`, its selection rule)
and holds `cga` to; `qk_reparam_type` records the recipe's flag and
changes nothing, as in the JAX package, since type 1's in-forward quantizer
equals plain StatsQ (`quant/statsq.py:statsq_quantize_cga`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


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
    qk_reparam_type: int = 0  # 0: QKR, 1: QKR + CGA in-forward quantizer
    boundary_range: float = 0.005
    act_layer: str = "gelu"
    # --apply_q_attn_dropout: 0/3 quantize the post-softmax attention,
    # 0/1 apply the quantized attention's dropout
    q_attn_mode: int = 0
    # deployment: kernels hold dequantized StatsQ values restored from a
    # packed artifact; StatsQ recomputes its scale from live weights and is
    # not idempotent, so weight fake-quant is skipped and QKR reads the
    # stored `w_qk_frozen`.  Activation quantizers and the LSQ-weight heads
    # (idempotent) run as usual.
    weight_frozen: bool = False
    # integer-core serving: with weight_frozen, the artifact's StatsQ scales
    # ride in the param tree (`kernel_scale`, `v_kernel_scale`,
    # `w_qk_scale`, written by `deploy.restore_packed(int_core=True)`) and
    # the codes W_int = round(w_q * 2n / s) feed the int8 products.  None:
    # frozen fp serving.
    frozen_int_bits: int | None = None

    @property
    def quantize_softmax(self) -> bool:
        return self.q_attn_mode in (0, 3)

    @property
    def attn_dropout_enabled(self) -> bool:
        """Whether a quantized attention applies its attention dropout."""
        return self.q_attn_mode in (0, 1)

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


def default_swin_qmodules(depths: Sequence[int] = (2, 2, 6, 2)
                          ) -> tuple[str, ...]:
    """The qmodules list of configs/swin_imagenet_qat.yml (torchvision
    feature paths): the patch-embedding conv, every block's attn and mlp,
    the patch-merging reductions and the head."""
    mods = ["features.0.0"]
    feat_idx = 1
    for stage, depth in enumerate(depths):
        for block in range(depth):
            mods += [f"features.{feat_idx}.{block}.attn",
                     f"features.{feat_idx}.{block}.mlp"]
        feat_idx += 1
        if stage < len(depths) - 1:
            mods.append(f"features.{feat_idx}.reduction")
            feat_idx += 1
    mods.append("head")
    return tuple(mods)


def _w2a2_qkr(qmodules: tuple[str, ...]) -> QuantPolicy:
    return QuantPolicy(
        weight=QuantSpec(mode="statsq", bit=2, learnable=False),
        act=QuantSpec(mode="lsq", bit=2), qmodules=qmodules,
        qk_reparam=True)


def w2a2_qkr_policy(depth: int = 12, distilled: bool = True) -> QuantPolicy:
    """The policy of train_scripts/deit_s/w2a2_deit_s.sh
    (`--wq-bitw 2 --aq-bitw 2 --qk_reparam`)."""
    return _w2a2_qkr(default_deit_qmodules(depth, distilled))


def w2a2_qkr_swin_policy(depths: Sequence[int] = (2, 2, 6, 2)
                         ) -> QuantPolicy:
    """The policy of train_scripts/swin_t/w2a2_swin_t.sh (`--wq-bitw 2
    --aq-bitw 2 --qk_reparam --qk_reparam_type 0`)."""
    return _w2a2_qkr(default_swin_qmodules(depths))
