"""Quantization policy (port of `ofq_tpu/quant/policy.py:23-195`).

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
`policy_from_args` builds a policy from the reference's CLI flags, as the
JAX package's does; `lsq_weights` (both modes 'lsq') selects the full-LSQ
linears (`nn/linear.py:LsqLinear`) in DeiT's blocks.
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
    def is_float(self) -> bool:
        return not self.qmodules

    @property
    def lsq_weights(self) -> bool:
        """Both weight and activation in 'lsq' mode: the full-LSQ path
        (reference modules/utils.py:65)."""
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


def policy_from_args(*, wq_enable: bool = True, wq_mode: str = "statsq",
                     wq_bitw: int = 8, wq_per_channel: bool = True,
                     wq_learnable: bool = False, wq_asym: bool = False,
                     aq_enable: bool = True, aq_mode: str = "lsq",
                     aq_bitw: int = 8, aq_per_channel: bool = True,
                     aq_learnable: bool = True, qmodules: Sequence[str] = (),
                     qk_reparam: bool = False, qk_reparam_type: int = 0,
                     boundary_range: float = 0.005, act_layer: str = "gelu",
                     apply_q_attn_dropout: int = 0) -> QuantPolicy:
    """A QuantPolicy from the reference's CLI flags, as
    `ofq_tpu.quant.policy_from_args` builds it: the weight bits fall back
    to identity unless `wq_bitw < 32` and `aq_enable` (the reference's
    train.py:402), the activation spec to identity (bit 32) unless
    `aq_enable` and `aq_bitw < 32`; `--wq_asym` needs `--wq-mode lsq`."""
    w_mode = wq_mode if wq_enable else "identity"
    w_bits_valid = wq_bitw < 32 and aq_enable
    if wq_asym and w_mode == "statsq" and w_bits_valid:
        raise ValueError(
            "--wq_asym requires --wq-mode lsq: StatsQ's scale defines a "
            "symmetric mid-rise grid with no asymmetric form")
    weight = QuantSpec(mode=w_mode if w_bits_valid else "identity",
                       bit=wq_bitw if w_bits_valid else 32,
                       per_channel=wq_per_channel, learnable=wq_learnable,
                       all_positive=wq_asym, symmetric=not wq_asym)
    a_bits_valid = aq_enable and aq_bitw < 32
    act = QuantSpec(mode=aq_mode if a_bits_valid else "identity",
                    bit=aq_bitw if a_bits_valid else 32,
                    per_channel=aq_per_channel, learnable=aq_learnable)
    return QuantPolicy(weight=weight, act=act, qmodules=tuple(qmodules),
                       qk_reparam=qk_reparam,
                       qk_reparam_type=qk_reparam_type,
                       boundary_range=boundary_range, act_layer=act_layer,
                       q_attn_mode=int(apply_q_attn_dropout))


# the flags of train_scripts/{deit_s,swin_t}/w2a2_*.sh's first phase
W2A2_FLAGS = dict(wq_enable=True, wq_mode="statsq", wq_bitw=2,
                  wq_per_channel=True, aq_enable=True, aq_mode="lsq",
                  aq_bitw=2, aq_per_channel=True, aq_learnable=True,
                  qk_reparam=True, qk_reparam_type=0)


def w2a2_policy(qmodules: Sequence[str], *, qk_reparam: bool = True,
                wq_mode: str = "statsq") -> QuantPolicy:
    """The W2A2 recipe's policy over `qmodules`, with `--qk_reparam`
    dropped (`qk_reparam=False`: the non-QKR `QAttention`) or `--wq-mode
    lsq` (`wq_mode="lsq"`: full-LSQ weights)."""
    return policy_from_args(**dict(W2A2_FLAGS, qk_reparam=qk_reparam,
                                   wq_mode=wq_mode), qmodules=qmodules)


def w2a2_deit_policy(depth: int = 12, distilled: bool = True, *,
                     qk_reparam: bool = True,
                     wq_mode: str = "statsq") -> QuantPolicy:
    """`w2a2_policy` over DeiT's qmodules: the W2A2 recipe without QKR
    (`qk_reparam=False`) or with full-LSQ weights (`wq_mode="lsq"`)."""
    return w2a2_policy(default_deit_qmodules(depth, distilled),
                       qk_reparam=qk_reparam, wq_mode=wq_mode)


def w2a2_swin_policy(depths: Sequence[int] = (2, 2, 6, 2), *,
                     qk_reparam: bool = True,
                     wq_mode: str = "statsq") -> QuantPolicy:
    """`w2a2_policy` over Swin-T's qmodules."""
    return w2a2_policy(default_swin_qmodules(depths),
                       qk_reparam=qk_reparam, wq_mode=wq_mode)
