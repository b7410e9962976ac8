from .lsq import (grad_scale_factor, init_scale, lsq_quantize,
                  lsq_quantize_dynamic_signed, thresholds)
from .policy import (QuantPolicy, QuantSpec, default_deit_qmodules,
                     default_swin_qmodules, policy_from_args,
                     w2a2_deit_policy, w2a2_policy, w2a2_qkr_policy,
                     w2a2_qkr_swin_policy, w2a2_swin_policy)
from .statsq import (cga_band_mask, outer_freeze_mask, statsq_b4_round,
                     statsq_quantize, statsq_quantize_4d,
                     statsq_quantize_cga, statsq_scale)
from .ste import at_least_f32, clip_lower, grad_scale, passthrough, round_pass

__all__ = [
    "QuantPolicy", "QuantSpec", "at_least_f32", "cga_band_mask",
    "clip_lower",
    "default_deit_qmodules", "default_swin_qmodules", "grad_scale", "grad_scale_factor", "init_scale",
    "lsq_quantize", "lsq_quantize_dynamic_signed", "outer_freeze_mask",
    "passthrough", "policy_from_args",
    "round_pass", "statsq_b4_round", "statsq_quantize",
    "statsq_quantize_4d",
    "statsq_quantize_cga", "statsq_scale",
    "thresholds", "w2a2_deit_policy", "w2a2_policy", "w2a2_qkr_policy",
    "w2a2_qkr_swin_policy", "w2a2_swin_policy",
]
