from .lsq import (grad_scale_factor, init_scale, lsq_quantize,
                  lsq_quantize_dynamic_signed, thresholds)
from .policy import QuantPolicy, QuantSpec, default_deit_qmodules, w2a2_qkr_policy
from .statsq import statsq_b4_round, statsq_quantize, statsq_scale
from .ste import at_least_f32, clip_lower, grad_scale, passthrough, round_pass

__all__ = [
    "QuantPolicy", "QuantSpec", "at_least_f32", "clip_lower",
    "default_deit_qmodules", "grad_scale", "grad_scale_factor", "init_scale",
    "lsq_quantize", "lsq_quantize_dynamic_signed", "passthrough",
    "round_pass", "statsq_b4_round", "statsq_quantize", "statsq_scale",
    "thresholds", "w2a2_qkr_policy",
]
