from .losses import hard_ce, kd_soft_and_hard, soft_ce
from .loop import global_norm, make_train_step
from .optim import AdamW, AdamWState, make_optimizer, wd_mask
from .schedule import cosine_with_warmup_cooldown
from .state import TrainState

__all__ = [
    "AdamW", "AdamWState", "TrainState", "cosine_with_warmup_cooldown",
    "global_norm", "hard_ce", "kd_soft_and_hard", "make_optimizer",
    "make_train_step", "soft_ce", "wd_mask",
]
