from .cga import freeze_masks, is_cga_kernel, mask_grads, restore_frozen
from .losses import (dampening_loss, direction_matching, hard_ce,
                     kd_soft_and_hard, kd_soft_hard_qk, kl_token_mse, soft_ce)
from .loop import make_eval_step, make_train_step
from .optim import (AdamW, AdamWState, clip_gradients, ema_update, global_norm,
                    make_optimizer, wd_mask)
from .schedule import constant_lr, cosine_with_warmup_cooldown
from .state import TrainState

__all__ = [
    "AdamW", "AdamWState", "TrainState", "clip_gradients", "constant_lr", "cosine_with_warmup_cooldown",
    "dampening_loss", "direction_matching", "ema_update", "freeze_masks", "global_norm",
    "hard_ce", "is_cga_kernel", "kd_soft_and_hard", "kd_soft_hard_qk",
    "kl_token_mse", "make_eval_step",
    "make_optimizer", "make_train_step", "mask_grads", "restore_frozen",
    "soft_ce", "wd_mask",
]
