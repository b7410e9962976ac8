"""The input stream (synthetic or ImageFolder) and device-side
mixup/cutmix."""

from .pipeline import (IMAGENET_MEAN, IMAGENET_STD, DataConfig, MixupDraws,
                       make_dataset, mixup_apply, mixup_cutmix, mixup_draws,
                       num_samples, synthetic_batches)

__all__ = [
    "DataConfig", "IMAGENET_MEAN", "IMAGENET_STD", "MixupDraws",
    "make_dataset", "mixup_apply", "mixup_cutmix", "mixup_draws",
    "num_samples", "synthetic_batches",
]
