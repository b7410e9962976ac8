"""The input stream (port of `ofq_tpu/data/pipeline.py`, its synthetic
part and mixup).

  * `DataConfig` (`:33`) keeps every field of the JAX package's;
  * `synthetic_batches` (`:78`) is numpy with the same seed arithmetic,
    so it yields the JAX package's arrays bit for bit; `num_samples` and
    `make_dataset` take the synthetic branch (`:190-196`);
  * `mixup_cutmix` (`:298-346`) runs on the device in torch ops, split
    into `mixup_draws`, its six random values drawn from a
    `torch.Generator`, and `mixup_apply`, the mixing: a pure function of
    (batch, draws), which equals JAX's given JAX's draws.

An ImageFolder `data_dir` raises `NotImplementedError`: its decode and
augmentation (`:198-296`, `data/augment.py`) are not ported yet
(ROADMAP.md, Queue 1 item 7).  Layout is NHWC throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_dir: Optional[str] = None      # None -> synthetic
    img_size: int = 224
    batch_size: int = 128
    num_classes: int = 1000
    crop_pct: float = 0.9
    scale: Tuple[float, float] = (0.08, 1.0)
    aa: Optional[str] = "rand-m9-mstd0.5-inc1"
    reprob: float = 0.25
    hflip: float = 0.5
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD
    shuffle_buffer: int = 16384
    seed: int = 42
    synthetic_length: int = 1024
    num_aug_repeats: int = 0
    shard_index: int = 0
    shard_count: int = 1
    # the train split with the deterministic eval transform (calibration)
    eval_transform: bool = False


def _synthetic(data_dir) -> bool:
    return data_dir is None or data_dir in ("synthetic", "")


def _refuse_imagefolder(data_dir):
    raise NotImplementedError(
        f"data_dir={data_dir!r}: the ImageFolder pipeline (decode and "
        "augmentation) is not ported yet, see ROADMAP.md Queue 1 item 7; "
        "pass 'synthetic'")


def synthetic_batches(cfg: DataConfig, *, train: bool) -> Iterator[dict]:
    """Deterministic synthetic data stream (normalized stats)."""
    rng = np.random.default_rng(
        cfg.seed + 10007 * cfg.shard_index + (0 if train else 1))
    steps = max(cfg.synthetic_length // cfg.batch_size, 1)
    for _ in range(steps):
        yield {
            "image": rng.normal(size=(
                cfg.batch_size, cfg.img_size, cfg.img_size, 3)
            ).astype(np.float32),
            "label": rng.integers(
                0, cfg.num_classes, size=(cfg.batch_size,)).astype(np.int32),
        }


def num_samples(cfg: DataConfig, *, train: bool) -> int:
    """Sample count for epoch sizing."""
    if not _synthetic(cfg.data_dir):
        _refuse_imagefolder(cfg.data_dir)
    return cfg.synthetic_length


def make_dataset(cfg: DataConfig, *, train: bool):
    """An iterator of {'image': f32 NHWC, 'label': i32} numpy batches: the
    train stream repeats without end, the eval stream is one pass."""
    if not _synthetic(cfg.data_dir):
        _refuse_imagefolder(cfg.data_dir)

    def gen():
        while True:
            yield from synthetic_batches(cfg, train=train)

    if train:
        return gen()
    return synthetic_batches(cfg, train=False)


class MixupDraws(NamedTuple):
    """The six random values of one mixup/cutmix call, as 0-d device
    tensors: whether to mix, whether to cut (else mix), the two beta
    draws, and the box centre."""
    use_mix: torch.Tensor
    use_cutmix: torch.Tensor
    lam_mix: torch.Tensor
    lam_cut: torch.Tensor
    cy: torch.Tensor
    cx: torch.Tensor


def _beta(alpha: float, generator: torch.Generator, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw: the first entry of a Dirichlet."""
    a = max(alpha, 1e-8)
    conc = torch.full((2,), a, dtype=torch.float32, device=device)
    return torch._sample_dirichlet(conc, generator=generator)[0]


def mixup_draws(generator: torch.Generator, *, height: int, width: int,
                mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                prob: float = 1.0, switch_prob: float = 0.5) -> MixupDraws:
    """Draw one call's values from `generator`, on its device, without a
    host synchronisation.  As in JAX, the mode is a coin flip only when
    both alphas are active, else cutmix iff its alpha is."""
    dev = generator.device
    u = torch.rand((2,), generator=generator, device=dev)
    use_mix = u[0] < prob
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cutmix = u[1] < switch_prob
    else:
        use_cutmix = torch.tensor(cutmix_alpha > 0.0, device=dev)
    lam_mix = _beta(mixup_alpha, generator, dev)
    lam_cut = _beta(cutmix_alpha, generator, dev)
    cy = torch.randint(0, height, (), generator=generator, device=dev)
    cx = torch.randint(0, width, (), generator=generator, device=dev)
    return MixupDraws(use_mix, use_cutmix, lam_mix, lam_cut, cy, cx)


def mixup_apply(batch: dict, draws: MixupDraws, *, num_classes: int = 1000,
                label_smoothing: float = 0.1) -> dict:
    """The mixing of `ofq_tpu.data.mixup_cutmix` given its draws, in torch
    ops on the batch's device: {'image', 'label', 'soft_label'}.  The
    batch is paired with its reverse (timm's 'batch' mode)."""
    x, y = batch["image"], batch["label"]
    B, H, W = x.shape[0], x.shape[1], x.shape[2]
    dev = x.device
    d = MixupDraws(*(torch.as_tensor(v, device=dev) for v in draws))
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    y1 = torch.nn.functional.one_hot(y.long(), num_classes).to(
        torch.float32) * (on - off) + off
    perm = torch.arange(B - 1, -1, -1, device=dev)
    lam_mix = d.lam_mix.to(torch.float32)
    rh = torch.sqrt(1.0 - d.lam_cut.to(torch.float32))
    ch = (H * rh).to(torch.int32)
    cw = (W * rh).to(torch.int32)
    cy, cx = d.cy.to(torch.int32), d.cx.to(torch.int32)
    y0c = torch.clamp(cy - ch // 2, 0, H)
    x0c = torch.clamp(cx - cw // 2, 0, W)
    y1c = torch.clamp(cy + ch // 2, 0, H)
    x1c = torch.clamp(cx + cw // 2, 0, W)
    rows = torch.arange(H, device=dev)[None, :, None, None]
    cols = torch.arange(W, device=dev)[None, None, :, None]
    box = (rows >= y0c) & (rows < y1c) & (cols >= x0c) & (cols < x1c)
    lam_cut_adj = 1.0 - ((y1c - y0c) * (x1c - x0c)) / (H * W)
    xp = x[perm]
    x_mix = lam_mix * x + (1 - lam_mix) * xp
    x_cut = torch.where(box, xp, x)
    lam = torch.where(d.use_cutmix, lam_cut_adj.to(torch.float32), lam_mix)
    x_out = torch.where(d.use_cutmix, x_cut, x_mix)
    y_out = lam * y1 + (1 - lam) * y1[perm]
    return {"image": torch.where(d.use_mix, x_out, x), "label": y,
            "soft_label": torch.where(d.use_mix, y_out, y1)}


def mixup_cutmix(batch: dict, generator: torch.Generator, *,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 num_classes: int = 1000, label_smoothing: float = 0.1
                 ) -> dict:
    """Device-side mixup/cutmix producing soft labels (timm Mixup analog,
    train.py:604-613): `mixup_draws` from `generator`, then
    `mixup_apply`."""
    x = batch["image"]
    draws = mixup_draws(generator, height=x.shape[1], width=x.shape[2],
                        mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                        prob=prob, switch_prob=switch_prob)
    return mixup_apply(batch, draws, num_classes=num_classes,
                       label_smoothing=label_smoothing)
