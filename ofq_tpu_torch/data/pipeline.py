"""The input stream (port of `ofq_tpu/data/pipeline.py`): the synthetic
stream, the ImageFolder pipeline and mixup.

  * `DataConfig` (`:33`) keeps every field of the JAX package's;
  * `synthetic_batches` (`:78`) is numpy with the same seed arithmetic,
    so it yields the JAX package's arrays bit for bit;
  * the ImageFolder listing (`_list_imagefolder`, `:107-124`), the host
    partition with its -1 padding of the eval shards (`:203-215`) and
    `num_samples` are numpy as in JAX, so the file and label lists are
    JAX's element for element;
  * decoding (`decode.py`), the crop (`rrc_crop_params`, `:138-185`), the
    resize (`resize.py`), RandAugment and random erasing (`augment.py`)
    and normalization run image by image in torch ops on the pipeline's
    device; the batch is stacked there and reaches the step without a
    round trip through the host;
  * `mixup_cutmix` (`:298-346`) runs on the device in torch ops, split
    into `mixup_draws`, its six random values drawn from a
    `torch.Generator`, and `mixup_apply`, the mixing: a pure function of
    (batch, draws), which equals JAX's given JAX's draws.

Where the ImageFolder stream differs from JAX's tf.data stream:

  * The train order.  tf.data's 16 384-entry shuffle buffer cannot be
    reproduced in torch: each epoch is one permutation of the host's files
    drawn from `np.random.default_rng((seed, shard_index, epoch))`
    (`epoch_order`), each file `num_aug_repeats` times in a row when set.
    `shuffle_buffer` is not read.
  * The random draws.  One `torch.Generator` on the pipeline's device,
    seeded from `seed` and `shard_index`, drives every draw; per batch the
    uniforms and normals of every image are drawn in one call and read
    back once (`train_draws`), erasing's noise stays on the device.  A port
    run and a JAX run agree transform by transform (given the same draws),
    not batch by batch.

Layout is NHWC throughout; labels are int32.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import os
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.registry import resolve_device
from ..parallel.collectives import flip_partner
from .augment import (ERASING_UNIFORMS, ErasingParams, RandAugmentParams,
                      erasing_params, parse_rand_augment, rand_augment_apply,
                      rand_augment_params, random_erasing_apply, saturate_u8)
from .decode import decode_image
from .resize import resize

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
    # each image `num_aug_repeats` times in a row, each copy with its own
    # draws (timm's RepeatAugSampler)
    num_aug_repeats: int = 0
    # the host partition: a common-seed permutation of the listing strided
    # by host; eval shards padded with label -1
    shard_index: int = 0
    shard_count: int = 1
    # the train split with the deterministic eval transform (calibration)
    eval_transform: bool = False


def _synthetic(data_dir) -> bool:
    return data_dir is None or data_dir in ("synthetic", "")


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


# ----------------------------------------------------- the listing
@functools.lru_cache(maxsize=8)
def _list_imagefolder(data_dir: str, split: str):
    """ImageFolder layout: <root>/<split>/<class>/<img>, `validation`
    falling back to `val`; classes and files sorted (listing cached)."""
    split_dir = os.path.join(data_dir, split)
    if not os.path.isdir(split_dir) and split == "validation":
        split_dir = os.path.join(data_dir, "val")
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    class_idx = {c: i for i, c in enumerate(classes)}
    files, labels = [], []
    for c in classes:
        cdir = os.path.join(split_dir, c)
        for f in sorted(os.listdir(cdir)):
            files.append(os.path.join(cdir, f))
            labels.append(class_idx[c])
    return files, labels, classes


def num_samples(cfg: DataConfig, *, train: bool) -> int:
    """Sample count for epoch sizing (ImageFolder listing or synthetic).
    With num_aug_repeats the epoch stays len(files) long."""
    if _synthetic(cfg.data_dir):
        return cfg.synthetic_length
    files, _, _ = _list_imagefolder(
        cfg.data_dir, "train" if train else "validation")
    return len(files)


def host_files(cfg: DataConfig, *, train: bool) -> tuple[list, list]:
    """This host's (files, labels): with shard_count > 1 a permutation of
    the listing by `seed`, strided by `shard_index`; eval shards padded to
    equal length with the first file under label -1."""
    files, labels, _ = _list_imagefolder(
        cfg.data_dir, "train" if train else "validation")
    if cfg.shard_count > 1:
        order = np.random.default_rng(cfg.seed).permutation(len(files))
        pad = 0 if train else (-len(order)) % cfg.shard_count
        files = [files[i] for i in order] + [files[order[0]]] * pad
        labels = [labels[i] for i in order] + [-1] * pad
        files = files[cfg.shard_index::cfg.shard_count]
        labels = labels[cfg.shard_index::cfg.shard_count]
    return list(files), list(labels)


def epoch_order(cfg: DataConfig, n: int, epoch: int) -> np.ndarray:
    """The port's train order of epoch `epoch` over n files: one
    permutation, each entry `num_aug_repeats` times in a row."""
    order = np.random.default_rng(
        (cfg.seed, cfg.shard_index, epoch)).permutation(n)
    if cfg.num_aug_repeats > 0:
        order = np.repeat(order, cfg.num_aug_repeats)
    return order


def _train_items(cfg, files, labels) -> Iterator[tuple[str, int]]:
    epoch = 0
    while True:
        for i in epoch_order(cfg, len(files), epoch):
            yield files[i], labels[i]
        epoch += 1


# ----------------------------------------------- the random crop
RRC_UNIFORMS = 40


def rrc_crop_params(u: np.ndarray, h: int, w: int, scale
                    ) -> tuple[int, int, int, int]:
    """torchvision's RandomResizedCrop.get_params, as the JAX package
    computes it in fp32, from RRC_UNIFORMS uniforms (area, log-ratio, top,
    left for each of up to 10 proposals): the first proposal that fits,
    offsets inclusive (randint(0, dim - crop + 1)); else a centre crop
    with the aspect ratio clamped to [3/4, 4/3].  (top, left, h, w)."""
    f = np.float32
    area = f(h * w)
    s0, s1 = f(scale[0]), f(scale[1])
    l0, l1 = f(math.log(3 / 4)), f(math.log(4 / 3))
    u = np.asarray(u).reshape(10, 4)
    for i in range(10):
        target = (s0 + f(u[i, 0]) * (s1 - s0)) * area
        ar = np.exp(l0 + f(u[i, 1]) * (l1 - l0))
        nw = int(np.rint(np.sqrt(target * ar)))
        nh = int(np.rint(np.sqrt(target / ar)))
        if 0 < nh <= h and 0 < nw <= w:
            top = min(int(u[i, 2] * (h - nh + 1)), h - nh)
            left = min(int(u[i, 3] * (w - nw + 1)), w - nw)
            return top, left, nh, nw
    in_ratio = f(w) / f(h)
    if in_ratio < f(3 / 4):
        fw, fh = w, int(np.rint(f(w) / f(3 / 4)))
    elif in_ratio > f(4 / 3):
        fw, fh = int(np.rint(f(h) * f(4 / 3))), h
    else:
        fw, fh = w, h
    return (h - fh) // 2, (w - fw) // 2, fh, fw


# ------------------------------------------------ the transforms
class TrainDraws(NamedTuple):
    """Everything random of one train image: the crop (top, left, h, w),
    bicubic (else bilinear), the flip, RandAugment (None without `aa`) and
    the erased rectangle (None when not erased)."""
    crop: tuple
    bicubic: bool
    flip: bool
    rand_augment: Optional[RandAugmentParams]
    erase: Optional[ErasingParams]


def draws_from(u: np.ndarray, z: np.ndarray, hw: tuple[int, int],
               cfg: DataConfig) -> TrainDraws:
    """One image's draws from its uniforms `u` (RRC_UNIFORMS, 2, 3 per
    RandAugment op, ERASING_UNIFORMS) and normals `z` (1 per op), for a
    decoded image of size `hw`."""
    k = RRC_UNIFORMS
    crop = rrc_crop_params(u[:k], hw[0], hw[1], cfg.scale)
    bicubic = int(u[k] * 2) == 0
    flip = bool(u[k + 1] < cfg.hflip)
    k += 2
    ra = None
    if cfg.aa:
        _, mag, std = parse_rand_augment(cfg.aa)
        ra = rand_augment_params(u[k:k + 3 * len(z)], z, mag, std)
    k += 3 * len(z)
    erase = (erasing_params(u[k:k + ERASING_UNIFORMS], cfg.img_size,
                            cfg.img_size, cfg.reprob)
             if cfg.reprob > 0 else None)
    return TrainDraws(crop, bicubic, flip, ra, erase)


def train_draws(generator: torch.Generator, shapes, cfg: DataConfig
                ) -> tuple[list, list]:
    """The draws of a batch of decoded images of sizes `shapes` from
    `generator`: every uniform and normal in one call each, read back to
    the host once; erasing's noise drawn on the generator's device.
    Returns (draws, noises)."""
    n_ops = parse_rand_augment(cfg.aa)[0] if cfg.aa else 0
    n_u = RRC_UNIFORMS + 2 + 3 * n_ops + ERASING_UNIFORMS
    dev = generator.device
    u = torch.rand((len(shapes), n_u), generator=generator, device=dev,
                   dtype=torch.float64)
    z = torch.randn((len(shapes), n_ops), generator=generator, device=dev,
                    dtype=torch.float64)
    host = torch.cat([u, z], 1).cpu().numpy()
    draws, noises = [], []
    for row, hw in zip(host, shapes):
        d = draws_from(row[:n_u], row[n_u:], hw, cfg)
        draws.append(d)
        noises.append(None if d.erase is None else torch.randn(
            (d.erase.height, d.erase.width, 3), generator=generator,
            device=dev))
    return draws, noises


def _normalize(img: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    mean = torch.tensor(cfg.mean, dtype=torch.float32) * 255.0
    std = torch.tensor(cfg.std, dtype=torch.float32) * 255.0
    return (img.to(torch.float32) - mean.to(img.device)) / std.to(img.device)


def train_transform(img: torch.Tensor, d: TrainDraws,
                    noise: Optional[torch.Tensor], cfg: DataConfig
                    ) -> torch.Tensor:
    """JAX's `load_train` after the decode, given the draws: uint8
    (H, W, 3) -> normalized fp32 (img_size, img_size, 3)."""
    top, left, ch, cw = d.crop
    size = cfg.img_size
    x = resize(img[top:top + ch, left:left + cw], (size, size),
               "bicubic" if d.bicubic else "bilinear")
    x = saturate_u8(x)
    if d.flip:
        x = x.flip(1)
    if d.rand_augment is not None:
        x = rand_augment_apply(x, d.rand_augment)
    return random_erasing_apply(_normalize(x, cfg), d.erase, noise)


def eval_transform(img: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    """JAX's `load_eval` after the decode: the shorter side to
    floor(img_size / crop_pct) by bicubic, clipped and rounded, the centre
    crop, normalized."""
    size = cfg.img_size
    h, w = img.shape[0], img.shape[1]
    scale_size = int(math.floor(size / cfg.crop_pct))
    ratio = np.float32(scale_size) / np.float32(min(h, w))
    nh = int(np.rint(np.float32(h) * ratio))
    nw = int(np.rint(np.float32(w) * ratio))
    x = torch.round(resize(img, (nh, nw), "bicubic").clamp(0.0, 255.0))
    top, left = (nh - size) // 2, (nw - size) // 2
    return _normalize(x[top:top + size, left:left + size], cfg)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _imagefolder_batches(cfg: DataConfig, files, labels, *, train: bool,
                         device) -> Iterator[dict]:
    use_train_tf = train and not cfg.eval_transform
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed + 10007 * cfg.shard_index)
    items = (_train_items(cfg, files, labels) if train
             else iter(zip(files, labels)))
    while True:
        # the train stream never ends, so its batches are always full
        chunk = list(itertools.islice(items, cfg.batch_size))
        if not chunk:
            return
        imgs = [decode_image(_read(f), f, device) for f, _ in chunk]
        if use_train_tf:
            draws, noises = train_draws(
                gen, [tuple(i.shape[:2]) for i in imgs], cfg)
            out = [train_transform(i, d, n, cfg)
                   for i, d, n in zip(imgs, draws, noises)]
        else:
            out = [eval_transform(i, cfg) for i in imgs]
        yield {"image": torch.stack(out),
               "label": torch.tensor([lab for _, lab in chunk],
                                     dtype=torch.int32, device=device)}


def make_dataset(cfg: DataConfig, *, train: bool, device="cuda"):
    """An iterator of {'image': f32 NHWC, 'label': i32} batches: the train
    stream repeats without end (full batches), the eval stream is one pass
    (the last batch keeps the remainder).  Synthetic batches are numpy;
    ImageFolder batches are tensors on `device` (CUDA unless the caller
    asks for the CPU)."""
    if _synthetic(cfg.data_dir):
        def gen():
            while True:
                yield from synthetic_batches(cfg, train=train)

        if train:
            return gen()
        return synthetic_batches(cfg, train=False)
    device = resolve_device(device)
    files, labels = host_files(cfg, train=train)
    if not files:
        raise ValueError(f"{cfg.data_dir}: no images in its "
                         f"{'train' if train else 'validation'} split")
    return _imagefolder_batches(cfg, files, labels, train=train,
                                device=device)


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
                label_smoothing: float = 0.1, mesh=None) -> dict:
    """The mixing of `ofq_tpu.data.mixup_cutmix` given its draws, in torch
    ops on the batch's device: {'image', 'label', 'soft_label'}.  The
    batch is paired with its reverse (timm's 'batch' mode); with a
    data-parallel `mesh`, `batch` is this rank's rows of the global batch,
    which is what is reversed (`parallel.collectives.flip_partner`: rank
    r's partners are rank W - 1 - r's rows)."""
    x, y = batch["image"], batch["label"]
    H, W = x.shape[1], x.shape[2]
    dev = x.device
    d = MixupDraws(*(torch.as_tensor(v, device=dev) for v in draws))
    off = label_smoothing / num_classes
    on = 1.0 - label_smoothing + off
    def smoothed(labels):
        return torch.nn.functional.one_hot(labels.long(), num_classes).to(
            torch.float32) * (on - off) + off

    y1 = smoothed(y)
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
    xp = flip_partner(x, mesh)
    x_mix = lam_mix * x + (1 - lam_mix) * xp
    x_cut = torch.where(box, xp, x)
    lam = torch.where(d.use_cutmix, lam_cut_adj.to(torch.float32), lam_mix)
    x_out = torch.where(d.use_cutmix, x_cut, x_mix)
    y_out = lam * y1 + (1 - lam) * smoothed(flip_partner(y, mesh))
    return {"image": torch.where(d.use_mix, x_out, x), "label": y,
            "soft_label": torch.where(d.use_mix, y_out, y1)}


def mixup_cutmix(batch: dict, generator: torch.Generator, *,
                 mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 num_classes: int = 1000, label_smoothing: float = 0.1,
                 mesh=None) -> dict:
    """Device-side mixup/cutmix producing soft labels (timm Mixup analog,
    train.py:604-613): `mixup_draws` from `generator`, then
    `mixup_apply` (with a data-parallel `mesh`, over the global batch;
    the generator must then be seeded alike on every rank)."""
    x = batch["image"]
    draws = mixup_draws(generator, height=x.shape[1], width=x.shape[2],
                        mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                        prob=prob, switch_prob=switch_prob)
    return mixup_apply(batch, draws, num_classes=num_classes,
                       label_smoothing=label_smoothing, mesh=mesh)
