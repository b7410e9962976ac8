"""RandAugment and random erasing in torch ops on the image's device (port
of `ofq_tpu/data/augment.py`).

The arithmetic is the JAX package's, not PIL's: `blend` clamps and then
truncates (`tf.saturate_cast`), `rgb_to_grayscale` goes through
`convert_image_dtype` (x / 255, the weights (0.2989, 0.5870, 0.1140), then
x 255.5 and truncate), posterize keeps 4 - int(m / 10 * 4) bits, equalize
uses the 256-bin histogram and its LUT, sharpness is a VALID 3 x 3 smoothing
padded SYMMETRIC, and the affine ops are gather shifts that fill with 128
(rotate is three shears).  Scalars derived from the magnitude (factors,
thresholds, shifts) are computed on the host in fp32 as TensorFlow computes
them, so an op given the same magnitude and sign gives the JAX op's pixels.

Each random piece is split into its draws and its application:
`rand_augment_params` / `rand_augment_apply` and `erasing_params` /
`random_erasing_apply` take the values that the pipeline drew
(`pipeline.train_draws`), so a test can hand the application fixed values
and the same draws can run on two devices.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

_MAX_LEVEL = np.float32(10.0)
_FILL = 128
# the op set of `ofq_tpu.data.augment.rand_augment`, in its order
OPS = ("autocontrast", "equalize", "invert", "rotate", "posterize",
       "solarize", "solarize_add", "color", "contrast", "brightness",
       "sharpness", "shear_x", "shear_y", "translate_x", "translate_y")
# the ops that draw a sign inside JAX
SIGNED = frozenset(("rotate", "color", "contrast", "brightness", "sharpness",
                    "shear_x", "shear_y", "translate_x", "translate_y"))
_F32 = np.float32


def _level(mag) -> np.float32:
    return _F32(mag) / _MAX_LEVEL


def saturate_u8(x: torch.Tensor) -> torch.Tensor:
    """`tf.saturate_cast(x, tf.uint8)` of a float tensor: clamp, truncate."""
    return x.clamp(0.0, 255.0).to(torch.uint8)


def blend(a: torch.Tensor, b: torch.Tensor, factor) -> torch.Tensor:
    af = a.to(torch.float32)
    return saturate_u8(af + float(factor) * (b.to(torch.float32) - af))


def enhance_factor(mag, sign) -> np.float32:
    """'inc' mapping: 1 + sign * (m / 10) * 0.9, in fp32."""
    return _F32(1.0) + _F32(sign) * _level(mag) * _F32(0.9)


def rgb_to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) -> uint8 (H, W, 1), as `tf.image.rgb_to_grayscale`."""
    f = img.to(torch.float32) * float(_F32(1.0 / 255.0))
    g = (f[..., 0:1] * float(_F32(0.2989)) + f[..., 1:2] * float(
        _F32(0.5870))) + f[..., 2:3] * float(_F32(0.1140))
    return (g * 255.5).to(torch.uint8)


# ------------------------------------------------------------ the ops
def autocontrast(img: torch.Tensor) -> torch.Tensor:
    f = img.to(torch.float32)
    lo = f.amin(dim=(0, 1))
    hi = f.amax(dim=(0, 1))
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    # tensor / tensor: an IEEE division on every device (a Python number
    # over a tensor is a reciprocal times the number)
    scaled = saturate_u8((f - lo) * (torch.full_like(span, 255.0) / span))
    return torch.where(hi > lo, scaled, img)


def equalize(img: torch.Tensor) -> torch.Tensor:
    h, w, _ = img.shape
    v = img.reshape(-1, 3).T.to(torch.int64)              # (3, HW)
    histo = torch.zeros((3, 256), dtype=torch.int64, device=img.device)
    histo.scatter_add_(1, v, torch.ones_like(v))
    # the last non-zero bin is the channel's largest value
    last = histo.gather(1, v.amax(dim=1, keepdim=True))
    step = (h * w - last) // 255                           # (3, 1)
    safe = torch.where(step == 0, torch.ones_like(step), step)
    lut = (torch.cumsum(histo, 1) + safe // 2) // safe
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], 1)
    lut = lut.clamp(0, 255)
    out = lut.gather(1, v)
    out = torch.where(step == 0, v, out)
    return out.T.reshape(h, w, 3).to(torch.uint8)


def invert(img: torch.Tensor) -> torch.Tensor:
    return 255 - img


def posterize(img: torch.Tensor, mag) -> torch.Tensor:
    bits_kept = 4 - int(_level(mag) * _F32(4.0))
    shift = min(max(8 - bits_kept, 0), 8)
    return ((img.to(torch.int32) >> shift) << shift).to(torch.uint8)


def solarize(img: torch.Tensor, mag) -> torch.Tensor:
    thresh = int(_F32(256.0) - _level(mag) * _F32(256.0))
    i = img.to(torch.int32)
    return torch.where(i < thresh, i, 255 - i).to(torch.uint8)


def solarize_add(img: torch.Tensor, mag) -> torch.Tensor:
    add = int(_level(mag) * _F32(110.0))
    i = img.to(torch.int32)
    return torch.where(i < 128, i + add, i).clamp(0, 255).to(torch.uint8)


def color(img: torch.Tensor, mag, sign) -> torch.Tensor:
    gray = rgb_to_grayscale(img).expand(-1, -1, 3)
    return blend(gray, img, enhance_factor(mag, sign))


def contrast(img: torch.Tensor, mag, sign) -> torch.Tensor:
    gray = rgb_to_grayscale(img).to(torch.float32)
    # an exact sum of integers below 2^24, divided in fp32 (by a tensor:
    # CUDA divides by a Python number through its reciprocal)
    mean = gray.sum() / torch.tensor(float(gray.numel()), device=img.device)
    mean_img = saturate_u8(mean).expand_as(img)
    return blend(mean_img, img, enhance_factor(mag, sign))


def brightness(img: torch.Tensor, mag, sign) -> torch.Tensor:
    return blend(torch.zeros_like(img), img, enhance_factor(mag, sign))


_SMOOTH = (1, 1, 1, 1, 5, 1, 1, 1, 1)


def sharpness(img: torch.Tensor, mag, sign) -> torch.Tensor:
    # TensorFlow's depthwise convolution on the host: one fused multiply-
    # add per tap into an fp32 sum, taps in row-major order; each FMA is
    # emulated exactly in fp64 (the product of two fp32 values is exact
    # there) and rounded once to fp32
    f = img.to(torch.float64)
    h, w, _ = f.shape
    acc = torch.zeros((h - 2, w - 2, 3), dtype=torch.float32,
                      device=img.device)
    for t, k in enumerate(_SMOOTH):
        i, j = divmod(t, 3)
        acc = (f[i:h - 2 + i, j:w - 2 + j] * float(_F32(k) / _F32(13.0))
               + acc.to(torch.float64)).to(torch.float32)
    # SYMMETRIC padding by one repeats the edge row and column
    smooth = torch.nn.functional.pad(
        acc.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0]
    smooth = saturate_u8(smooth.permute(1, 2, 0))
    return blend(smooth, img, enhance_factor(mag, sign))


def gather_cols(img: torch.Tensor, shifts: np.ndarray) -> torch.Tensor:
    """new[r, c] = img[r, c - shifts[r]], 128 outside the image."""
    h, w, _ = img.shape
    raw = np.arange(w)[None, :] - np.asarray(shifts, np.int64)[:, None]
    valid = torch.from_numpy((raw >= 0) & (raw < w)).to(img.device)
    idx = torch.from_numpy(np.clip(raw, 0, w - 1)).to(img.device)
    out = img.gather(1, idx[:, :, None].expand(h, w, img.shape[2]))
    return torch.where(valid[:, :, None], out,
                       torch.full_like(out, _FILL))


def gather_rows(img: torch.Tensor, shifts: np.ndarray) -> torch.Tensor:
    return gather_cols(img.transpose(0, 1), shifts).transpose(0, 1)


def _trunc(x: np.ndarray) -> np.ndarray:
    """fp32 -> int32 as `tf.cast` does: toward zero."""
    return np.trunc(x).astype(np.int64)


def translate(img: torch.Tensor, mag, sign, horizontal: bool
              ) -> torch.Tensor:
    h, w, _ = img.shape
    frac = _level(mag) * _F32(0.45)
    size = _F32(w if horizontal else h)
    pix = int(_trunc(_F32(sign) * frac * size))
    if horizontal:
        return gather_cols(img, np.full(h, pix))
    return gather_rows(img, np.full(w, pix))


def shear(img: torch.Tensor, mag, sign, horizontal: bool) -> torch.Tensor:
    h, w, _ = img.shape
    frac = _level(mag) * _F32(0.3)
    n = h if horizontal else w
    shifts = _trunc((_F32(sign) * frac) * np.arange(n, dtype=np.float32))
    return (gather_cols if horizontal else gather_rows)(img, shifts)


def _shear_by(img: torch.Tensor, factor, horizontal: bool) -> torch.Tensor:
    h, w, _ = img.shape
    n = h if horizontal else w
    shifts = _trunc(_F32(factor) * (np.arange(n) - n // 2).astype(
        np.float32))
    return (gather_cols if horizontal else gather_rows)(img, shifts)


def rotate(img: torch.Tensor, mag, sign) -> torch.Tensor:
    deg = _level(mag) * _F32(30.0)
    rad = _F32(sign) * deg * _F32(math.pi) / _F32(180.0)
    t = -np.tan(rad / _F32(2.0))
    img = _shear_by(img, t, horizontal=True)
    img = _shear_by(img, np.sin(rad), horizontal=False)
    return _shear_by(img, t, horizontal=True)


_APPLY = {
    "autocontrast": lambda im, m, s: autocontrast(im),
    "equalize": lambda im, m, s: equalize(im),
    "invert": lambda im, m, s: invert(im),
    "rotate": rotate,
    "posterize": lambda im, m, s: posterize(im, m),
    "solarize": lambda im, m, s: solarize(im, m),
    "solarize_add": lambda im, m, s: solarize_add(im, m),
    "color": color,
    "contrast": contrast,
    "brightness": brightness,
    "sharpness": sharpness,
    "shear_x": lambda im, m, s: shear(im, m, s, True),
    "shear_y": lambda im, m, s: shear(im, m, s, False),
    "translate_x": lambda im, m, s: translate(im, m, s, True),
    "translate_y": lambda im, m, s: translate(im, m, s, False),
}


def apply_op(img: torch.Tensor, op: str, mag=0.0, sign=1.0) -> torch.Tensor:
    """RandAugment op `op` (a name of OPS) on uint8 (H, W, 3) at magnitude
    `mag` (0-10), with `sign` (+1 or -1) where the op takes one."""
    return _APPLY[op](img, mag, sign)


# ------------------------------------------------------ RandAugment
class RandAugmentParams(NamedTuple):
    """One image's RandAugment: per chosen op its magnitude (N(m, std)
    clipped to [0, 10]), its index in OPS, whether it applies (each chosen
    op applies with probability 0.5) and its sign."""
    mags: tuple
    ops: tuple
    applies: tuple
    signs: tuple


def parse_rand_augment(aa: str) -> tuple[int, float, float]:
    """'rand-m9-mstd0.5-inc1' -> (num_ops=2, magnitude=9, std=0.5)."""
    num_ops, mag, std = 2, 9.0, 0.5
    for part in aa.split("-")[1:]:
        if part.startswith("mstd"):
            std = float(part[4:])
        elif part.startswith("m"):
            mag = float(part[1:])
        elif part.startswith("n"):
            num_ops = int(part[1:])
    return num_ops, mag, std


def rand_augment_params(u: np.ndarray, z: np.ndarray, magnitude: float,
                        std: float) -> RandAugmentParams:
    """From 3 uniforms (op, apply, sign) and 1 standard normal per op."""
    n = len(z)
    if std > 0:
        mags = np.clip(_F32(magnitude) + _F32(std) * z.astype(np.float32),
                       0.0, _MAX_LEVEL).astype(np.float32)
    else:
        mags = np.full(n, magnitude, np.float32)
    u = u.reshape(n, 3)
    ops = np.minimum((u[:, 0] * len(OPS)).astype(np.int64), len(OPS) - 1)
    return RandAugmentParams(
        mags=tuple(float(m) for m in mags), ops=tuple(int(o) for o in ops),
        applies=tuple(bool(a) for a in u[:, 1] < 0.5),
        signs=tuple(-1.0 if s < 0.5 else 1.0 for s in u[:, 2]))


def rand_augment_apply(img: torch.Tensor, p: RandAugmentParams
                       ) -> torch.Tensor:
    for mag, op, apply, sign in zip(*p):
        if apply:
            img = apply_op(img, OPS[op], mag, sign)
    return img


# ---------------------------------------------------- random erasing
class ErasingParams(NamedTuple):
    """The rectangle that random erasing fills with noise: top, left,
    height, width (in pixels)."""
    top: int
    left: int
    height: int
    width: int


ERASE_AREA = (0.02, 1 / 3)
ERASE_ASPECT = (0.3, 10 / 3)
# uniforms drawn per image: the coin, 10 areas, 10 aspect ratios, top, left
ERASING_UNIFORMS = 23


def erasing_params(u: np.ndarray, h: int, w: int, prob: float
                   ) -> Optional[ErasingParams]:
    """timm's 'pixel' random erasing from ERASING_UNIFORMS uniforms: with
    probability `prob`, the first of 10 candidate rectangles (area in
    [0.02, 1/3] of the image, log-uniform aspect in [0.3, 10/3]) that fits
    strictly inside; None when the coin says no or none fits."""
    if not u[0] < prob:
        return None
    area = _F32(h * w)
    lo, hi = (_F32(a) for a in ERASE_AREA)
    target = (lo + u[1:11].astype(np.float32) * (hi - lo)) * area
    la, lb = (np.log(_F32(a)) for a in ERASE_ASPECT)
    ar = np.exp(la + u[11:21].astype(np.float32) * (lb - la))
    eh = np.rint(np.sqrt(target * ar)).astype(np.int64)
    ew = np.rint(np.sqrt(target / ar)).astype(np.int64)
    fits = (eh < h) & (ew < w) & (eh > 0) & (ew > 0)
    if not fits.any():
        return None
    i = int(np.argmax(fits))
    top = min(int(u[21] * (h - eh[i] + 1)), h - int(eh[i]))
    left = min(int(u[22] * (w - ew[i] + 1)), w - int(ew[i]))
    return ErasingParams(top, left, int(eh[i]), int(ew[i]))


def random_erasing_apply(img: torch.Tensor, p: Optional[ErasingParams],
                         noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The normalized fp32 (H, W, 3) image with the rectangle `p` replaced
    by `noise` ((p.height, p.width, 3) standard normals)."""
    if p is None:
        return img
    out = img.clone()
    out[p.top:p.top + p.height, p.left:p.left + p.width] = noise
    return out
