"""TensorFlow's image resize, emulated in torch ops: the counterpart of
`tf.image.resize(img, size, method)` with `antialias=False`, as the JAX
package's input pipeline calls it (`ofq_tpu/data/pipeline.py`).

That call is TensorFlow's `ResizeBicubic` / `ResizeBilinear` op with
half-pixel centres: source position (x + 0.5) * in / out - 0.5, in fp32.

  * Bicubic: Keys' cubic with A = -0.5.  The fraction of the position is
    rounded to one of 1024 steps (`lrintf(delta * 1024)`) and the four
    weights are read from a table of the cubic at those steps; a tap that
    falls outside the image is dropped and the remaining weights are
    divided by their sum.  Rows are interpolated first, then columns.
  * Bilinear: the two neighbours at floor and ceil of the position (each
    clamped into the image) and the fraction position - floor; columns are
    interpolated first, then rows.

`torch.nn.functional.interpolate(mode="bicubic")` is not this function: it
uses A = -0.75 and clamps instead of dropping taps (up to 27 levels apart
on uint8 images).  The weights are computed on the host in fp32 numpy (they
depend on the sizes only) and applied in fp32 on the image's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_TABLE = 1024
_A = -0.5


@functools.lru_cache(maxsize=1)
def _coeffs() -> np.ndarray:
    """TensorFlow's bicubic table, (1025, 2): the cubic at i / 1024 and at
    i / 1024 + 1, computed as the op does (in fp64, stored in fp32)."""
    a = _A
    x = np.arange(_TABLE + 1, dtype=np.float64) / _TABLE
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    x = x + 1.0
    far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return np.stack([near, far], axis=1).astype(np.float32)


def _positions(n_in: int, n_out: int) -> np.ndarray:
    scale = np.float32(n_in) / np.float32(n_out)
    x = np.arange(n_out, dtype=np.float32)
    return (x + np.float32(0.5)) * scale - np.float32(0.5)


@functools.lru_cache(maxsize=512)
def bicubic_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices (4, n_out) int64, weights (4, n_out) fp32) of TensorFlow's
    half-pixel bicubic resize along one axis."""
    loc = _positions(n_in, n_out)
    base = np.floor(loc).astype(np.int64)
    delta = (loc - base.astype(np.float32)).astype(np.float32)
    off = np.rint(delta * np.float32(_TABLE)).astype(np.int64)
    t = _coeffs()
    raw = np.stack([t[off, 1], t[off, 0], t[_TABLE - off, 0],
                    t[_TABLE - off, 1]]).astype(np.float32)
    idx = base[None, :] + np.arange(-1, 3)[:, None]
    inside = (idx >= 0) & (idx < n_in)
    w = np.where(inside, raw, np.float32(0.0)).astype(np.float32)
    total = ((w[0] + w[1]) + w[2]) + w[3]
    ok = np.abs(total) >= np.float32(1000.0) * np.finfo(np.float32).tiny
    inv = np.where(ok, np.float32(1.0) / np.where(ok, total, 1), 1).astype(
        np.float32)
    w = (w * inv).astype(np.float32)
    return np.clip(idx, 0, n_in - 1), w


@functools.lru_cache(maxsize=512)
def bilinear_taps(n_in: int, n_out: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lower, upper (n_out,) int64, lerp (n_out,) fp32) of TensorFlow's
    half-pixel bilinear resize along one axis."""
    loc = _positions(n_in, n_out)
    fl = np.floor(loc)
    lower = np.maximum(fl.astype(np.int64), 0)
    upper = np.minimum(np.ceil(loc).astype(np.int64), n_in - 1)
    return lower, upper, (loc - fl).astype(np.float32)


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device, non_blocking=True)


def resize(img: torch.Tensor, size: tuple[int, int], method: str
           ) -> torch.Tensor:
    """(H, W, C) image of any real dtype -> fp32 (size[0], size[1], C), as
    `tf.image.resize(img, size, method)` computes it."""
    h, w = size
    x = img.to(torch.float32)
    dev = x.device
    if method == "bicubic":
        iy, wy = (_on(a, dev) for a in bicubic_taps(x.shape[0], h))
        ix, wx = (_on(a, dev) for a in bicubic_taps(x.shape[1], w))
        wy = wy[:, :, None, None]
        rows = ((x[iy[0]] * wy[0] + x[iy[1]] * wy[1]) + x[iy[2]] * wy[2]) \
            + x[iy[3]] * wy[3]
        wx = wx[:, None, :, None]
        return ((rows[:, ix[0]] * wx[0] + rows[:, ix[1]] * wx[1])
                + rows[:, ix[2]] * wx[2]) + rows[:, ix[3]] * wx[3]
    if method == "bilinear":
        y0, y1, ly = (_on(a, dev) for a in bilinear_taps(x.shape[0], h))
        x0, x1, lx = (_on(a, dev) for a in bilinear_taps(x.shape[1], w))
        lx = lx[None, :, None]
        top, bot = x[y0], x[y1]
        top = top[:, x0] + (top[:, x1] - top[:, x0]) * lx
        bot = bot[:, x0] + (bot[:, x1] - bot[:, x0]) * lx
        return top + (bot - top) * ly[:, None, None]
    raise ValueError(f"resize method {method!r}: 'bicubic' or 'bilinear'")
