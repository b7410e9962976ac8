"""The port's RandAugment and random erasing (`ofq_tpu_torch.data.augment`,
on the CPU) against the JAX package's (`ofq_tpu.data.augment`, TensorFlow
ops on this CPU), on the same uint8 image (a 40 x 48 gradient with noise).

  * each of the 15 ops at magnitudes 0, 4.5, 9 and 10: exact for
    autocontrast, equalize, invert, posterize, solarize and solarize_add;
    the ops that draw a sign inside JAX (color, contrast, brightness,
    sharpness, the shears, the translations, rotate) run under
    `tf.random.set_seed`, and JAX's output equals the port's at one of the
    two signs, exactly or within one level on at most 0.1 % of the pixels
    (fp32 products summed in another order may cross a truncation edge);
  * erasing, given JAX's rectangle and noise (read from JAX's erasing of a
    zero image under the same seed), gives JAX's image exactly;
  * statistics with fixed seeds on both sides: erasing's acceptance rate
    and erased area against `random_erasing` (KS, 1000 draws); the op
    frequencies (chi-square against uniform), the apply coin, and the
    magnitude N(m, std) clipped to [0, 10] against `_randomize_mag` (KS
    and the clipped share).
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf.config.set_visible_devices([], "GPU")

from scipy import stats  # noqa: E402

from ofq_tpu.data import augment as jaug  # noqa: E402
from ofq_tpu_torch.data import augment  # noqa: E402

H, W = 40, 48

# the JAX package's op list, in `rand_augment`'s order
JAX_OPS = {
    "autocontrast": lambda im, m: jaug._autocontrast(im),
    "equalize": lambda im, m: jaug._equalize(im),
    "invert": lambda im, m: jaug._invert(im),
    "rotate": jaug._rotate,
    "posterize": lambda im, m: tf.saturate_cast(jaug._posterize(im, m),
                                                tf.uint8),
    "solarize": jaug._solarize,
    "solarize_add": jaug._solarize_add,
    "color": jaug._color,
    "contrast": jaug._contrast,
    "brightness": jaug._brightness,
    "sharpness": jaug._sharpness,
    "shear_x": lambda im, m: jaug._shear(im, m, True),
    "shear_y": lambda im, m: jaug._shear(im, m, False),
    "translate_x": lambda im, m: jaug._translate(im, m, True),
    "translate_y": lambda im, m: jaug._translate(im, m, False),
}


def _image():
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([4 * x + 20, 5 * y + 10, 2 * (x + y) + 60], -1)
    return np.clip(base + rng.integers(-30, 31, (H, W, 3)), 0,
                   255).astype(np.uint8)


def test_op_list_is_jax_order():
    assert tuple(JAX_OPS) == augment.OPS


def _jax_op(op, img, mag, seed):
    tf.random.set_seed(seed)
    return JAX_OPS[op](tf.constant(img), tf.constant(mag, tf.float32)
                       ).numpy().astype(int)


@pytest.mark.parametrize("mag", [0.0, 4.5, 9.0, 10.0])
@pytest.mark.parametrize("op", augment.OPS)
def test_op_matches_jax(op, mag):
    """A signed op runs under seeds 11, 12, ... until JAX has drawn both
    signs; each output must be the port's at one of them."""
    img = _image()
    x = torch.from_numpy(img)
    if op not in augment.SIGNED:
        got = augment.apply_op(x, op, mag)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 3)
        np.testing.assert_array_equal(got.numpy(), _jax_op(op, img, mag, 11))
        return
    ours = {s: augment.apply_op(x, op, mag, s).numpy().astype(int)
            for s in (-1.0, 1.0)}
    matched = set()
    for seed in range(11, 19):
        want = _jax_op(op, img, mag, seed)
        stats_ = {s: (int(np.abs(o - want).max()),
                      float((o != want).mean())) for s, o in ours.items()}
        ok = [s for s, (dmax, share) in stats_.items()
              if dmax <= 1 and share <= 1e-3]
        assert ok, (op, mag, seed, stats_)
        matched.add(min(ok, key=lambda s: stats_[s][1]))
        if len(matched) == 2 or mag == 0.0:
            break
    assert len(matched) == 2 or mag == 0.0, (op, mag, matched)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_erasing_apply_matches_jax(seed):
    """prob 1: JAX erases a rectangle with noise; the same seed on a zero
    image shows the rectangle and the noise inside it."""
    img = (_image().astype(np.float32) - 100.0) / 60.0
    tf.random.set_seed(seed)
    probe = jaug.random_erasing(tf.zeros((H, W, 3)), 1.0).numpy()
    tf.random.set_seed(seed)
    want = jaug.random_erasing(tf.constant(img), 1.0).numpy()
    rows, cols = np.nonzero((probe != 0).any(-1))
    assert rows.size, "no rectangle fits: pick another seed"
    p = augment.ErasingParams(int(rows.min()), int(cols.min()),
                              int(rows.max() - rows.min() + 1),
                              int(cols.max() - cols.min() + 1))
    noise = probe[p.top:p.top + p.height, p.left:p.left + p.width]
    got = augment.random_erasing_apply(torch.from_numpy(img), p,
                                       torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(img)
    assert augment.random_erasing_apply(x, None, None) is x


N_DRAWS = 1000


@pytest.mark.parametrize("hw", [(32, 32), (224, 224)])
def test_erasing_statistics(hw):
    h, w = hw
    tf.random.set_seed(21)
    fn = tf.function(lambda: jaug.random_erasing(tf.zeros((h, w, 1)), 0.25))
    want = np.array([(fn().numpy() != 0).sum() for _ in range(N_DRAWS)])
    gen = torch.Generator().manual_seed(5)
    u = torch.rand((N_DRAWS, augment.ERASING_UNIFORMS), generator=gen,
                   dtype=torch.float64).numpy()
    got = []
    for row in u:
        p = augment.erasing_params(row, h, w, 0.25)
        got.append(0 if p is None else p.height * p.width)
        if p is not None:
            assert 0 <= p.top and p.top + p.height <= h
            assert 0 <= p.left and p.left + p.width <= w
            assert p.height < h and p.width < w
    got = np.array(got)
    # acceptance: two binomial shares of ~0.25 within 5 standard errors
    se = np.sqrt(0.25 * 0.75 * 2 / N_DRAWS)
    assert abs((got > 0).mean() - (want > 0).mean()) < 5 * se
    res = stats.ks_2samp(got[got > 0] / (h * w), want[want > 0] / (h * w))
    assert res.pvalue > 1e-3, res
    assert got.max() <= h * w / 3 + 2 * max(h, w)


@pytest.mark.parametrize("magnitude", [9.0, 9.8])
def test_op_frequencies_and_magnitudes(magnitude):
    std, n_ops = 0.5, 2
    gen = torch.Generator().manual_seed(17)
    u = torch.rand((N_DRAWS, 3 * n_ops), generator=gen,
                   dtype=torch.float64).numpy()
    z = torch.randn((N_DRAWS, n_ops), generator=gen,
                    dtype=torch.float64).numpy()
    ps = [augment.rand_augment_params(a, b, magnitude, std)
          for a, b in zip(u, z)]
    ops = np.array([o for p in ps for o in p.ops])
    counts = np.bincount(ops, minlength=len(augment.OPS))
    assert stats.chisquare(counts).pvalue > 1e-3
    applies = np.array([a for p in ps for a in p.applies])
    assert abs(applies.mean() - 0.5) < 5 * np.sqrt(0.25 / applies.size)
    signs = np.array([s for p in ps for s in p.signs])
    assert set(signs) == {-1.0, 1.0}
    mags = np.array([m for p in ps for m in p.mags])
    assert mags.min() >= 0.0 and mags.max() <= 10.0
    tf.random.set_seed(8)
    fn = tf.function(lambda: jaug._randomize_mag(magnitude, std))
    want = np.array([float(fn()) for _ in range(mags.size)])
    assert stats.ks_2samp(mags, want).pvalue > 1e-3
    clipped, jclipped = (mags == 10.0).mean(), (want == 10.0).mean()
    assert abs(clipped - jclipped) < 5 * np.sqrt(0.25 * 2 / mags.size)
    # magnitude 0 std: the magnitude itself
    p = augment.rand_augment_params(u[0], z[0], magnitude, 0.0)
    assert p.mags == (float(np.float32(magnitude)),) * n_ops
