"""ofq_tpu_torch.quant vs ofq_tpu.quant: forward values bit for bit in fp32.

The quantizers are elementwise apart from the scale statistics (means).
XLA and PyTorch sum in different orders, so the tests that go through a
mean use dyadic inputs (multiples of 1/64 or 1/8), whose sums are exact in
any order; the JAX side runs eagerly, where `jnp.mean` divides by the count
as `torch.mean` does.  Tie inputs land exactly on a rounding boundary for
both round sites: LSQ's `round(x / s)` and StatsQ's `round(c * n - 0.5)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import x64

from ofq_tpu.quant import lsq as jlsq
from ofq_tpu.quant import statsq as jstatsq
from ofq_tpu_torch.quant import lsq as tlsq
from ofq_tpu_torch.quant import statsq as tstatsq


def _eager(fn, *args, **kw):
    with jax.disable_jit():
        out = fn(*args, **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dyadic(rng, shape, denom=64):
    return (rng.integers(-2 * denom, 2 * denom + 1, size=shape)
            / denom).astype(np.float32)


def _statsq_ties(rng, K, N, n):
    """(K, N) kernel whose every column has mean|w| = 0.5 exactly (so the
    StatsQ scale is 1) and entries on the grid 1/n: c * n is an integer
    for every entry -- a rounding tie at each unclipped one."""
    t = rng.integers(0, n // 2 + 1, size=(K // 2, N)) / n
    pairs = np.concatenate([0.5 - t, 0.5 + t], axis=0)
    signs = rng.choice([-1.0, 1.0], size=(K, N))
    return (pairs * signs).astype(np.float32)


class TestThresholdsAndFactors:
    @pytest.mark.parametrize("bit", [1, 2, 3, 4, 8])
    @pytest.mark.parametrize("all_positive", [False, True])
    def test_thresholds(self, bit, all_positive):
        assert (tlsq.thresholds(bit, all_positive)
                == jlsq.thresholds(bit, all_positive))

    @pytest.mark.parametrize("shape,axis", [
        ((2, 10, 48), None),            # per-tensor
        ((10, 48), -2),                 # axis -2, 2-D
        ((2, 10, 48), -2),              # axis -2, 3-D
        ((2, 10, 48), 1),               # axis nd-2, 3-D
        ((2, 3, 10, 8), -2),            # axis -2, 4-D
        ((48, 24), -1),                 # axis -1, 2-D weight
        ((2, 10, 48), -1),              # axis -1, 3-D
        ((2, 10, 48), 2),               # axis nd-1, 3-D
        ((2, 3, 10, 8), -1),            # axis -1, 4-D
        ((2, 10, 3, 16), (1, 2)),       # tuple axes (QKR qkx)
        ((2, 3, 10, 8), 1),             # generic single axis (per head)
    ])
    @pytest.mark.parametrize("bit,all_positive", [(2, False), (2, True),
                                                  (8, False)])
    def test_grad_scale_factor(self, shape, axis, bit, all_positive):
        assert (tlsq.grad_scale_factor(shape, bit, all_positive, axis)
                == jlsq.grad_scale_factor(shape, bit, all_positive, axis))

    def test_grad_scale_factor_rejects_5d(self):
        for mod in (tlsq, jlsq):
            with pytest.raises(ValueError):
                mod.grad_scale_factor((1, 2, 3, 4, 5), 2, False, -2)


class TestInitScale:
    @pytest.mark.parametrize("shape,axis", [
        ((2, 10, 48), -2), ((2, 10, 48), -1), ((48, 24), -1),
        ((2, 10, 48), None), ((2, 10, 3, 16), (1, 2)),
        ((4, 8, 8, 3), -1),
    ])
    @pytest.mark.parametrize("all_positive", [False, True])
    def test_bit_identical_fp32(self, shape, axis, all_positive):
        x = _dyadic(np.random.default_rng(0), shape)
        if all_positive:
            x = np.abs(x)
        j = _eager(jlsq.init_scale, jnp.asarray(x), 2, all_positive, axis)
        t = tlsq.init_scale(_t(x), 2, all_positive, axis).numpy()
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)

    def test_float32_round_trip_in_fp64(self):
        """fp64 inputs give fp64 scales rounded through float32."""
        x = np.random.default_rng(1).normal(size=(2, 10, 48))
        with x64():
            j = np.asarray(jlsq.init_scale(jnp.asarray(x), 4, False, -2))
        t = tlsq.init_scale(_t(x), 4, False, -2).numpy()
        assert t.dtype == j.dtype == np.float64
        np.testing.assert_array_equal(t, t.astype(np.float32))
        np.testing.assert_allclose(t, j, rtol=1e-7, atol=0)


class TestStatsQ:
    @pytest.mark.parametrize("bits", [2, 3, 4])
    @pytest.mark.parametrize("reduce_axis", [0, -1])
    def test_ties_bit_identical(self, bits, reduce_axis):
        n = 2 ** (bits - 1)
        w = _statsq_ties(np.random.default_rng(bits), 48, 24, n)
        if reduce_axis == -1:
            w = np.ascontiguousarray(w.T)
        b4 = _eager(jstatsq.statsq_b4_round, jnp.asarray(w), bits,
                    reduce_axis=reduce_axis)[0]
        frac = b4 - np.floor(b4)
        assert np.mean(frac == 0.5) > 0.5, "tie construction failed"
        j = _eager(jstatsq.statsq_quantize, jnp.asarray(w), bits,
                   reduce_axis=reduce_axis)
        t = tstatsq.statsq_quantize(_t(w), bits,
                                    reduce_axis=reduce_axis).numpy()
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("reduce_axis", [0, -1])
    def test_dyadic_bit_identical(self, reduce_axis):
        w = _dyadic(np.random.default_rng(5), (96, 40), denom=8)
        for fn_j, fn_t in ((jstatsq.statsq_scale, tstatsq.statsq_scale),
                           (jstatsq.statsq_quantize, tstatsq.statsq_quantize)):
            args = () if fn_j is jstatsq.statsq_scale else (2,)
            j = _eager(fn_j, jnp.asarray(w), *args, reduce_axis=reduce_axis)
            t = fn_t(_t(w), *args, reduce_axis=reduce_axis).numpy()
            np.testing.assert_array_equal(t, j)

    def test_zero_column_floor(self):
        w = np.zeros((8, 4), np.float32)
        w[:, 1] = 0.5
        j = _eager(jstatsq.statsq_scale, jnp.asarray(w))
        t = tstatsq.statsq_scale(_t(w)).numpy()
        np.testing.assert_array_equal(t, j)
        assert t[0, 0] == np.float32(1e-12)

    @pytest.mark.parametrize("reduce_axis", [0, -1])
    def test_normal_weights_same_levels(self, reduce_axis):
        """Random weights: the means may differ in the last bit (summation
        order), the integer levels must not."""
        w = np.random.default_rng(7).normal(size=(64, 32)).astype(np.float32)
        jb, js = _eager(jstatsq.statsq_b4_round, jnp.asarray(w), 2,
                        reduce_axis=reduce_axis)
        tb, ts = tstatsq.statsq_b4_round(_t(w), 2, reduce_axis=reduce_axis)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
        np.testing.assert_array_equal(np.round(tb.numpy()), np.round(jb))


def _lsq_case(rng, shape, axis, all_positive, ties):
    x = rng.normal(size=shape).astype(np.float32)
    if all_positive:
        x = np.abs(x)
    if axis is None:
        n_s = 1
    elif isinstance(axis, tuple):
        n_s = int(np.prod([shape[a] for a in axis]))
    else:
        n_s = shape[axis]
    # dyadic scales: x = s * (k + 0.5) is then exact, a tie of round(x/s)
    s = (rng.integers(8, 64, size=(n_s,)) / 128).astype(np.float32)
    if ties:
        sb = np.asarray(jlsq._broadcast_scale(jnp.asarray(s), shape, axis))
        k = rng.integers(-2, 2, size=shape)
        if all_positive:
            k = np.abs(k)
        x = (sb * (k + 0.5)).astype(np.float32)
    return x, s


class TestLsqQuantize:
    @pytest.mark.parametrize("shape,axis", [
        ((2, 10, 48), -2), ((2, 3, 10, 8), -2), ((2, 10, 48), -1),
        ((2, 10, 48), None), ((2, 10, 3, 16), (1, 2)),
    ])
    @pytest.mark.parametrize("all_positive", [False, True])
    @pytest.mark.parametrize("bit", [1, 2, 4, 8])
    @pytest.mark.parametrize("ties", [False, True])
    def test_bit_identical(self, shape, axis, all_positive, bit, ties):
        x, s = _lsq_case(np.random.default_rng(bit), shape, axis,
                         all_positive, ties)
        j = _eager(jlsq.lsq_quantize, jnp.asarray(x), jnp.asarray(s), bit,
                   all_positive=all_positive, channel_axis=axis)
        t = tlsq.lsq_quantize(_t(x), _t(s), bit, all_positive=all_positive,
                              channel_axis=axis).numpy()
        np.testing.assert_array_equal(t, j)

    def test_scale_floor(self):
        x = np.random.default_rng(3).normal(size=(2, 4, 6)).astype(np.float32)
        s = np.array([1e-7, -1.0, 0.1, 1e-5], np.float32)
        j = _eager(jlsq.lsq_quantize, jnp.asarray(x), jnp.asarray(s), 4)
        t = tlsq.lsq_quantize(_t(x), _t(s), 4).numpy()
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("signed", [False, True])
    @pytest.mark.parametrize("axis", [-1, None])
    @pytest.mark.parametrize("ties", [False, True])
    def test_dynamic_signed(self, signed, axis, ties):
        shape = (2, 8, 8, 3)
        x, s = _lsq_case(np.random.default_rng(11), shape, axis, False, ties)
        j = _eager(jlsq.lsq_quantize_dynamic_signed, jnp.asarray(x),
                   jnp.asarray(s), 8, jnp.asarray(signed), channel_axis=axis)
        t = tlsq.lsq_quantize_dynamic_signed(
            _t(x), _t(s), 8, torch.tensor(signed), channel_axis=axis).numpy()
        np.testing.assert_array_equal(t, j)
