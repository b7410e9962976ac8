"""Gradients of the quantization core against the JAX package, in fp64.

Each case makes its inputs and cotangent with numpy from a seed, takes
`jax.vjp` of the `ofq_tpu` function under x64, and the same cotangent
through the port's autograd.  Masks and roundings are elementwise on the
same fp64 values and agree exactly; `ds` and `db` are summed in fp32 on
both sides (as JAX does under x64), in other orders, hence their rtol of
1e-6 (a few fp32 ulps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import x64

from ofq_tpu.nn import bias as jbias
from ofq_tpu.quant import lsq as jlsq
from ofq_tpu.quant import statsq as jstatsq
from ofq_tpu.quant import ste as jste
from ofq_tpu_torch.nn import LsqAct, LsqImgQuantizer, LsqWeight
from ofq_tpu_torch.nn.bias import bias_add
from ofq_tpu_torch.quant import lsq as tlsq
from ofq_tpu_torch.quant import statsq as tstatsq
from ofq_tpu_torch.quant import ste as tste


def _vjp_jax(fn, args, g):
    with x64():
        out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
        cot = vjp(jnp.asarray(g))
        return np.asarray(out), [np.asarray(c) for c in cot]


def _vjp_torch(fn, args, g):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*ts)
    cot = torch.autograd.grad(out, ts, torch.from_numpy(g),
                              allow_unused=True)
    return out.detach().numpy(), [
        np.zeros(t.shape) if c is None else c.numpy()
        for t, c in zip(ts, cot)]


# ------------------------------------------------------------------ STE
@pytest.mark.parametrize("name", ["round_pass", "grad_scale", "clip_lower",
                                  "passthrough"])
def test_ste_cotangents(name):
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(size=(4, 6)) * 4) / 2  # many exact .5 ties
    x[0, :3] = [1e-7, 1e-5, -3.0]
    t = rng.normal(size=x.shape)
    g = rng.normal(size=x.shape)
    fns = {
        "round_pass": ((lambda a: jste.round_pass(a)),
                       (lambda a: tste.round_pass(a)), (x,)),
        "grad_scale": ((lambda a: jste.grad_scale(a, 0.37)),
                       (lambda a: tste.grad_scale(a, 0.37)), (x,)),
        "clip_lower": ((lambda a: jste.clip_lower(a, 1e-5)),
                       (lambda a: tste.clip_lower(a, 1e-5)), (x,)),
        "passthrough": ((lambda a, b: jste.passthrough(a, b)),
                        (lambda a, b: tste.passthrough(a, b)), (t, x)),
    }
    jf, tf, args = fns[name]
    yj, cj = _vjp_jax(jf, args, g)
    yt, ct = _vjp_torch(tf, args, g)
    np.testing.assert_array_equal(yt, yj)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)


@pytest.mark.parametrize("reduce_axis,shape", [(0, (12, 8)), (-1, (9, 5))])
def test_statsq_ste_is_identity(reduce_axis, shape):
    """StatsQ's gradient is the identity: the scale is detached."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=shape) / 3
    g = rng.normal(size=shape)
    yj, (cj,) = _vjp_jax(
        lambda a: jstatsq.statsq_quantize(a, 2, reduce_axis=reduce_axis),
        (w,), g)
    yt, (ct,) = _vjp_torch(
        lambda a: tstatsq.statsq_quantize(a, 2, reduce_axis=reduce_axis),
        (w,), g)
    # the STE's forward `w + (q - w)` may round differently by an ulp
    np.testing.assert_allclose(yt, yj, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(ct, g)


# ------------------------------------------------------------------ LSQ
def _lsq_case(shape, axis, bit, all_positive, seed, on_bounds=True):
    """Inputs on the clip bounds, on rounding ties, inside and outside the
    range, with power-of-two scales (so x / s is exact) and one scale
    below the 1e-5 floor."""
    rng = np.random.default_rng(seed)
    lo, hi = tlsq.thresholds(bit, all_positive)
    nd = len(shape)
    if axis is None:
        s_shape = (1,)
    elif isinstance(axis, tuple):
        s_shape = (math.prod(shape[a % nd] for a in axis),)
    else:
        s_shape = (shape[axis],)
    s = 2.0 ** rng.integers(-4, 0, size=s_shape)
    s.flat[-1] = 1e-7
    s_b = tlsq._broadcast_scale(torch.from_numpy(s), shape, axis).numpy()
    s_b = np.maximum(s_b, 1e-5)
    k = (rng.integers(lo, hi + 1, size=shape) if on_bounds else
         rng.integers(lo + 1, hi, size=shape)).astype(np.float64)
    kind = rng.integers(0, 4 if on_bounds else 3, size=shape)
    ties = np.minimum(k, hi - 1) + 0.5
    wide = rng.uniform(lo - 2, hi + 2, size=shape)
    bounds = np.where(rng.random(size=shape) < 0.5, lo, hi)
    u = np.choose(kind, [k, ties, wide, bounds])
    x = u * s_b
    g = rng.normal(size=shape)
    return x, s, g


def _ds_atol(g, bit, all_positive, shape, axis):
    """fp32-sum noise of ds: 1e-6 of the largest possible sum of its
    terms' magnitudes, gf * sum|g| * max|t| (|t| <= max(thd_pos, -thd_neg))."""
    lo, hi = tlsq.thresholds(bit, all_positive)
    gf = tlsq.grad_scale_factor(shape, bit, all_positive, axis)
    return 1e-6 * gf * np.abs(g).sum() * max(hi, -lo)


LSQ_CASES = [((3, 5, 8), -2), ((3, 5, 8), -1), ((3, 5, 8), None),
             ((2, 5, 3, 4), (1, 2))]


@pytest.mark.parametrize("shape,axis", LSQ_CASES)
@pytest.mark.parametrize("bit", [2, 4, 8])
@pytest.mark.parametrize("all_positive", [False, True])
def test_lsq_function_matches_jax_vjp(shape, axis, bit, all_positive):
    x, s, g = _lsq_case(shape, axis, bit, all_positive,
                        seed=bit + 10 * all_positive)
    if all_positive:
        x = np.abs(x)
    kw = dict(all_positive=all_positive, channel_axis=axis)
    yj, (dxj, dsj) = _vjp_jax(
        lambda a, b: jlsq.lsq_quantize(a, b, bit, **kw), (x, s), g)
    yt, (dxt, dst) = _vjp_torch(
        lambda a, b: tlsq.lsq_quantize(a, b, bit, **kw), (x, s), g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dxt, dxj)
    assert np.abs(dsj).max() > 0
    np.testing.assert_allclose(
        dst, dsj, rtol=1e-6,
        atol=_ds_atol(g, bit, all_positive, shape, axis))


@pytest.mark.parametrize("shape,axis", LSQ_CASES)
def test_lsq_function_equals_composition(shape, axis):
    """The fused Function and autograd through the composition give the
    same cotangents (the composition sums ds in fp64 here), away from the
    exact clip bounds, where the composition's clip passes half the
    cotangent (as JAX's does) and the Function all of it."""
    x, s, g = _lsq_case(shape, axis, 2, False, seed=3, on_bounds=False)
    fn = (lambda a, b: tlsq.lsq_quantize(a, b, 2, channel_axis=axis))
    comp = (lambda a, b: tlsq.lsq_quantize_composed(a, b, 2,
                                                    channel_axis=axis))
    y1, (dx1, ds1) = _vjp_torch(fn, (x, s), g)
    y2, (dx2, ds2) = _vjp_torch(comp, (x, s), g)
    np.testing.assert_allclose(y1, y2, rtol=1e-15, atol=0)
    # autograd through `y * s` forms g * s / s: an ulp off g
    np.testing.assert_allclose(dx1, dx2, rtol=1e-15, atol=0)
    np.testing.assert_allclose(ds1, ds2, rtol=1e-6,
                               atol=_ds_atol(g, 2, False, shape, axis))


@pytest.mark.parametrize("signed", [0.0, 1.0])
def test_lsq_dynamic_signed_matches_jax_vjp(signed):
    x, s, g = _lsq_case((2, 6, 6, 3), -1, 8, False, seed=5)
    if not signed:
        x = np.abs(x)
    flag = np.asarray(signed)
    yj, (dxj, dsj) = _vjp_jax(
        lambda a, b: jlsq.lsq_quantize_dynamic_signed(
            a, b, 8, jnp.asarray(flag) != 0, channel_axis=-1), (x, s), g)
    yt, (dxt, dst) = _vjp_torch(
        lambda a, b: tlsq.lsq_quantize_dynamic_signed(
            a, b, 8, torch.from_numpy(flag) != 0, channel_axis=-1), (x, s),
        g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dxt, dxj)
    np.testing.assert_allclose(dst, dsj, rtol=1e-12,
                               atol=1e-12 * np.abs(dsj).max())


# ---------------------------------------------------------- bias, gating
@pytest.mark.parametrize("shape,b_shape", [((3, 5, 8), (8,)),
                                           ((2, 5, 3, 4), (3, 4))])
def test_bias_add_db_in_fp32(shape, b_shape):
    rng = np.random.default_rng(6)
    x, b, g = (rng.normal(size=shape), rng.normal(size=b_shape),
               rng.normal(size=shape))
    yj, (dxj, dbj) = _vjp_jax(jbias._bias_add, (x, b), g)
    yt, (dxt, dbt) = _vjp_torch(bias_add, (x, b), g)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dxt, dxj)
    # summed in fp32: not the fp64 sum
    assert np.abs(dbj - g.reshape((-1,) + b_shape).sum(0)).max() > 0
    np.testing.assert_allclose(dbt, dbj, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("learnable", [True, False])
def test_learnable_flag_gates_the_scale(learnable):
    """`learnable=False` detaches the scale (JAX's stop_gradient): no
    gradient reaches it."""
    x = torch.randn(2, 5, 8, dtype=torch.float64, requires_grad=True)
    for mod in (LsqAct(2, 5, learnable=learnable),
                LsqWeight(8, 8, learnable=learnable)):
        mod = mod.double()
        inp = x[0] if isinstance(mod, LsqWeight) else x
        mod(inp).sum().backward()
        got = mod.s.grad
        if learnable:
            assert got is not None and got.abs().max() > 0
        else:
            assert got is None


def test_image_quantizer_sign_is_sticky_in_train_mode_only():
    """Train mode: signed = max(signed, batch_signed) before use, as the
    JAX train step (every non-params collection mutable) updates
    `quant_stats`; eval mode reads it as stored."""
    q = LsqImgQuantizer(8, 3).double()
    pos = torch.rand(2, 4, 4, 3, dtype=torch.float64)
    neg = pos - 0.5
    q.eval()
    q(neg)
    assert float(q.signed) == 0.0
    q.train()
    q(pos)
    assert float(q.signed) == 0.0
    q(neg)
    assert float(q.signed) == 1.0
    q(pos)
    assert float(q.signed) == 1.0
