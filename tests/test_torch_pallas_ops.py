"""K4 and K5 (the StatsQ matmul kernels) and the bf16 quant core of the
port against `ofq_tpu`, on the CPU.

  * K4's and K5's plain versions against the Pallas kernels `_fwd_call` /
    `_dx_call` in interpret mode, on ragged M, the edges the CUDA
    product's tiles leave ragged, and StatsQ ties: fp32 within
    1e-5 * (1 + |ref|), bf16 within one bf16 ulp (two fp32 sums in other
    orders, each rounded once);
  * `_PallasStatsQMatmul` against `jax.vjp` of the JAX custom VJP: fp64 as
    tight as the fp32 accumulator both round to; bf16 within one ulp (y,
    dx) and 1e-5 of the summed |terms| (dW, fp32 sums);
  * the composed `statsq_matmul('xla')` and `set_default_impl`;
  * the wrappers' launch count, shapes and checks (a simulated launch);
  * the bf16 stream's quant core against XLA's compiled (jitted) JAX, as
    the JAX package runs: LSQ forward and dx bit for bit and ds to fp32
    sum order, StatsQ levels bit for bit, bf16 sums and means bit for bit
    (fp32 sums rounded once), the softmax bit for bit (its denominator
    sums the unrounded fp32 exps, PERF.md), LayerNorm within
    one ulp, JAX's weakly typed scalars, the shifts' fp32 `db`.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import x64

from ofq_tpu.nn import bias as jbias
from ofq_tpu.ops import pallas_statsq as jps
from ofq_tpu.quant import lsq as jlsq
from ofq_tpu.quant import statsq as jstatsq
from ofq_tpu_torch.models.deit import LayerNorm
from ofq_tpu_torch.nn.bias import bias_add
from ofq_tpu_torch.ops import fused_attention as fa
from ofq_tpu_torch.ops import pallas_statsq as ps
from ofq_tpu_torch.ops import statsq_matmul as sm
from ofq_tpu_torch.quant import lsq, statsq
from ofq_tpu_torch.quant.ste import weak_scalar

# the module (the package exports a function of the same name)
jsm = importlib.import_module("ofq_tpu.ops.statsq_matmul")
BF16 = torch.bfloat16
SHAPES = [(37, 48, 24), (64, 96, 96), (100, 24, 72)]  # M, K, N; M ragged
# edges the CUDA product's tiles (128 rows; 128 or 96 columns; 16-deep
# chunks) leave ragged: M past a row tile with N = K = 96, a K (K4's
# contraction) and an N (K5's) no multiple of the chunk
TILE_EDGES = [(130, 96, 96), (257, 40, 96), (129, 96, 36)]


def _bf16(a):
    """numpy -> (torch bf16, the same values as a jax bf16 array)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == BF16 else (
            a.detach().numpy())
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _weight(rng, K, N, n):
    """Half the columns on StatsQ ties: mean|w| = 0.5 (scale 1) and every
    c * n integral; the rest lecun-normal."""
    w = rng.normal(size=(K, N)) / np.sqrt(K)
    t = rng.integers(0, n // 2 + 1, size=(K // 2, N // 2)) / n
    w[:, : N // 2] = np.concatenate([0.5 - t, 0.5 + t], 0) * rng.choice(
        [-1, 1], size=(K, N // 2))
    return w


def _within_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger (2^-7 * max(|.|))."""
    got, want = _np(got), _np(want)
    lim = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= lim), float(
        np.max(np.abs(got - want) - lim))


# --------------------------------------------------------- K4 and K5
@pytest.mark.parametrize("bits", [2, 4])
def test_quant_tile_bit_exact(bits):
    n = 2 ** (bits - 1)
    w = _weight(np.random.default_rng(bits), 64, 48, n).astype(np.float32)
    s = np.array(jstatsq.statsq_scale(jnp.asarray(w)))
    want = np.asarray(jps._quant_tile(jnp.asarray(w), jnp.asarray(s),
                                      float(n)))
    got = ps._quant_tile(torch.from_numpy(w), torch.from_numpy(s), float(n))
    c = np.clip(w / s, -1.0, np.float32(1.0 - 1e-6)) * n - 0.5
    assert np.sum(c - np.floor(c) == 0.5) > 100  # ties
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", SHAPES + TILE_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["K4", "K5"])
def test_plain_matches_pallas(which, dtype, M, K, N):
    rng = np.random.default_rng(M + K + N)
    w = _weight(rng, K, N, 2).astype(np.float32)
    a = rng.normal(size=(M, K if which == "K4" else N))
    s = jstatsq.statsq_scale(jnp.asarray(w))
    if dtype == "bfloat16":
        at, aj = _bf16(a)
    else:
        at = torch.from_numpy(a.astype(np.float32))
        aj = jnp.asarray(a, jnp.float32)
    wt, st = torch.from_numpy(w), torch.from_numpy(np.array(s))
    if which == "K4":
        want = jps._fwd_call(aj, jnp.asarray(w), s, 2, interpret=True)
        got = ps.pallas_statsq_fwd_reference(at, wt, st, 2.0)
    else:
        want = jps._dx_call(aj, jnp.asarray(w), s, 2, aj.dtype,
                            interpret=True)
        got = ps.pallas_statsq_dx_reference(at, wt, st, 2.0, at.dtype)
    assert got.dtype == at.dtype and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        _within_ulp(got, want)


def _jax_vjp(x, w, g, bits, compute_dtype=None, jit=False):
    def f(x, w):
        return jps.pallas_statsq_matmul(x, w, bits,
                                        compute_dtype=compute_dtype,
                                        interpret=True)

    def run(x, w, g):
        y, pull = jax.vjp(f, x, w)
        return (y,) + pull(g)
    return (jax.jit(run) if jit else run)(x, w, g)


def _port_vjp(x, w, g, bits, compute_dtype=None):
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ps.pallas_statsq_matmul(xt, wt, bits, compute_dtype=compute_dtype)
    return (y,) + torch.autograd.grad(y, (xt, wt), g)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("lead", [(37,), (2, 10)])
def test_pallas_matmul_grads_fp64(bits, lead):
    """fp64 in, the kernel's fp32 accumulator out (JAX rounds its fp64 dots
    to `preferred_element_type=float32`, and so does the port): equal to
    the last fp32 bit but for a rare sum rounding the other way."""
    rng = np.random.default_rng(bits)
    K, N = 48, 24
    x = rng.normal(size=lead + (K,))
    w = _weight(rng, K, N, 2 ** (bits - 1))
    g = rng.normal(size=lead + (N,))
    with x64():
        want = _jax_vjp(*(jnp.asarray(a) for a in (x, w, g)), bits)
    got = _port_vjp(*(torch.from_numpy(a) for a in (x, w, g)), bits)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        assert a.dtype == torch.float64, name
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2 ** -23,
                                   atol=1e-30, err_msg=name)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_pallas_matmul_grads_bf16(x_dtype):
    """The bf16 stream (compute_dtype bf16, fp32 W), against the compiled
    JAX VJP: y and dx (bf16) within one bf16 ulp; dW (fp32) within 1e-5 of
    sum |x| |g| (fp32 sums in other orders)."""
    rng = np.random.default_rng(7)
    M, K, N = 64, 96, 48
    w = _weight(rng, K, N, 2).astype(np.float32)
    xb, xj = _bf16(rng.normal(size=(M, K)))
    gb, gj = _bf16(rng.normal(size=(M, N)))
    if x_dtype == "float32":  # cast to the compute dtype inside the op
        xb, xj = xb.float(), xj.astype(jnp.float32)
    want = _jax_vjp(xj, jnp.asarray(w), gj, 2, jnp.bfloat16, jit=True)
    got = _port_vjp(xb, torch.from_numpy(w), gb, 2, BF16)
    assert got[0].dtype == BF16 and got[1].dtype == xb.dtype
    assert got[2].dtype == torch.float32
    _within_ulp(got[0], want[0])
    _within_ulp(got[1], want[1])
    bound = 1e-5 * (np.abs(_np(xb)).T @ np.abs(_np(gb)))
    assert np.all(np.abs(_np(got[2]) - _np(want[2])) <= bound)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_statsq_matmul_xla(compute_dtype):
    """The composition: fp64 to 1e-12, the bf16 stream within one ulp."""
    rng = np.random.default_rng(8)
    w = _weight(rng, 48, 24, 2)
    x = rng.normal(size=(2, 10, 48))
    if compute_dtype is None:
        with x64():
            want = jsm.statsq_matmul(jnp.asarray(x), jnp.asarray(w), 2,
                                     impl="xla")
        got = sm.statsq_matmul(torch.from_numpy(x), torch.from_numpy(w), 2)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)
        return
    xb, xj = _bf16(x)
    want = jax.jit(lambda a, b: jsm.statsq_matmul(
        a, b, 2, impl="xla", compute_dtype=jnp.bfloat16))(
        xj, jnp.asarray(w, jnp.float32))
    got = sm.statsq_matmul(xb, torch.from_numpy(w.astype(np.float32)), 2,
                           compute_dtype=BF16)
    assert got.dtype == BF16
    _within_ulp(got, want)


def test_set_default_impl(monkeypatch):
    calls = []

    def fwd(*a):
        calls.append(a[0].shape)
        return ps.pallas_statsq_fwd_reference(*a)

    x, w = torch.randn(5, 8), torch.randn(8, 4)
    monkeypatch.setattr(sm, "_DEFAULT_IMPL", "xla")
    want = sm.statsq_matmul(x, w, 2)
    sm.set_default_impl("pallas")
    got = sm.statsq_matmul(x, w, 2, fwd=fwd)
    assert calls == [(5, 8)]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        sm.set_default_impl("fused")


# ------------------------------------------------- the wrappers' glue
def test_simulated_launch_counts_and_checks(monkeypatch):
    """With a CUDA launch simulated by the plain version: each wrapper
    counts its launches by (M, K, N), refuses a grad-requiring input with
    grad mode on, a non-contiguous or fp64 operand, and K5 an output dtype
    other than g's."""
    monkeypatch.setattr(ps, "on_card", lambda t: True)

    def launch(fn_name, what, a, w, s, n, out_shape, M, K, N):
        if fn_name.endswith("fwd"):
            return ps.pallas_statsq_fwd_reference(a, w, s, n)
        return ps.pallas_statsq_dx_reference(a, w, s, n, a.dtype)
    monkeypatch.setattr(ps, "_launch", launch)
    for fn in (ps.pallas_statsq_fwd, ps.pallas_statsq_dx):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launch_shapes", type(fn.launch_shapes)())
    w = torch.randn(8, 4)
    s = statsq.statsq_scale(w).contiguous()
    x = torch.randn(6, 8, dtype=BF16)
    g = torch.randn(6, 4, dtype=BF16)
    ps.pallas_statsq_fwd(x, w, s, 2.0)
    ps.pallas_statsq_dx(g, w, s, 2.0, BF16)
    ps.pallas_statsq_dx(g, w, s, 2.0, BF16)
    assert ps.pallas_statsq_fwd.launches == 1
    assert dict(ps.pallas_statsq_fwd.launch_shapes) == {(6, 8, 4): 1}
    assert dict(ps.pallas_statsq_dx.launch_shapes) == {(6, 8, 4): 2}
    with pytest.raises(RuntimeError, match="requires grad"):
        ps.pallas_statsq_fwd(x.float().requires_grad_(), w, s, 2.0)
    with pytest.raises(ValueError, match="contiguous float32"):
        ps.pallas_statsq_fwd(x.double(), w, s, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        ps.pallas_statsq_fwd(x.t().contiguous().t(), w, s, 2.0)
    with pytest.raises(ValueError, match="dtype"):
        ps.pallas_statsq_dx(g, w, s, 2.0, torch.float32)
    # through autograd the Function calls the wrapper with grad mode off
    xr = x.float().requires_grad_()
    y = ps.pallas_statsq_matmul(xr, w, 2, compute_dtype=BF16)
    y.float().sum().backward()
    assert ps.pallas_statsq_fwd.launches == 2 and xr.grad is not None


# ------------------------------------------- the bf16 stream, quant core
@pytest.mark.parametrize("shape,axis,all_positive", [
    ((4, 18, 48), -2, False),
    ((4, 18, 48), -2, True),
    ((4, 18, 48), -1, False),
    ((4, 18, 3, 16), (1, 2), False),
])
def test_lsq_bf16_against_compiled_jax(shape, axis, all_positive):
    """y and dx bit for bit; ds to fp32 summation order (1e-5 of the sum of
    its |terms|)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape)
    if all_positive:
        x = np.abs(x)
    nscale = (shape[1] * shape[2] if isinstance(axis, tuple)
              else shape[axis])
    s = (np.abs(rng.normal(size=(nscale,))) * 0.5 + 0.1).astype(np.float32)
    xb, xj = _bf16(x)
    gb, gj = _bf16(rng.normal(size=shape))
    kw = dict(all_positive=all_positive, channel_axis=axis)

    def run(x, s, g):
        y, pull = jax.vjp(lambda a, b: jlsq.lsq_quantize(a, b, 2, **kw), x, s)
        return (y,) + pull(g)
    yj, dxj, dsj = jax.jit(run)(xj, jnp.asarray(s), gj)
    xt, st = xb.clone().requires_grad_(), torch.from_numpy(s).requires_grad_()
    y = lsq.lsq_quantize(xt, st, 2, **kw)
    dx, ds = torch.autograd.grad(y, (xt, st), gb)
    assert y.dtype == dx.dtype == BF16 and ds.dtype == torch.float32
    np.testing.assert_array_equal(_np(y), _np(yj))
    np.testing.assert_array_equal(_np(dx), _np(dxj))
    scale = float(np.abs(_np(dsj)).max())
    np.testing.assert_allclose(ds.numpy(), _np(dsj), rtol=1e-5,
                               atol=1e-5 * scale)


def test_statsq_bf16_weights():
    """bf16 weights: the levels are rounded in fp32 and returned in bf16,
    bit for bit."""
    w = np.random.default_rng(10).normal(size=(48, 24)) * 0.05
    wb, wj = _bf16(w)
    want = jax.jit(lambda a: jstatsq.statsq_quantize(a, 2))(wj)
    got = statsq.statsq_quantize(wb, 2)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bf16_sum_is_the_fp32_sum_rounded_once():
    """XLA reduces a bf16 sum or mean in fp32 and rounds the result once to
    bf16, as torch's bf16 `sum`/`mean` do: bit for bit."""
    xb, xj = _bf16(np.random.default_rng(15).random((2000, 198)))
    for jf, tf in ((jnp.sum, torch.sum), (jnp.mean, torch.mean)):
        want = jax.jit(lambda a: jf(a, axis=-1))(xj)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_np(tf(xb, dim=-1)), _np(want))
        np.testing.assert_array_equal(
            _np(tf(xb.float(), dim=-1).to(BF16)), _np(want))


def test_softmax_bf16_bit_exact():
    """XLA compiles the bf16 softmax as bf16(exp) / bf16(sum of the fp32
    exps): the port's `softmax` repeats it bit for bit."""
    xb, xj = _bf16(np.random.default_rng(11).normal(size=(64, 198)) * 3)
    want = jax.jit(lambda a: jax.nn.softmax(a, axis=-1))(xj)
    got = fa.softmax(xb)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_weak_scalar_matches_jax():
    xb, xj = _bf16(np.random.default_rng(12).normal(size=(4096,)))
    want = jax.jit(lambda a: a * (8 ** -0.5))(xj)
    np.testing.assert_array_equal(_np(xb * weak_scalar(8 ** -0.5, BF16)),
                                  _np(want))
    assert weak_scalar(0.125, BF16) == 0.125
    assert weak_scalar(8 ** -0.5, torch.float64) == 8 ** -0.5


def test_layernorm_bf16_pinned():
    """Flax's LayerNorm with `dtype` pinned to bf16 (`make_norm`): fp32
    statistics and affine, one rounding; within one bf16 ulp (the fp32
    means sum in other orders)."""
    rng = np.random.default_rng(13)
    xb, xj = _bf16(rng.normal(size=(4, 18, 48)) * 2 + 0.5)
    scale = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    bias = (0.1 * rng.normal(size=48)).astype(np.float32)
    jm = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16)
    want = jax.jit(jm.apply)({"params": {"scale": jnp.asarray(scale),
                                         "bias": jnp.asarray(bias)}}, xj)
    ln = LayerNorm(48, 1e-6, "bfloat16")
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    got = ln(xb)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _within_ulp(got, want)


def test_bias_add_bf16_fp32_db():
    """The shift's gradient sums the bf16 cotangent in fp32."""
    rng = np.random.default_rng(14)
    xb, xj = _bf16(rng.normal(size=(8, 50, 24)))
    gb, gj = _bf16(rng.normal(size=(8, 50, 24)))
    b = (0.1 * rng.normal(size=24)).astype(np.float32)

    def run(x, b, g):
        y, pull = jax.vjp(jbias._bias_add, x, b)
        return (y,) + pull(g)
    yj, _, dbj = jax.jit(run)(xj, jnp.asarray(b), gj)
    bt = torch.from_numpy(b).requires_grad_()
    y = bias_add(xb.clone().requires_grad_(), bt)
    (db,) = torch.autograd.grad(y, (bt,), gb)
    assert y.dtype == BF16 and db.dtype == torch.float32
    np.testing.assert_array_equal(_np(y), _np(yj))
    np.testing.assert_allclose(db.numpy(), _np(dbj), rtol=1e-6, atol=1e-5)
