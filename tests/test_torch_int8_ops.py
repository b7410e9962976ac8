"""The int8 path's ops (`ofq_tpu_torch/ops/int8_qlinear.py`) against
`ofq_tpu.ops.int8_qlinear` on the CPU, at small widths, every input made
with numpy from a seed and built to land on LSQ and StatsQ rounding ties:

  * the integer codes (`_act_int`, `_weight_int`, `qkr_int8_codes`,
    `frozen_weight_int`) bit-equal to JAX's;
  * fp64 (x64): the JAX ops compute in fp32 whatever the stream (the
    kernel cast to fp32, `preferred_element_type=float32` on every
    product, XLA taking fp64 operands to fp32 first), so the output and
    every cotangent (dx, ds with its grad-scale factor, db_pre, db_post,
    dkernel, dW_qk, dbx) is held to the tolerance of the quantities that
    both frameworks sum in fp32 in `test_torch_train_layers.py`: 1e-5 of
    its own or dx's largest magnitude (measured: at most 1.8e-7); the
    StatsQ scales to 1e-6 (a mean in another order, as in
    `test_torch_port_quant.py`);
  * the bf16 stream under the rule of `test_torch_bf16_layers.py`,
    against XLA's compiled JAX;
  * the eligibility fall-through (W8, all-positive A8) equal to the
    composed path bit for bit;
  * `int8_mm_reference` exact under the card harness's product patches
    (`chip_smoke.rounded_once`, `summed_in_chunks`);
  * the int product refuses a graph cut; the autograd Functions do not cut.
"""

import contextlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_layers import assert_bf16_close
from test_torch_port_common import x64

import ofq_tpu.ops.int8_qlinear as J
from ofq_tpu_torch.ops import int8_qlinear as P
from ofq_tpu_torch.ops import launch_counts, reset_launch_counts
from ofq_tpu_torch.quant.lsq import thresholds

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, N, K, OUT, H = 2, 9, 16, 24, 2


def _ties(seed, shape, s_tok, b_pre, bits, all_positive):
    """Activations with a third of the entries exactly on an LSQ rounding
    tie of x + b_pre against the per-token scale s_tok (dyadic values, so
    every step is exact)."""
    rng = np.random.default_rng(seed)
    lo, hi = thresholds(bits, all_positive)
    x = rng.normal(size=shape)
    if all_positive:
        x = np.abs(x)
    k = rng.integers(lo, hi, size=shape)
    tie = s_tok[:, None] * (k + 0.5) - b_pre
    return np.where(rng.random(shape) < 1 / 3, tie, x)


def _scales(seed, n):
    return np.random.default_rng(seed).integers(64, 256, size=n) / 128.0


def _biases(seed, n):
    return np.random.default_rng(seed).integers(-8, 9, size=n) / 256.0


def _statsq_kernel(seed, k, n, bits):
    """A kernel whose first half of columns sits on StatsQ ties (mean|w| =
    0.5, so s = 1 and clip(w) * n - 0.5 lands on half-integers)."""
    rng = np.random.default_rng(seed)
    nl = 2 ** (bits - 1)
    w = rng.normal(size=(k, n)) / np.sqrt(k)
    t = rng.integers(0, nl // 2 + 1, size=(k // 2, n // 2)) / nl
    sign = rng.integers(0, 2, size=(k, n // 2)) * 2 - 1
    w[:, : n // 2] = np.concatenate([0.5 - t, 0.5 + t], 0) * sign
    return w


def _linear_case(seed, bits, all_positive):
    s = _scales(seed, N)
    b_pre = _biases(seed + 1, K)
    x = _ties(seed + 2, (B, N, K), s, b_pre, bits, all_positive)
    kernel = _statsq_kernel(seed + 3, K, OUT, bits)
    b_post = _biases(seed + 4, K)
    g = np.random.default_rng(seed + 5).normal(size=(B, N, OUT))
    return x, kernel, s, b_pre, b_post, g


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _close(got, want, what, rel=1e-5, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    ref = max(float(np.abs(want).max()), scale or 0.0, 1e-30)
    err = float(np.abs(got - want).max()) / ref
    assert err <= rel, (what, err)


# ------------------------------------------------------ the int product
def test_int8_mm_reference_is_exact_under_the_card_gates():
    """K = 4096 codes near +-127: every sum is exact in the fp64 product
    and far beyond 2^24, where an fp32 product summed in chunks would not
    be."""
    rng = np.random.default_rng(0)
    a = rng.integers(123, 128, size=(8, 4096)).astype(np.int8)
    b = (rng.integers(123, 128, size=(4096, 16))
         * np.where(np.arange(16) % 2, 1, -1)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    assert np.abs(want).min() > 2 ** 25
    assert not np.array_equal(want.astype(np.float32).astype(np.int64),
                              want)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    contexts = [chip_smoke.rounded_once()] + [
        chip_smoke.summed_in_chunks(j) for j in chip_smoke.ORDER_CHUNKS]
    for ctx in [None] + contexts:
        if ctx is None:
            y = P.int8_mm_reference(at, bt)
        else:
            with ctx:
                y = P.int8_mm_reference(at, bt)
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), want)
    # column-major b, and the wrapper on a CPU tensor: the plain version,
    # not counted
    reset_launch_counts()
    y = P.int8_mm(at, bt.t().contiguous().t())
    np.testing.assert_array_equal(y.numpy(), want)
    assert launch_counts()["int8_mm"] == 0


def test_int8_mm_reference_refuses_an_int32_overflow():
    with pytest.raises(ValueError, match="overflows"):
        P.int8_mm_reference(torch.zeros(2, 2 ** 17, dtype=torch.int8),
                            torch.zeros(2 ** 17, 2, dtype=torch.int8))


def test_int8_eligible_is_jax_s():
    for w in range(1, 9):
        for a in range(1, 9):
            for ap in (False, True):
                assert P.int8_eligible(w, a, ap) == J.int8_eligible(w, a, ap)


# ------------------------------------------------------------- codes
@pytest.mark.parametrize("bits,all_positive", [(2, False), (2, True),
                                               (3, False), (4, True),
                                               (8, False)])
def test_codes_bit_equal(bits, all_positive):
    x, kernel, s, b_pre, _, _ = _linear_case(bits, min(bits, 4),
                                             all_positive)
    x32 = np.asarray(x, np.float32)
    x1 = x32 + np.asarray(b_pre, np.float32)
    s_eff = np.maximum(np.asarray(s, np.float32), 1e-5)[:, None]
    want = np.asarray(jax.jit(J._act_int, static_argnums=(2, 3))(
        jnp.asarray(x1), jnp.asarray(s_eff), bits, all_positive))
    got = P._act_int(torch.from_numpy(x1), torch.from_numpy(s_eff), bits,
                     all_positive).numpy()
    np.testing.assert_array_equal(got, want)
    wb = min(bits, 4)
    for axis, w in ((0, kernel), (-1, kernel.T)):
        wj, sj = jax.jit(J._weight_int, static_argnums=(1, 2))(
            jnp.asarray(w, jnp.float32), wb, axis)
        wt, st = P._weight_int(torch.tensor(w, dtype=torch.float32), wb,
                               axis)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        # the means may differ in their last bits (summation order;
        # `test_torch_port_quant.py`), the codes may not
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)


def test_frozen_weight_int_bit_equal():
    rng = np.random.default_rng(7)
    codes = rng.integers(-2, 2, size=(K, OUT)) * 2 + 1
    s = rng.uniform(0.05, 2.0, size=(1, OUT)).astype(np.float32)
    w_q = (s * (codes / 4.0)).astype(np.float32)
    wj, cj = J.frozen_weight_int(jnp.asarray(w_q), jnp.asarray(s), 2)
    wt, ct = P.frozen_weight_int(torch.from_numpy(w_q), torch.from_numpy(s),
                                 2)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(wt.numpy(), codes)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_qkr_int8_codes_fp64():
    s = _scales(11, N)
    x1 = _ties(12, (B, N, K), s, 0.0, 2, False)
    g = np.random.default_rng(13).normal(size=(B, N, K))
    gs = np.random.default_rng(14).normal(size=(1, N, 1))
    with x64():
        (xi_j, se_j), pull = jax.vjp(
            lambda x, s: J.qkr_int8_codes(x, s, 2), jnp.asarray(x1),
            jnp.asarray(s))
        dx_j, ds_j = pull((jnp.asarray(g), jnp.asarray(gs)))
    xt, st = _t(x1, grad=True), _t(s, grad=True)
    xi_t, se_t = P.qkr_int8_codes(xt, st, 2)
    np.testing.assert_array_equal(xi_t.detach().numpy(), np.asarray(xi_j))
    np.testing.assert_array_equal(se_t.detach().numpy(), np.asarray(se_j))
    dx_t, ds_t = torch.autograd.grad((xi_t, se_t), (xt, st),
                                     (_t(g), _t(gs)))
    _close(dx_t, dx_j, "dx", rel=1e-12)
    _close(ds_t, ds_j, "ds", rel=1e-12)


# ------------------------------------------------- int8_qlinear (train)
def _jax_qlinear_vjp(args, bits, a_bits, ap, g, dtype):
    def f(x, k, s, bp, bq):
        return J.int8_qlinear(x, k, s, bp, bq, bits, a_bits, ap)
    y, pull = jax.vjp(f, *(jnp.asarray(a, dtype) for a in args))
    return y, pull(jnp.asarray(g, y.dtype))


def _port_qlinear_vjp(args, bits, a_bits, ap, g, dtype):
    ts = [_t(a, dtype, grad=True) for a in args]
    y = P.int8_qlinear(*ts, bits, a_bits, ap, mm=P.int8_mm_reference)
    grads = torch.autograd.grad(y, ts, _t(g, y.dtype))
    return y, grads


NAMES = ("dx", "dkernel", "ds", "db_pre", "db_post")


@pytest.mark.parametrize("bits,all_positive", [(2, False), (2, True),
                                               (3, False), (4, True)])
def test_int8_qlinear_fp64(bits, all_positive):
    x, kernel, s, b_pre, b_post, g = _linear_case(20 + bits, bits,
                                                  all_positive)
    args = (x, kernel, s, b_pre, b_post)
    with x64():
        yj, gj = _jax_qlinear_vjp(args, bits, bits, all_positive, g,
                                  jnp.float64)
    yt, gt = _port_qlinear_vjp(args, bits, bits, all_positive, g,
                               torch.float64)
    assert yt.dtype == torch.float64
    _close(yt.detach(), yj, "y")
    dx_scale = float(np.abs(np.asarray(gj[0])).max())
    for name, a, b in zip(NAMES, gt, gj):
        assert a.dtype == torch.float64, name
        _close(a, b, name, scale=dx_scale)


def test_int8_qlinear_bf16():
    x, kernel, s, b_pre, b_post, g = _linear_case(30, 2, False)
    x = x[:, :, :].repeat(4, axis=0)  # 8 images, as the bf16 layer tests
    g = g.repeat(4, axis=0)

    def jrun(x, k, s, bp, bq, g):
        y, pull = jax.vjp(lambda *a: J.int8_qlinear(*a, 2, 2, False),
                          x, k, s, bp, bq)
        return (y,) + pull(g)
    out_j = jax.jit(jrun)(jnp.asarray(x, jnp.bfloat16),
                          *(jnp.asarray(a, jnp.float32)
                            for a in (kernel, s, b_pre, b_post)),
                          jnp.asarray(g, jnp.bfloat16))
    ts = [_t(x, torch.bfloat16, grad=True)] + [
        _t(a, torch.float32, grad=True) for a in (kernel, s, b_pre, b_post)]
    yt = P.int8_qlinear(*ts, 2, 2, False, mm=P.int8_mm_reference)
    assert yt.dtype == torch.bfloat16
    gt = torch.autograd.grad(yt, ts, _t(g, torch.bfloat16))
    assert gt[0].dtype == torch.bfloat16
    assert_bf16_close(yt, out_j[0], "y")
    for name, a, b in zip(NAMES, gt, out_j[1:]):
        assert_bf16_close(a, b, name, ref=out_j[1] if name != "dx" else None)


# --------------------------------------------- the QKR chain's products
def _chain_case(seed, dtype):
    s = _scales(seed, N)
    x1 = _ties(seed + 1, (B, N, K), s, 0.0, 2, False)
    xi = np.clip(np.round(x1 / s[:, None]), -2, 1)
    s_eff = s[None, :, None]
    bx = _biases(seed + 2, K)
    return xi, s_eff, bx


@pytest.mark.parametrize("which", ["linear", "qkx"])
def test_statsq_products_fp64(which):
    xi, s_eff, bx = _chain_case(40, np.float64)
    if which == "linear":
        w = _statsq_kernel(41, K, OUT, 2)
        jf, pf = J.int8_statsq_linear, P.int8_statsq_linear
        g = np.random.default_rng(42).normal(size=(B, N, OUT))
    else:
        q = np.random.default_rng(41).normal(size=(K, K)) / 4
        k = np.random.default_rng(43).normal(size=(K, K)) / 4
        w = np.einsum("ihd,jhd->hij", q.reshape(K, H, K // H),
                      k.reshape(K, H, K // H))
        jf, pf = J.int8_statsq_qkx, P.int8_statsq_qkx
        g = np.random.default_rng(42).normal(size=(B, N, H, K))
    args = (xi, s_eff, bx, w)
    with x64():
        yj, pull = jax.vjp(lambda *a: jf(*a, 2), *(jnp.asarray(a)
                                                    for a in args))
        gj = pull(jnp.asarray(g))
    ts = [_t(a, grad=True) for a in args]
    yt = pf(*ts, 2, mm=P.int8_mm_reference)
    gt = torch.autograd.grad(yt, ts, _t(g))
    _close(yt.detach(), yj, "y")
    dx_scale = float(np.abs(np.asarray(gj[0])).max())
    for name, a, b in zip(("dxi", "ds_eff", "dbx", "dw"), gt, gj):
        _close(a, b, name, scale=dx_scale)


@pytest.mark.parametrize("which", ["linear", "qkx"])
def test_statsq_products_bf16(which):
    xi, s_eff, bx = _chain_case(50, np.float32)
    xi, s_eff = xi.repeat(4, 0), s_eff
    if which == "linear":
        w = _statsq_kernel(51, K, OUT, 2)
        jf, pf = J.int8_statsq_linear, P.int8_statsq_linear
        g = np.random.default_rng(52).normal(size=(4 * B, N, OUT))
    else:
        w = np.random.default_rng(51).normal(size=(H, K, K)) / 4
        jf, pf = J.int8_statsq_qkx, P.int8_statsq_qkx
        g = np.random.default_rng(52).normal(size=(4 * B, N, H, K))
    dts = (jnp.bfloat16, jnp.bfloat16, jnp.float32, jnp.float32)

    def jrun(xi, se, bx, w, g):
        y, pull = jax.vjp(lambda *a: jf(*a, 2), xi, se, bx, w)
        return (y,) + pull(g)
    out_j = jax.jit(jrun)(*(jnp.asarray(a, d) for a, d in
                            zip((xi, s_eff, bx, w), dts)),
                          jnp.asarray(g, jnp.bfloat16))
    tdt = (torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    ts = [_t(a, d, grad=True) for a, d in zip((xi, s_eff, bx, w), tdt)]
    yt = pf(*ts, 2, mm=P.int8_mm_reference)
    assert yt.dtype == torch.bfloat16
    gt = torch.autograd.grad(yt, ts, _t(g, torch.bfloat16))
    assert_bf16_close(yt, out_j[0], "y")
    for name, a, b in zip(("dxi", "ds_eff", "dbx", "dw"), gt, out_j[1:]):
        assert a.dtype == ts[("dxi", "ds_eff", "dbx", "dw").index(
            name)].dtype, name
        assert_bf16_close(a, b, name)


# ------------------------------------------------------ frozen serving
def _frozen_case(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2, 2, size=(K, OUT)) * 2 + 1
    w_scale = rng.uniform(0.05, 2.0, size=(1, OUT)).astype(np.float32)
    w_q = (w_scale * (codes / 4.0)).astype(np.float32)
    qcodes = rng.integers(-2, 2, size=(H, K, K)) * 2 + 1
    qk_scale = rng.uniform(0.05, 2.0, size=(H * K, 1)).astype(np.float32)
    w_qk = (qk_scale.reshape(H, K, 1) * (qcodes / 4.0)).astype(np.float32)
    return w_q, w_scale, w_qk, qk_scale


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_frozen_forms(dtype):
    w_q, w_scale, w_qk, qk_scale = _frozen_case(60)
    x, _, s, b_pre, b_post, _ = _linear_case(61, 2, True)
    xi, s_eff, bx = _chain_case(62, np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = dict(rel=1e-5) if dtype == "float64" else None

    def both(jfn, pfn, stream, rest, **kw):
        ctx = x64() if dtype == "float64" else contextlib.nullcontext()
        with ctx:
            yj = jfn(*(jnp.asarray(a, jdt) for a in stream),
                     *(jnp.asarray(a) for a in rest), **kw)
        yt = pfn(*(_t(a, tdt) for a in stream),
                 *(torch.from_numpy(np.asarray(a)) for a in rest),
                 mm=P.int8_mm_reference, **kw)
        assert yt.dtype == tdt
        if tol:
            _close(yt, np.asarray(yj), pfn.__name__, **tol)
        else:
            np.testing.assert_array_equal(yt.float().numpy(),
                                          np.asarray(yj, np.float32))
    both(J.frozen_int8_forward, P.frozen_int8_forward, (x,),
         (w_q, w_scale, s.astype(np.float32), b_pre.astype(np.float32),
          b_post.astype(np.float32)), w_bits=2, a_bits=2, all_positive=True)
    both(lambda xi, se, bx, *r: J.frozen_int8_linear(xi, se, bx, *r, 2),
         lambda xi, se, bx, *r, mm: P.frozen_int8_linear(xi, se, bx, *r, 2,
                                                          mm=mm),
         (xi, s_eff, bx), (w_q, w_scale))
    both(lambda xi, se, bx, *r: J.frozen_int8_qkx(xi, se, bx, *r, 2),
         lambda xi, se, bx, *r, mm: P.frozen_int8_qkx(xi, se, bx, *r, 2,
                                                       mm=mm),
         (xi, s_eff, bx), (w_qk, qk_scale))
    w_int, col = P.frozen_weight_int(torch.from_numpy(w_q),
                                     torch.from_numpy(w_scale), 2)
    yj = J.int8_code_dot(jnp.asarray(xi, jnp.float32), jnp.asarray(
        w_int.numpy()), jnp.asarray(col.numpy()))
    yt = P.int8_code_dot(torch.from_numpy(xi.astype(np.float32)), w_int, col,
                         mm=P.int8_mm_reference)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


# ------------------------------------ eligibility and the graph's ends
@pytest.mark.parametrize("w_bits,a_bits,symmetric", [(8, 8, True),
                                                     (2, 8, False)])
def test_ineligible_widths_take_the_composed_path(w_bits, a_bits, symmetric):
    from ofq_tpu_torch.nn import QLinear
    rng = np.random.default_rng(70)
    x = np.abs(rng.normal(size=(2, 5, 8))) * 4.0
    mods = [QLinear(8, 16, 5, weight_bits=w_bits, input_bits=a_bits,
                    symmetric=symmetric, matmul_impl=impl).double()
            for impl in (None, "int8")]
    state = {k: torch.from_numpy(rng.normal(size=v.shape))
             for k, v in mods[0].state_dict().items()}
    state["input_quant.s"] = state["input_quant.s"].abs() + 0.1
    outs, grads = [], []
    for m in mods:
        m.load_state_dict(state)
        m.train()
        xt = _t(x, grad=True)
        y = m(xt)
        outs.append(y.detach().numpy())
        grads.append([g.numpy() for g in torch.autograd.grad(
            y.sum(), [xt] + list(m.parameters()))])
    np.testing.assert_array_equal(outs[1], outs[0])
    for a, b in zip(grads[1], grads[0]):
        np.testing.assert_array_equal(a, b)
    assert not P.int8_eligible(w_bits, a_bits, not symmetric)


def test_the_int_product_refuses_a_graph_cut():
    xi = _t(np.ones((2, 3, 8)), torch.float32, grad=True)
    w = torch.ones(8, 8)
    with pytest.raises(RuntimeError, match="requires grad"):
        P.int8_code_dot(xi, w, torch.ones(8), mm=P.int8_mm_reference)
    with pytest.raises(RuntimeError, match="requires grad"):
        P.frozen_int8_forward(xi, w, torch.ones(1, 8), torch.ones(3),
                              torch.zeros(8), torch.zeros(8), w_bits=2,
                              a_bits=2, all_positive=False,
                              mm=P.int8_mm_reference)
    with torch.no_grad():
        P.int8_code_dot(xi, w, torch.ones(8), mm=P.int8_mm_reference)
    # the autograd Functions take the product with grad mode off and give
    # every input its gradient
    x, kernel, s, b_pre, b_post, g = _linear_case(80, 2, False)
    ts = [_t(a, grad=True) for a in (x, kernel, s, b_pre, b_post)]
    y = P.int8_qlinear(*ts, 2, 2, False, mm=P.int8_mm_reference)
    assert y.requires_grad
    assert all(gr is not None and torch.any(gr != 0)
               for gr in torch.autograd.grad(y, ts, _t(g)))
