"""The arithmetic that K1's tensor-core kernel rests on, on the CPU.

The kernel (`ofq_tpu_torch/csrc/fused_qlinear.cu`, `tc_gemm.cuh`)
multiplies exact bf16 codes with fp32 sums in the tensor cores' order, and
forms the codes as step functions read off per-column (per-token) tables.
It does not run here, so this file emulates each in torch / numpy and
holds the emulation against the plain version, and the plain version
against the JAX package's Pallas kernel in interpret mode:

  * K1's sum of LSQ codes times odd StatsQ codes, with the codes cast to
    bf16 and fp32 partial sums over k-chunks of 16 taken in a shuffled
    order, gives `fused_qlinear_fwd_reference`'s bits at W2A2 and W4A4
    (integer partial sums below 2^24), and past that bound (W8A8, K = 1536
    at large codes) differs: the reason the bound is stated;
  * the codes as step functions (the tables the kernel builds with the
    exact expression on 9-float windows) equal the codes computed per
    element, everywhere near every step, StatsQ and LSQ ties included;
  * the division the kernel's tables use, RN(a * RN64(1 / b)) in fp64,
    gives fp32's correctly rounded a / b.

Inputs come from seeded numpy; StatsQ ties (mean|w| = 0.5, c n integral)
and LSQ ties ((x + b_pre) / s = k + 0.5) are built in, and K is no
multiple of 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofq_tpu.ops import fused_qlinear as jfq
from ofq_tpu_torch.ops import fused_qlinear as fq
from ofq_tpu_torch.quant.lsq import thresholds

F32 = np.float32


# ----------------------------------------------------------------- inputs
def _weight(rng, K, N, n):
    """Half the columns on StatsQ ties (mean|w| = 0.5, every c n
    integral); the rest lecun-normal."""
    w = rng.normal(size=(K, N)) / np.sqrt(K)
    t = rng.integers(0, n // 2 + 1, size=(K // 2, N // 2)) / n
    tie = np.concatenate([0.5 - t, 0.5 + t, np.full((K % 2, N // 2), 0.5)])
    w[:, : N // 2] = tie * rng.choice([-1, 1], size=(K, N // 2))
    return w.astype(F32)


def _scale(w):
    return np.maximum(2 * np.abs(w).mean(0, keepdims=True), 1e-12).astype(F32)


def _k1_case(seed, M, n_tok, K, N, bits, all_positive):
    """Activations with a third of the entries on LSQ ties, per-token
    scales, shifts, a kernel with StatsQ ties; fp32 numpy."""
    rng = np.random.default_rng(seed)
    lo, hi = thresholds(bits, all_positive)
    x = rng.normal(size=(M, K))
    if all_positive:
        x = np.abs(x)
    s = rng.integers(64, 256, size=n_tok) / 128
    b_pre = rng.integers(-8, 9, size=K) / 256
    k = rng.integers(lo, hi, size=(M, K))
    tie = np.tile(s, M // n_tok)[:, None] * (k + 0.5) - b_pre
    x = np.where(rng.random((M, K)) < 1 / 3, tie, x)
    w = _weight(rng, K, N, 2 ** (bits - 1))
    bvec = rng.normal(size=N) * 0.1
    return [np.asarray(a, F32) for a in (x, s, b_pre, w, bvec)], lo, hi


# ---------------------------------------------- the tensor cores' sums
def _tc_sum(a, b, seed):
    """a (M, K) @ b (K, N) as the kernel sums it: products exact (the
    operands are bf16 values), fp32 sums over k-chunks of 16, the chunks'
    partial sums added in fp32 in a shuffled order."""
    M, K = a.shape
    Kp = -(-K // 16) * 16
    a = torch.nn.functional.pad(a.to(torch.float64), (0, Kp - K))
    b = torch.nn.functional.pad(b.to(torch.float64), (0, 0, 0, Kp - K))
    chunks = [(a[:, i:i + 16] @ b[i:i + 16]).to(torch.float32)
              for i in range(0, Kp, 16)]
    order = np.random.default_rng(seed).permutation(len(chunks))
    acc = torch.zeros(chunks[0].shape, dtype=torch.float32)
    for i in order:
        acc = acc + chunks[i]
    return acc


def _k1_codes(x, s, n_tok, b_pre, w, s_w, lo, hi, n_w):
    """K1's two code sets, as the plain version forms them."""
    rows = torch.arange(x.shape[0]) % n_tok
    u = (x + b_pre) / s[rows].reshape(-1, 1)
    xi = torch.round(torch.clamp(u, lo, hi))
    return xi, fq._w_levels_int(w, s_w, n_w), s[rows].reshape(-1, 1)


def _k1_emulated(case, bits, all_positive, n_tok, seed):
    (x, s, b_pre, w, bvec), lo, hi = case
    x, s, b_pre, w, bvec = map(torch.from_numpy, (x, s, b_pre, w, bvec))
    n_w = float(2 ** (bits - 1))
    s_w = torch.from_numpy(_scale(w.numpy()))
    xi, wi, s_row = _k1_codes(x, s, n_tok, b_pre, w, s_w, lo, hi, n_w)
    # both code sets exact in bf16
    assert torch.equal(xi.to(torch.bfloat16).float(), xi)
    assert torch.equal(wi.to(torch.bfloat16).float(), wi)
    acc = _tc_sum(xi, wi, seed)
    y = acc * s_row * (s_w / (2.0 * n_w)) + bvec
    ref = fq.fused_qlinear_fwd_reference(x, s, n_tok, b_pre, w, s_w, bvec,
                                         lo, hi, n_w)
    return y, ref, xi, wi


@pytest.mark.parametrize("bits,all_positive", [(2, False), (2, True),
                                               (4, False), (4, True)])
@pytest.mark.parametrize("M,n_tok,K,N", [(3 * 37, 37, 200, 72),
                                         (2 * 10, 10, 1535, 24)])
def test_k1_emulated_sum_is_bit_exact(bits, all_positive, M, n_tok, K, N):
    case = _k1_case(bits * K + N, M, n_tok, K, N, bits, all_positive)
    y, ref, xi, wi = _k1_emulated(case, bits, all_positive, n_tok, seed=K)
    # every partial sum an integer below 2^24
    assert K * float(xi.abs().max()) * float(wi.abs().max()) < 2 ** 24
    assert torch.equal(y, ref)


def test_k1_past_the_bound_differs():
    """W8A8 at K = 1536 with codes near their largest: K max|XI| max|WI|
    = 1536 * 128 * 255 is past 2^24, partial sums round, and the tensor
    cores' order gives other bits than the plain version's."""
    M, n_tok, K, N, bits = 2 * 8, 8, 1536, 16, 8
    rng = np.random.default_rng(8)
    x = (rng.integers(100, 128, size=(M, K)) * 1.0).astype(F32)
    s = np.ones(n_tok, F32)
    w = rng.uniform(0.9, 1.0, size=(K, N)).astype(F32)  # sums of one sign
    case = ([x, s, np.zeros(K, F32), w, np.zeros(N, F32)], -128, 127)
    y, ref, xi, wi = _k1_emulated(case, bits, False, n_tok, seed=3)
    assert K * float(xi.abs().max()) * float(wi.abs().max()) >= 2 ** 24
    assert bool((y != ref).any())
    # and the difference is of the size fp32 sums in two orders give
    assert float(((y - ref).abs() / ref.abs().max()).max()) <= 1e-5


@pytest.mark.parametrize("bits,all_positive", [(2, False), (4, True)])
def test_k1_plain_matches_pallas(bits, all_positive):
    M, n_tok, K, N = 3 * 37, 37, 200, 72
    (x, s, b_pre, w, bvec), lo, hi = _k1_case(11, M, n_tok, K, N, bits,
                                              all_positive)
    n_w = float(2 ** (bits - 1))
    s_w = _scale(w)
    s_full = np.tile(s, M // n_tok)[:, None].astype(F32)
    want = np.asarray(jfq._fwd_call(
        *(jnp.asarray(a) for a in (x, s_full, b_pre, w, s_w, bvec)),
        a_lo=lo, a_hi=hi, n_w=n_w, interpret=True, out_dtype=jnp.float32))
    got = fq.fused_qlinear_fwd_reference(
        *map(torch.from_numpy, (x, s)), n_tok,
        *map(torch.from_numpy, (b_pre, w, s_w, bvec)), lo, hi, n_w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------- the codes as step functions
def _div_rn(a, b):
    """The kernel's table division: RN32(RN64(a * RN64(1 / b)))."""
    return (np.asarray(a, np.float64) * (1.0 / np.float64(b))).astype(F32)


def _statsq_level(q, n):
    c = np.minimum(np.maximum(q, F32(-1.0)), F32(1.0 - 1e-6)).astype(F32)
    return np.rint((c * F32(n)).astype(F32) - F32(0.5)).astype(F32)


def _window(x0):
    """9 consecutive floats around x0, 4 below and 4 above."""
    x = F32(x0)
    for _ in range(4):
        x = np.nextafter(x, F32(-np.inf))
    out = [x]
    for _ in range(8):
        out.append(np.nextafter(out[-1], F32(np.inf)))
    return np.array(out, F32)


def _find_step(x0, f):
    xs = _window(x0)
    v = f(xs)
    for i in range(1, 9):
        if v[i] != v[i - 1]:
            return xs[i], v[i] - v[i - 1]
    return F32(np.inf), F32(0)


def _step_start(q, b):
    """The smallest a with RN(a / b) >= q, on a window around q b."""
    for a in _window(F32(q) * F32(b)):
        if _div_rn(a, b) >= q:
            return a
    raise AssertionError("no step start in the window")


def _statsq_tables(n):
    """The quotient steps of StatsQ's code (tc::statsq_steps)."""
    code = lambda c: (2 * _statsq_level(c, n) + 1).astype(F32)  # noqa: E731
    steps = []
    for jj in range(-n, n):
        x0 = -(2.0 ** -25) / n if jj == 0 else jj / n
        at, d = _find_step(x0, code)
        if d != 0:
            steps.append((at, d))
    base = code(np.array([-1.0], F32))[0]
    return steps, base


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_statsq_codes_as_steps(n):
    steps, base = _statsq_tables(n)
    assert len(steps) <= 2 * n
    rng = np.random.default_rng(n)
    for b in [F32(1.0), F32(0.0537), _scale(_weight(rng, 64, 4, n))[0, 0],
              F32(3.1e-3)]:
        t = [_step_start(q, b) for q, _ in steps]
        # every element near every step, and a spread of ordinary ones
        w = np.concatenate([_window(ti) for ti in t]
                           + [_window(F32(q * b) * F32(1.5))
                              for q, _ in steps]
                           + [rng.normal(size=512) * b,
                              np.arange(-2 * n, 2 * n + 1) / (2 * n) * b]
                           ).astype(F32)
        direct = 2 * _statsq_level(_div_rn(w, b), n) + 1
        by_steps = base + sum(d * (w >= ti) for (_, d), ti in zip(steps, t))
        np.testing.assert_array_equal(by_steps, direct)


@pytest.mark.parametrize("bits,all_positive", [(1, True), (2, False),
                                               (2, True), (4, False),
                                               (4, True)])
def test_lsq_codes_as_steps(bits, all_positive):
    lo, hi = thresholds(bits, all_positive)
    code = lambda u: np.rint(np.minimum(np.maximum(u, F32(lo)),  # noqa: E731
                                        F32(hi))).astype(F32)
    qs = [_find_step(F32(lo + j) + F32(0.5), code) for j in range(hi - lo)]
    assert all(d == 1 for _, d in qs)
    rng = np.random.default_rng(bits)
    for s in [F32(1.0), F32(0.75), F32(1e-5), F32(93 / 128)]:
        t = [_step_start(q, s) for q, _ in qs]
        a = np.concatenate([_window(ti) for ti in t]
                           + [(np.arange(lo, hi + 1) + 0.5) * s,
                              rng.normal(size=256) * s * (hi - lo)]
                           ).astype(F32)
        direct = code(_div_rn(a, s))
        by_steps = lo + sum((a >= ti).astype(F32) for ti in t)
        np.testing.assert_array_equal(by_steps, direct)


def test_fp64_reciprocal_division_is_correctly_rounded():
    """RN32(RN64(a * RN64(1 / b))) against fp32's division (numpy's is
    IEEE), on quotients that are exact, on StatsQ and LSQ ties, and on
    random operands over many binades."""
    rng = np.random.default_rng(0)
    b = np.concatenate([rng.uniform(1e-3, 4, 2000), [1.0, 3.0, 0.1, 1 / 3],
                        2.0 ** rng.integers(-20, 20, 200)]).astype(F32)
    a = np.concatenate([rng.normal(size=2000) * 10.0 ** rng.integers(-8, 8,
                                                                     2000),
                        (rng.integers(-64, 64, 204) / 8)]).astype(F32)
    a_ties = (b * (rng.integers(-8, 8, b.size) + 0.5)).astype(F32)
    for aa in (a, a_ties):
        want = (aa / b).astype(F32)
        got = np.array([_div_rn(x, y) for x, y in zip(aa, b)], F32)
        np.testing.assert_array_equal(got, want)
