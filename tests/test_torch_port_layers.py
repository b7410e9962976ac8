"""ofq_tpu_torch.nn layers vs their Flax modules in ofq_tpu.nn.

Each case inits the Flax module through the composed path, carries the
variables into the port with `load_flax_params`, and checks
  * calibration: the port's `calibrate` gives the scales that Flax's
    data-dependent init gives with the same fp64 weights in place
    (rtol 1e-7: both are float32-rounded from fp64 statistics);
  * the forward, with the zero-initialised shifts set to random values:
    composed branches in fp64 (rtol 1e-10), fused branches in fp32 against
    the JAX fused branch with its Pallas kernels in interpret mode
    (atol 1e-5, the kernels' own tolerance).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    assert_scales_match, jax_calibrate, jax_interpret, jit_x64_apply,
    jit_x64_init, load_into, perturb, to_jax_tree, to_numpy_tree)

from ofq_tpu.nn import attention as jattn
from ofq_tpu.nn import conv as jconv
from ofq_tpu.nn import linear as jlin
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.nn import (QAttentionQKR, QHeadLinear, QLinear, QMlp,
                              QPatchEmbedConv)

B, N, C, H = 2, 10, 24, 3


def _out(y):
    return y[0] if isinstance(y, tuple) else y


def _check_fp64(jmod, tmod, x, seed=0, names=("bias",)):
    """Calibration and composed forward in fp64."""
    rng = np.random.default_rng(seed)
    variables = jit_x64_init(jmod, jax.random.key(seed), x, np.float64)
    variables = jax_calibrate(jmod, variables, x)
    load_into(tmod, variables).eval()  # JAX applies with no mutable state
    calibrate(tmod, torch.from_numpy(x))
    assert_scales_match(variables, tmod)

    shifted = perturb(variables, rng, names=names)
    yj = np.asarray(_out(jit_x64_apply(jmod, shifted, x)))
    load_into(tmod, shifted)
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x)).numpy()
    assert yt.dtype == np.float64 and yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)
    return variables


def _check_fused_fp32(jmod_init, jmod_fused, tmod, x, seed=0):
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(x, jnp.float32)
    variables = to_numpy_tree(jax.jit(
        lambda k, xx: jmod_init.init({"params": k}, xx))(
            jax.random.key(seed), xj))
    shifted = perturb(variables, rng)
    yj = np.asarray(_out(jax.jit(jmod_fused.apply)(
        to_jax_tree(shifted, np.float32), xj)))
    load_into(tmod, shifted, torch.float32)
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x.astype(np.float32))).numpy()
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


def _tokens(seed, shape=(B, N, C), positive=False):
    x = np.random.default_rng(seed).normal(size=shape)
    return np.abs(x) if positive else x


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_qlinear_composed(symmetric, bits):
    x = _tokens(1, positive=not symmetric)
    jm = jlin.QLinear(16, weight_bits=bits, input_bits=bits,
                      symmetric=symmetric)
    tm = QLinear(C, 16, N, weight_bits=bits, input_bits=bits,
                 symmetric=symmetric)
    _check_fp64(jm, tm, x)


@pytest.mark.parametrize("symmetric", [True, False])
def test_qlinear_fused(jax_interpret, symmetric):
    x = _tokens(2, positive=not symmetric)
    kw = dict(weight_bits=2, input_bits=2, symmetric=symmetric)
    _check_fused_fp32(jlin.QLinear(16, **kw),
                      jlin.QLinear(16, matmul_impl="fused", **kw),
                      QLinear(C, 16, N, matmul_impl="fused", **kw), x)


def test_qlinear_fused_calibrates_on_composition():
    """Calibrating a fused QLinear sets the same scale as the composed one
    (the scale is fitted on the composition, not through the kernel)."""
    x = torch.from_numpy(_tokens(3)).float()
    a = QLinear(C, 16, N, weight_bits=2, input_bits=2, matmul_impl="fused")
    b = QLinear(C, 16, N, weight_bits=2, input_bits=2)
    b.load_state_dict(a.state_dict())
    calibrate(a, x)
    calibrate(b, x)
    torch.testing.assert_close(a.input_quant.s, b.input_quant.s, rtol=0,
                               atol=0)


def test_qmlp():
    x = _tokens(4)
    jm = jlin.QMlp(hidden_features=48, out_features=C, weight_bits=2,
                   input_bits=2)
    tm = QMlp(C, 48, C, N, weight_bits=2, input_bits=2)
    _check_fp64(jm, tm, x)


def test_qmlp_fused(jax_interpret):
    x = _tokens(5)
    kw = dict(hidden_features=48, out_features=C, weight_bits=2,
              input_bits=2)
    _check_fused_fp32(jlin.QMlp(**kw), jlin.QMlp(matmul_impl="fused", **kw),
                      QMlp(C, 48, C, N, weight_bits=2, input_bits=2,
                           matmul_impl="fused"), _tokens(5))


def test_qhead_linear():
    x = _tokens(6, shape=(4, C))
    jm = jlin.QHeadLinear(12, kernel_init=fnn.initializers.lecun_normal())
    tm = QHeadLinear(C, 12)
    _check_fp64(jm, tm, x, names=("bias", "kernel"))


@pytest.mark.parametrize("signed", [True, False])
def test_qpatch_embed(signed):
    x = _tokens(7, shape=(B, 32, 32, 3), positive=not signed)
    jm = jconv.QPatchEmbedConv(features=C, patch_size=(8, 8),
                               img_size=(32, 32))
    tm = QPatchEmbedConv(3, C, (8, 8), (32, 32))
    variables = _check_fp64(jm, tm, x)
    assert float(variables["quant_stats"]["input_quant"]["signed"]) == signed
    assert float(tm.input_quant.signed) == signed


def test_qpatch_embed_sticky_sign_is_read_as_stored():
    """Calibrated unsigned, then fed negatives: both sides keep the stored
    unsigned range in the eval forward."""
    x_pos = _tokens(8, shape=(B, 32, 32, 3), positive=True)
    x_neg = _tokens(9, shape=(B, 32, 32, 3))
    jm = jconv.QPatchEmbedConv(features=C, patch_size=(8, 8),
                               img_size=(32, 32))
    tm = QPatchEmbedConv(3, C, (8, 8), (32, 32))
    variables = jit_x64_init(jm, jax.random.key(0), x_pos, np.float64)
    yj = np.asarray(jit_x64_apply(jm, variables, x_neg))
    load_into(tm, variables).eval()
    with torch.no_grad():
        yt = tm(torch.from_numpy(x_neg)).numpy()
    assert float(tm.input_quant.signed) == 0.0
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("quantize_softmax", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_qattention_qkr_composed(quantize_softmax, bits):
    x = _tokens(10)
    jm = jattn.QAttentionQKR(num_heads=H, weight_bits=bits, input_bits=bits,
                             quantize_softmax=quantize_softmax)
    tm = QAttentionQKR(C, H, N, weight_bits=bits, input_bits=bits,
                       quantize_softmax=quantize_softmax)
    _check_fp64(jm, tm, x)


@pytest.mark.parametrize("quantize_softmax", [True, False])
def test_qattention_qkr_fused(jax_interpret, quantize_softmax):
    x = _tokens(11)
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    _check_fused_fp32(
        jattn.QAttentionQKR(num_heads=H, **kw),
        jattn.QAttentionQKR(num_heads=H, matmul_impl="fused",
                            attn_impl="fused", **kw),
        QAttentionQKR(C, H, N, matmul_impl="fused", attn_impl="fused", **kw),
        x)


def test_qattention_qkr_calibration_bypasses_kernel():
    """A fused-attention module calibrates the softmax scale on the
    composition: the same scales as a composed module."""
    x = torch.from_numpy(_tokens(12)).float()
    a = QAttentionQKR(C, H, N, weight_bits=2, input_bits=2,
                      attn_impl="fused", matmul_impl="fused")
    b = QAttentionQKR(C, H, N, weight_bits=2, input_bits=2)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in a.parameters():
            p.normal_(generator=g)
    b.load_state_dict(a.state_dict())
    calibrate(a, x)
    calibrate(b, x)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("bits", [dict(weight_bits=32, input_bits=2),
                                  dict(weight_bits=2, input_bits=32)])
def test_unquantized_site_runs_as_jax(bits):
    """An unquantized site (32 bits), once refused: weight-only A32 holds
    no input chain, W32 takes the plain product; the same parameters as
    JAX's and its fp64 output, fused or not (JAX's fused branch needs both
    quantized, so both run the composition)."""
    x = _tokens(13)
    for impl in (None, "fused"):
        jm = jlin.QLinear(16, matmul_impl=impl, **bits)
        tm = QLinear(C, 16, N, matmul_impl=impl, **bits)
        rng = np.random.default_rng(14)
        variables = perturb(jit_x64_init(jm, jax.random.key(0), x,
                                         np.float64), rng)
        yj = np.asarray(jit_x64_apply(jm, variables, x))
        load_into(tm.double(), variables)
        assert (tm.input_quant is None) == (bits["input_bits"] == 32)
        with torch.no_grad():
            yt = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)


def test_unquantized_attention_sites_run_as_jax():
    """QKR at 32 input bits (its activation quantizers the identity, no
    softmax scale) and at 32 weight bits, in fp64 against JAX's."""
    x = _tokens(15)
    for bits in (dict(weight_bits=32, input_bits=2),
                 dict(weight_bits=2, input_bits=32)):
        jm = jattn.QAttentionQKR(num_heads=H, **bits)
        tm = QAttentionQKR(C, H, N, **bits)
        variables = perturb(jit_x64_init(jm, jax.random.key(0), x,
                                         np.float64),
                            np.random.default_rng(16))
        yj = np.asarray(_out(jit_x64_apply(jm, variables, x)))
        load_into(tm.double(), variables)
        with torch.no_grad():
            yt = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)
