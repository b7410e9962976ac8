"""Layer gradients of the port against the Flax modules of `ofq_tpu.nn`.

For each layer: the Flax variables are made by a jitted `init` (x64),
the zero-initialised shifts are set to seeded random values, the port
loads them with `load_flax_params`, and one seeded cotangent goes back
through `jax.vjp` of the jitted `apply` and through the port's autograd
(the port's module in train mode).  Compared: the output, dx and every parameter's gradient.

  * composed branches and float layers in fp64: rtol 1e-9, except the
    gradients of LSQ scales (`s`) and LearnableBias shifts (`move*`),
    which both frameworks sum in fp32 (other orders): 1e-5 of the leaf's
    or dx's largest magnitude;
  * fused branches in fp32, the Pallas kernels in interpret mode: within
    1e-4 relative and 1e-5 * max(1, max|ref|) absolute (products and sums
    in other orders).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, jit_x64_init, load_into, perturb, to_jax_tree,
    to_numpy_tree, x64, x64_jit)

from ofq_tpu.nn import attention as jattn
from ofq_tpu.nn import conv as jconv
from ofq_tpu.nn import linear as jlin
from ofq_tpu_torch.convert import flatten_flax_tree
from ofq_tpu_torch.nn import (Attention, Dense, Mlp, PatchEmbedConv,
                              QAttentionQKR, QHeadLinear, QLinear, QMlp,
                              QPatchEmbedConv)

B, N, C, H = 2, 10, 24, 3


def _out(y):
    return y[0] if isinstance(y, tuple) else y


def _tokens(seed, shape=(B, N, C), positive=False):
    x = np.random.default_rng(seed).normal(size=shape)
    return np.abs(x) if positive else x


def _fp32_summed(name):
    leaf = name.rsplit(".", 1)[-1]
    return leaf == "s" or "move" in name


def _jax_vjp(jmod, variables, x, g_seed, dtype, mutable=()):
    """Output, cotangents {'x': dx, '<flax path with .>': dparam} and the
    updated mutable collections of `jmod` at `variables`."""
    v = to_jax_tree(variables, dtype)
    rest = {k: val for k, val in v.items() if k != "params"}

    def f(p, xx):
        if mutable:
            out, upd = jmod.apply({"params": p, **rest}, xx,
                                  mutable=list(mutable))
            return _out(out), upd
        return _out(jmod.apply({"params": p, **rest}, xx)), {}

    y, vjp, upd = jax.vjp(jax.jit(f), v["params"], jnp.asarray(x, dtype),
                          has_aux=True)
    g = np.random.default_rng(g_seed).normal(size=y.shape).astype(dtype)
    gp, gx = vjp(jnp.asarray(g))
    grads = {k.replace("/", "."): v for k, v in
             flatten_flax_tree(to_numpy_tree(gp)).items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y), g, grads, to_numpy_tree(upd)


def _port_vjp(tmod, x, g):
    tmod.train()
    xt = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in tmod.named_parameters()]
    y = tmod(xt)
    cot = torch.autograd.grad(_out(y), [xt] + [p for _, p in
                                               tmod.named_parameters()],
                              torch.from_numpy(g), allow_unused=True)
    grads = {"x": cot[0]}
    grads.update(dict(zip(names, cot[1:])))
    return _out(y).detach().numpy(), {
        k: (np.zeros(()) if v is None else v.numpy())
        for k, v in grads.items()}


def _variables(jmod, x, seed, names=("bias",)):
    variables = jit_x64_init(jmod, jax.random.key(seed), x, np.float64)
    return perturb(variables, np.random.default_rng(seed), names=names)


def _check_grads_fp64(jmod, tmod, x, seed=0, names=("bias",), mutable=()):
    variables = _variables(jmod, x, seed, names)
    with x64_jit():
        yj, g, gj, upd = _jax_vjp(jmod, variables, x, seed + 100,
                                  np.float64, mutable)
    load_into(tmod.double(), variables)
    yt, gt = _port_vjp(tmod, x, g)
    np.testing.assert_allclose(yt, yj, rtol=1e-10, atol=1e-12)
    assert set(gt) == set(gj)
    _assert_grads_close(gt, gj)
    return variables, upd, gj


def _assert_grads_close(gt, gj):
    """fp64 leaves to 1e-9 of their largest magnitude; fp32-summed leaves
    to 1e-5 of their own or dx's largest magnitude, whichever is larger (a
    shift whose gradient cancels to ~0, like `move_qkx_aft` under the
    softmax, keeps the fp32 sum's noise)."""
    x_scale = float(np.abs(gj["x"]).max())
    for k, want in gj.items():
        scale = float(np.abs(want).max())
        if _fp32_summed(k):
            tol, scale = 1e-5, max(scale, x_scale)
        else:
            tol = 1e-9
        np.testing.assert_allclose(gt[k], want, rtol=tol,
                                   atol=tol * max(scale, 1e-30), err_msg=k)


def _check_grads_fused_fp32(jmod_init, jmod_fused, tmod, x, seed=0):
    variables = perturb(to_numpy_tree(jmod_init.init(
        {"params": jax.random.key(seed)}, jnp.asarray(x, jnp.float32))),
        np.random.default_rng(seed))
    yj, g, gj, _ = _jax_vjp(jmod_fused, variables, x, seed + 100, np.float32)
    load_into(tmod, variables, torch.float32)
    yt, gt = _port_vjp(tmod, x.astype(np.float32), g)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    assert set(gt) == set(gj)
    for k, want in gj.items():
        np.testing.assert_allclose(
            gt[k], want, rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=k)


# ---------------------------------------------------------- quantized
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_qlinear_grads(symmetric, bits):
    x = _tokens(1, positive=not symmetric)
    kw = dict(weight_bits=bits, input_bits=bits, symmetric=symmetric)
    _check_grads_fp64(jlin.QLinear(16, **kw), QLinear(C, 16, N, **kw), x)


@pytest.mark.parametrize("symmetric", [True, False])
def test_qlinear_fused_grads(jax_interpret, symmetric):
    x = _tokens(2, positive=not symmetric)
    kw = dict(weight_bits=2, input_bits=2, symmetric=symmetric)
    _check_grads_fused_fp32(jlin.QLinear(16, **kw),
                            jlin.QLinear(16, matmul_impl="fused", **kw),
                            QLinear(C, 16, N, matmul_impl="fused", **kw), x)


def test_qlinear_aq_not_learnable():
    x = _tokens(3)
    kw = dict(weight_bits=2, input_bits=2, aq_learnable=False)
    _, _, gj = _check_grads_fp64(jlin.QLinear(16, **kw),
                                 QLinear(C, 16, N, **kw), x)
    assert not np.any(gj["input_quant.s"])


def test_qmlp_grads():
    kw = dict(weight_bits=2, input_bits=2)
    _check_grads_fp64(jlin.QMlp(hidden_features=48, out_features=C, **kw),
                      QMlp(C, 48, C, N, **kw), _tokens(4))


def test_qmlp_fused_grads(jax_interpret):
    kw = dict(hidden_features=48, out_features=C, weight_bits=2,
              input_bits=2)
    _check_grads_fused_fp32(
        jlin.QMlp(**kw), jlin.QMlp(matmul_impl="fused", **kw),
        QMlp(C, 48, C, N, weight_bits=2, input_bits=2, matmul_impl="fused"),
        _tokens(5))


def test_qhead_linear_grads():
    _check_grads_fp64(
        jlin.QHeadLinear(12, kernel_init=fnn.initializers.lecun_normal()),
        QHeadLinear(C, 12), _tokens(6, shape=(4, C)),
        names=("bias", "kernel"))


@pytest.mark.parametrize("stored_signed", [False, True])
def test_qpatch_embed_grads_and_sticky_sign(stored_signed):
    """Train mode: the stored sign becomes max(stored, batch) before use,
    as JAX's train step updates the mutable `quant_stats` collection; the
    gradients then follow the updated range."""
    x_init = _tokens(7, shape=(B, 32, 32, 3), positive=not stored_signed)
    jm = jconv.QPatchEmbedConv(features=C, patch_size=(8, 8),
                               img_size=(32, 32))
    tm = QPatchEmbedConv(3, C, (8, 8), (32, 32))
    # init on x_init stores its sign; the shifted batch has negatives
    variables = _variables(jm, x_init, 7)
    x = _tokens(8, shape=(B, 32, 32, 3))
    with x64():
        _, g, gj, upd = _jax_vjp(jm, variables, x, 9, np.float64,
                                 mutable=("quant_stats",))
    load_into(tm.double(), variables)
    assert float(tm.input_quant.signed) == float(stored_signed)
    _, gt = _port_vjp(tm, x, g)
    assert float(upd["quant_stats"]["input_quant"]["signed"]) == 1.0
    assert float(tm.input_quant.signed) == 1.0
    _assert_grads_close(gt, gj)


@pytest.mark.parametrize("quantize_softmax", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_qattention_qkr_grads(quantize_softmax, bits):
    kw = dict(weight_bits=bits, input_bits=bits,
              quantize_softmax=quantize_softmax)
    _, _, gj = _check_grads_fp64(jattn.QAttentionQKR(num_heads=H, **kw),
                                 QAttentionQKR(C, H, N, **kw), _tokens(10))
    assert np.abs(gj["q_kernel"]).max() > 0
    assert np.abs(gj["k_kernel"]).max() > 0


@pytest.mark.parametrize("quantize_softmax", [True, False])
def test_qattention_qkr_fused_grads(jax_interpret, quantize_softmax):
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    _check_grads_fused_fp32(
        jattn.QAttentionQKR(num_heads=H, **kw),
        jattn.QAttentionQKR(num_heads=H, matmul_impl="fused",
                            attn_impl="fused", **kw),
        QAttentionQKR(C, H, N, matmul_impl="fused", attn_impl="fused", **kw),
        _tokens(11))


# ------------------------------------------------------------- float
def test_dense_grads():
    _check_grads_fp64(fnn.Dense(16), Dense(C, 16), _tokens(12))


def test_float_attention_grads():
    _check_grads_fp64(jattn.Attention(num_heads=H), Attention(C, H),
                      _tokens(13))


def test_float_mlp_grads():
    _check_grads_fp64(jlin.Mlp(hidden_features=48, out_features=C),
                      Mlp(C, 48, C), _tokens(14))


def test_float_patch_embed_grads():
    _check_grads_fp64(jconv.PatchEmbedConv(features=C, patch_size=(8, 8)),
                      PatchEmbedConv(3, C, (8, 8)),
                      _tokens(15, shape=(B, 32, 32, 3)))
