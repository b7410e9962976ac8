"""The port's Swin models as a whole against `ofq_tpu.models.swin`, on the
CPU, at `swin_test` size (img 32, patch 4, dim 12, depths (1, 1), heads
(2, 4), window 4; the (2, 2)-deep variant adds a shifted block), and
Swin-T's parameter tree.

  * fp64, composed path: the float model and the W2A2 QKR student
    (`w2a2_qkr_swin_policy`) from the same converted variables, logits
    within rtol 1e-9; `calibrate` against Flax's data-dependent init;
  * Swin-T's float and W2A2 QKR trees (`jax.eval_shape`) load strictly
    both ways, so the parameter count is JAX's (28 288 354 float);
  * the configurations once refused: the remat configurations, the
    student without QKR, the float model's Gram telemetry and the LN->BN
    swap (BN statistics, steps and serving: `test_torch_batchnorm.py`).
The bf16 stream and the Predictor: `test_torch_swin_serving.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (assert_scales_match, jax_calibrate,
                                    jit_x64_apply, jit_x64_init, load_into,
                                    perturb)

from ofq_tpu.models import swin as jswin
from ofq_tpu.quant import default_swin_qmodules, policy_from_args
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_swin_policy

NAME, IMG, CLASSES = "swin_test", 32, 1000


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3))


def _jax_policy(depths):
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qk_reparam_type=0,
                            qmodules=default_swin_qmodules(depths))


def _models(quantized, depths=(1, 1), **kw):
    """The JAX model and the port's, for `swin_test` at `depths`."""
    jpol = _jax_policy(depths) if quantized else jswin.QuantPolicy()
    tpol = w2a2_qkr_swin_policy(depths) if quantized else QuantPolicy()
    jm = jswin.swin_model(NAME, jpol, depths=depths, **kw)
    tm = create_model(NAME, policy=tpol, device="cpu", depths=depths, **kw)
    return jm, tm


def _with_head(variables, rng):
    """Random shifts and biases everywhere and a random head kernel (the
    JAX init zeroes the quantized head's)."""
    out = perturb(variables, rng)
    k = out["params"]["head"]["kernel"]
    out["params"]["head"]["kernel"] = (rng.normal(size=k.shape) * 0.2
                                       ).astype(k.dtype)
    return out


def _fp64_variables(jm, x, quantized, reference=True):
    """fp64 variables of `jm`, calibrated on `x` when `quantized` (the
    eager reference calibration, or with `reference=False`, for variables
    that only feed both packages, compiled)."""
    variables = jit_x64_init(jm, jax.random.key(0), x, np.float64,
                             train=False)
    if quantized:
        variables = jax_calibrate(jm, variables, x, jit=not reference,
                                  train=False)
    return variables


@pytest.mark.parametrize("quantized,depths", [
    (False, (1, 1)), (True, (1, 1)), (True, (2, 2))])
def test_fp64_logits(quantized, depths):
    x = _images(0)
    jm, tm = _models(quantized, depths)
    variables = _fp64_variables(jm, x, quantized, reference=False)
    shifted = _with_head(variables, np.random.default_rng(1))
    want, info = jit_x64_apply(jm, shifted, x, train=False)
    assert info is None
    load_into(tm.double(), shifted)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (4, CLASSES) and got.dtype == np.float64
    assert np.abs(want).max() > 1e-3  # non-trivial logits
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("depths", [(1, 1), (2, 2)])
def test_calibrate_matches_flax_init(depths):
    x = _images(2)
    jm, tm = _models(True, depths)
    variables = _fp64_variables(jm, x, True)
    load_into(tm.double(), variables)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith(".s"):
                p.fill_(1.0)
        tm.patch_embed.input_quant.signed.fill_(0.0)
    calibrate(tm, x)
    assert_scales_match(variables, tm)
    # per-width-column scales of the 4-D MLP and reduction inputs; 49
    # per-token scales in the windows
    assert tuple(tm.features_1_0.mlp.fc1.input_quant.s.shape) == (8,)
    assert tuple(tm.features_2.reduction.input_quant.s.shape) == (4,)
    assert tuple(tm.features_1_0.attn.quant_x.s.shape) == (16,)


@pytest.mark.parametrize("quantized", [False, True])
def test_param_names_are_flax_paths(quantized):
    x = _images(3)
    jm, tm = _models(quantized)
    variables = jit_x64_init(jm, jax.random.key(0), x)
    flax_names = {k.split("/", 1)[1].replace("/", ".")
                  for k in flatten_flax_tree(variables)}
    port_names = set(dict(tm.named_parameters())) | set(
        dict(tm.named_buffers()))
    assert port_names == flax_names


@pytest.mark.parametrize("quantized", [False, True])
def test_swin_t_trees_load_strictly(quantized):
    """Swin-T's JAX tree (shapes from `jax.eval_shape`, zero values) loads
    into the port's Swin-T strictly both ways: the same names, shapes and
    parameter count."""
    jpol = _jax_policy((2, 2, 6, 2)) if quantized else jswin.QuantPolicy()
    tpol = w2a2_qkr_swin_policy() if quantized else QuantPolicy()
    jm = jswin.swin_model("swin_t", jpol)
    shapes = jax.eval_shape(
        lambda k: jm.init({"params": k}, jnp.zeros((1, 224, 224, 3))),
        jax.random.key(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_jax = sum(a.size for k, a in flatten_flax_tree(tree).items()
                if k.startswith("params/"))
    tm = create_model("swin_t", policy=tpol, device="cpu")
    load_flax_params(tm, tree)
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    if not quantized:
        assert n_jax == 28288354
    assert all(float(p.abs().max()) == 0 for p in tm.parameters())
    tree["params"]["head"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape.*head.bias"):
        load_flax_params(tm, tree)


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("swin_t", policy=w2a2_qkr_swin_policy())


@pytest.mark.parametrize("what", ["non-QKR", "qqkkvv", "BN"])
def test_once_refused_configs_fp64(what):
    """The configurations once refused: the W2A2 student without QKR
    (`QSwinAttention`, calibrated as Flax inits it), the float model
    with the Gram telemetry (`qqkkvv`: each block's (attn, q q^T, k k^T,
    v v^T) / sqrt(d)) and the W2A2 QKR student with the LN->BN swap
    (`norm_layer='batchnorm'`, calibrated, in eval mode through its
    running statistics), in fp64 against JAX's within rtol 1e-9."""
    x = _images(3)
    if what == "non-QKR":
        jpol = dataclasses.replace(_jax_policy((1, 1)), qk_reparam=False)
        tpol = dataclasses.replace(w2a2_qkr_swin_policy((1, 1)),
                                   qk_reparam=False)
        kw = {}
    elif what == "BN":
        jpol, tpol = _jax_policy((1, 1)), w2a2_qkr_swin_policy((1, 1))
        kw = dict(norm_layer="batchnorm")
    else:
        jpol, tpol, kw = jswin.QuantPolicy(), QuantPolicy(), dict(
            qqkkvv=True)
    jm = jswin.swin_model(NAME, jpol, depths=(1, 1), **kw)
    tm = create_model(NAME, policy=tpol, device="cpu", depths=(1, 1), **kw)
    quantized = what != "qqkkvv"
    variables = _fp64_variables(jm, x, quantized)
    if quantized:
        load_into(tm.double(), variables)
        calibrate(tm, x)
        assert_scales_match(variables, tm)
    shifted = _with_head(variables, np.random.default_rng(4))
    want, info = jit_x64_apply(jm, shifted, x, train=False)
    load_into(tm.double(), shifted)
    with torch.no_grad():
        got, got_info = tm(torch.from_numpy(x), aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    if quantized:
        assert info is None and got_info is None
        return
    assert len(got_info) == len(info) == 2
    for a, b in zip(got_info, info):
        for u, w in zip(a, b):
            np.testing.assert_allclose(u.numpy(), np.asarray(w), rtol=1e-9,
                                       atol=1e-12)


def test_fused_attention_and_train_mode_drop_path_raise():
    """The fused core is not Swin's; train-mode drop-path (Swin-T's
    default rate 0.2) needs a generator and runs with one."""
    with pytest.raises(NotImplementedError, match="not supported for Swin"):
        create_model(NAME, policy=w2a2_qkr_swin_policy((1, 1)),
                     device="cpu", attn_impl="fused")
    m = create_model("swin_t", policy=QuantPolicy(), device="cpu",
                     depths=(2,), num_heads=(3,), img_size=28)
    m.train()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        m(torch.zeros(1, 28, 28, 3))
    y = m(torch.ones(1, 28, 28, 3), torch.Generator().manual_seed(0))
    assert y.shape == (1, 1000) and torch.isfinite(y).all()


@pytest.mark.parametrize("kw", [dict(remat_stages=(0, 1)),
                                dict(attn_impl="remat")])
def test_remat_configs_run_as_the_plain_model(kw):
    """`remat_stages` and `attn_impl='remat'` (once refused) build, and in
    train mode give the plain model's logits and gradients in fp64, with
    drop-path on (the bit-level checks: `test_torch_remat.py`)."""
    pol = w2a2_qkr_swin_policy((2, 2))
    x = torch.from_numpy(_images(0)).double()
    outs = []
    for extra in ({}, kw):
        m = create_model(NAME, policy=pol, device="cpu", depths=(2, 2),
                         drop_path_rate=0.2, **extra).double().train()
        if extra:
            m.load_state_dict(ref_state)
        ref_state = m.state_dict()
        y = m(x, torch.Generator().manual_seed(1))
        g = torch.autograd.grad(y.square().sum(),
                                m.features_1_1.attn.q_kernel)[0]
        outs.append((y, g))
    assert torch.allclose(outs[0][0], outs[1][0], rtol=1e-12, atol=0)
    assert torch.allclose(outs[0][1], outs[1][1], rtol=1e-9, atol=1e-15)
