"""The MLP activations besides GELU (`act_layer` relu, prelu, rprelu,
'None') against `ofq_tpu`, on the CPU:

  * `QMlp` (W2A2, 2 x 9 tokens of width 24, hidden 96) in fp64 from the
    same variables (random shifts, slopes and moves): the output and the
    gradients of its input and every parameter within 1e-9 of max(1, the
    largest magnitude) (the shifts' and the LSQ scales' within 1e-6: JAX
    sums the shifts' gradients in fp32, and both frameworks the
    scales'); the whole `deit_test_distilled` W2A2 QKR student's
    eval logits within 1e-9 relative;
  * PReLU and RPReLU in the bf16 stream bit for bit against JAX's jitted
    modules (the slopes and shifts rounded to bf16 before use; `x >= 0`
    takes the identity at 0);
  * one fp64 step each of a prelu and an rprelu student against JAX's
    jitted `make_train_step` at `test_torch_batchnorm.py`'s limits, the
    `act` parameters moved;
  * the float MLP stays GELU whatever the policy (the teacher and the
    unquantized sites hold no `act` parameters, as JAX's trees); an
    unknown name raises KeyError; `Predictor.from_flax_npz` serves an
    rprelu student against JAX's fp32 probabilities within 1e-5.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_batchnorm import assert_step_and_stats, family, step_run
from test_torch_dropout import x64_jit
from test_torch_port_common import to_jax_tree, to_numpy_tree
from test_torch_train_loop import _flat
from test_torch_train_slice import _with_heads

from ofq_tpu.models import deit as jdeit
from ofq_tpu.nn import linear as jlinear
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.nn import PReLU, QMlp, RPReLU
from ofq_tpu_torch.nn.linear import Mlp
from ofq_tpu_torch.quant import QuantPolicy
from ofq_tpu_torch.serve import Predictor

NAME = "deit_test_distilled"
ACTS = ["relu", "prelu", "rprelu", "None"]
B, N, C, HID = 2, 9, 24, 96


def _act_params(tree, rng):
    """Random slopes and moves under every `act`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _act_params(v, rng) if k != "act" else {
                n: (0.25 + 0.2 * rng.normal(size=a.shape) if n == "alpha"
                    else 0.3 * rng.normal(size=a.shape)).astype(a.dtype)
                for n, a in v.items()}
        else:
            out[k] = v
    return out


def _policies(act):
    _, jpol, tpol = family(NAME)
    return (dataclasses.replace(jpol, act_layer=act),
            dataclasses.replace(tpol, act_layer=act))


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("act", ACTS)
def test_qmlp_fp64(act):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, N, C))
    jm = jlinear.QMlp(hidden_features=HID, out_features=C, weight_bits=2,
                      input_bits=2, act_layer=act)
    with x64_jit():
        v = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
        v = _act_params(to_numpy_tree(v, np.float64), rng)
        for fc in ("fc1", "fc2"):
            for b in ("move_b4", "move_aft"):
                p = v["params"][fc][b]["bias"]
                v["params"][fc][b]["bias"] = 0.05 * rng.normal(size=p.shape)
        g = rng.normal(size=(B, N, C))

        def loss(params, xx):
            return jnp.sum(jm.apply({"params": params}, xx) * g)

        y = jax.jit(jm.apply)(to_jax_tree(v, np.float64), jnp.asarray(x))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            to_jax_tree(v, np.float64)["params"], jnp.asarray(x))
        y, gx = np.asarray(y), np.asarray(gx)
        gp = _flat(to_numpy_tree(gp))
    tm = QMlp(C, HID, C, N, weight_bits=2, input_bits=2,
              act_layer=act).double()
    load_flax_params(tm, v)
    assert {k for k in gp if k.startswith("act.")} == {
        k for k, _ in tm.named_parameters() if k.startswith("act.")}
    xt = torch.from_numpy(x).requires_grad_()
    yt = tm(xt)
    assert _rel(yt.detach().numpy(), y) <= 1e-9
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad((yt * torch.from_numpy(g)).sum(),
                                [xt, *params.values()])
    assert _rel(grads[0].numpy(), gx) <= 1e-9
    for (k, _), gt in zip(params.items(), grads[1:]):
        # JAX sums the shifts' gradients in fp32 (their parameters' dtype
        # at init) even from fp64 values, and both frameworks the LSQ
        # scales'
        tol = (1e-9 if gp[k].dtype == np.float64 and not k.endswith(".s")
               else 1e-6)
        assert _rel(gt.numpy(), gp[k]) <= tol, k


@pytest.mark.parametrize("act", ACTS)
def test_model_logits_fp64(act):
    jpol, tpol = _policies(act)
    jm = jdeit.deit_model(NAME, jpol)
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3))
    with x64_jit():
        v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(
            jax.random.key(0), jnp.asarray(x))
        v = _act_params(_with_heads(to_numpy_tree(v, np.float64),
                                    np.random.default_rng(4)),
                        np.random.default_rng(2))
        want, _ = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
            to_jax_tree(v, np.float64), jnp.asarray(x))
        want = np.asarray(want)
    tm = create_model(NAME, policy=tpol, device="cpu").double()
    load_flax_params(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 1e-3
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-9


@pytest.mark.parametrize("act", ["prelu", "rprelu"])
def test_prelu_rprelu_bf16_bit_for_bit(act):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 7, 40)).astype(np.float32)
    x[0, 0, :4] = 0.0
    x[0, 1, :4] = -0.0
    jm = jlinear.PReLU() if act == "prelu" else jlinear.RPReLU(40)
    tm = PReLU() if act == "prelu" else RPReLU(40)
    names = ["alpha"] if act == "prelu" else ["move1", "alpha", "move2"]
    params = {n: (0.2 + 0.1 * rng.random(size=(1 if act == "prelu" else 40,))
                  ).astype(np.float32) for n in names}
    load_flax_params(tm, params)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, xb)
                      .astype(jnp.float32))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("act", ["prelu", "rprelu"])
def test_act_step_fp64(act):
    jpol, tpol = _policies(act)
    r = step_run(NAME, jpol, tpol, step_kw=dict(loss_kind="kd_soft_hard"))
    assert_step_and_stats(r)
    init = {"alpha": 0.25, "move1": 0.0, "move2": 0.0}
    moved = [k for k, p in r["port"].named_parameters() if ".act." in k
             and float((p - init[k.rsplit(".", 1)[-1]]).abs().max()) > 0]
    assert len(moved) == (2 if act == "prelu" else 6), moved


def test_float_mlp_stays_gelu_and_unknown_names_raise():
    jpol, tpol = _policies("prelu")
    jm = jdeit.deit_model(NAME, jpol)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3))))
    flax_names = {k.split("/", 1)[1].replace("/", ".")
                  for k in flatten_flax_tree(jax.tree.map(
                      lambda s: np.zeros(s.shape), flax.core.unfreeze(
                          shapes)))}
    tm = create_model(NAME, policy=tpol, device="cpu")
    assert flax_names == set(dict(tm.named_parameters())) | set(
        dict(tm.named_buffers()))
    teacher = create_model(NAME, policy=dataclasses.replace(
        QuantPolicy(), act_layer="prelu"), device="cpu")
    assert not [k for k, _ in teacher.named_parameters() if ".act." in k]
    with pytest.raises(KeyError):
        QMlp(C, HID, C, N, weight_bits=2, input_bits=2, act_layer="swish")
    with pytest.raises(KeyError):
        Mlp(C, HID, C, act_layer="tanh")


def test_rprelu_predictor_from_flax_npz(tmp_path):
    jpol, tpol = _policies("rprelu")
    jm = jdeit.deit_model(NAME, jpol)
    x = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(
        jax.random.key(0), jnp.asarray(x))
    v = _act_params(_with_heads(to_numpy_tree(v), np.random.default_rng(7)),
                    np.random.default_rng(6))
    path = tmp_path / "rprelu.npz"
    np.savez(path, **flatten_flax_tree(v))
    pred = Predictor.from_flax_npz(str(path), model_name=NAME, policy=tpol,
                                   batch_size=4, device="cpu")
    logits, _ = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        to_jax_tree(v, np.float32), jnp.asarray(x))
    np.testing.assert_allclose(pred.predict(x),
                               np.asarray(jax.nn.softmax(logits, -1)),
                               atol=1e-5, rtol=0)
