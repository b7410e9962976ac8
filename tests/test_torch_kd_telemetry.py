"""The distillation losses with telemetry against `ofq_tpu.train`, on the
CPU: the Gram telemetry of the attentions (`qqkkvv`), the token features
(`return_features`), the losses that read them and one train step of each
new `loss_kind`.

  * `_normed_l2_distance`, `direction_matching` (a masked entry <= -100
    on both sides), `kd_soft_hard_qk` (with and without v) and
    `kl_token_mse` ('last', 'all', a student with extra leading tokens)
    in fp64: the values to 1e-12 relative, the gradients to 1e-10;
  * the Grams of `Attention`, `QAttention` and `QAttentionQKR` (the
    un-reparameterized q and k of the shared quantized input) and the
    models' aux (`(logits, infos)`, `{"attn_infos", "features"}`) in fp64
    against JAX's, to 1e-10 of max(1, the largest magnitude);
  * one step of `kd_qk`, `kd_qkv` and `kd_token` of the composed
    `deit_test_distilled` W2A2 QKR student and its float teacher, both
    built with the telemetry, against JAX's jitted `make_train_step` under
    x64 from the same parameters, `quant_stats` and mid-run Adam state:
    the loss to 1e-9 relative, the gradient norm to 1e-6 (the LSQ scale
    and shift gradients are summed in fp32 on both sides, in other
    orders) and every parameter to 1e-9 of max(1, its largest magnitude),
    as `test_torch_train_slice.py`'s first step.  `step_case` and
    `assert_step` serve the other slices' step tests.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dropout import _jitted_init, x64_jit
from test_torch_port_common import (jit_x64_apply, jit_x64_init, perturb,
                                    to_jax_tree, to_numpy_tree, x64)
from test_torch_swin_model import _with_head
from test_torch_train_loop import _flat, _mid_run_adam
from test_torch_train_slice import LR, START, _batches, _jax_state, _with_heads

from ofq_tpu.models import deit as jdeit
from ofq_tpu.models import swin as jswin
from ofq_tpu.nn import attention as jattn
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu.train import losses as jlosses
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.nn import Attention, QAttention, QAttentionQKR
from ofq_tpu_torch.quant import QuantPolicy, w2a2_deit_policy
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 direction_matching, kd_soft_hard_qk,
                                 kl_token_mse, make_optimizer,
                                 make_train_step)
from ofq_tpu_torch.train.losses import _normed_l2_distance

NAME = "deit_test_distilled"
B, N, C, H = 2, 10, 24, 3


def _t(a):
    return torch.from_numpy(np.asarray(a)).requires_grad_()


# ---------------------------------------------------------------- losses
def _grams(seed, layers=2, shape=(2, 3, 5, 5)):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(layers):
        g = [rng.normal(size=shape) for _ in range(4)]
        g[1][0, 0, 0, :2] = -200.0  # masked entries
        out.append(tuple(g))
    return out


def test_normed_l2_distance_and_direction_matching():
    s, t = _grams(0), _grams(1)
    with x64():
        want_d = float(jlosses._normed_l2_distance(jnp.asarray(s[0][0]),
                                                   jnp.asarray(t[0][0])))
        want, jg = jax.value_and_grad(lambda a: jlosses.direction_matching(
            a, [jnp.asarray(x[1]) for x in t]))(
                [jnp.asarray(x[1]) for x in s])
    got_d = float(_normed_l2_distance(torch.from_numpy(s[0][0]),
                                      torch.from_numpy(t[0][0])))
    assert abs(got_d - want_d) <= 1e-12 * want_d
    ts = [_t(x[1]) for x in s]
    got = direction_matching(ts, [torch.from_numpy(x[1]) for x in t])
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-12 * float(want)
    for a, b in zip(ts, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("include_v", [False, True])
def test_kd_soft_hard_qk(include_v):
    rng = np.random.default_rng(2)
    c, d, tl = (rng.normal(size=(2, 7)) * 3 for _ in range(3))
    y = rng.integers(0, 7, size=2)
    s, t = _grams(3), _grams(4)
    with x64():
        want, (jc, js) = jax.value_and_grad(
            lambda c, si: jlosses.kd_soft_hard_qk(
                (c, jnp.asarray(d)), si, jnp.asarray(y), jnp.asarray(tl),
                [tuple(map(jnp.asarray, x)) for x in t], include_v),
            argnums=(0, 1))(jnp.asarray(c),
                            [tuple(map(jnp.asarray, x)) for x in s])
    tc = _t(c)
    ts = [tuple(_t(a) for a in x) for x in s]
    got = kd_soft_hard_qk((tc, torch.from_numpy(d)), ts, torch.from_numpy(y),
                          torch.from_numpy(tl),
                          [tuple(map(torch.from_numpy, x)) for x in t],
                          include_v)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-12 * abs(float(want))
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jc), rtol=1e-10,
                               atol=1e-14)
    for a, b in zip(ts, js):
        for i in (1, 2, 3):
            if i == 3 and not include_v:
                assert a[i].grad is None
                continue
            np.testing.assert_allclose(a[i].grad.numpy(), np.asarray(b[i]),
                                       rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("kd_type,extra", [("last", 0), ("last", 2),
                                           ("all", 1)])
def test_kl_token_mse(kd_type, extra):
    """A student with `extra` more leading tokens than the teacher."""
    rng = np.random.default_rng(5)
    sl, tl = rng.normal(size=(2, 7)), rng.normal(size=(2, 7))
    st = [rng.normal(size=(2, 6 + extra, 4)) for _ in range(3)]
    tt = [rng.normal(size=(2, 6, 4)) for _ in range(3)]
    with x64():
        want, (jl, js) = jax.value_and_grad(
            lambda a, b: jlosses.kl_token_mse(
                a, b, jnp.asarray(tl), [jnp.asarray(x) for x in tt],
                alpha=0.3, kd_type=kd_type), argnums=(0, 1))(
            jnp.asarray(sl), [jnp.asarray(x) for x in st])
    a, b = _t(sl), [_t(x) for x in st]
    got = kl_token_mse(a, b, torch.from_numpy(tl),
                       [torch.from_numpy(x) for x in tt], alpha=0.3,
                       kd_type=kd_type)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-12 * abs(float(want))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jl), rtol=1e-10,
                               atol=1e-14)
    for u, w in zip(b, js):
        np.testing.assert_allclose(
            np.zeros_like(u.detach().numpy()) if u.grad is None
            else u.grad.numpy(), np.asarray(w), rtol=1e-10, atol=1e-14)


# ----------------------------------------------------------------- Grams
def _assert_close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    tol = 1e-10 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("kind", ["float", "qattention", "qkr"])
def test_attention_grams(kind):
    x = np.random.default_rng(6).normal(size=(B, N, C))
    kw = dict(weight_bits=2, input_bits=2, qqkkvv=True)
    jm, tm = {
        "float": (jattn.Attention(num_heads=H, qqkkvv=True),
                  Attention(C, H, qqkkvv=True)),
        "qattention": (jattn.QAttention(num_heads=H, **kw),
                       QAttention(C, H, N, **kw)),
        "qkr": (jattn.QAttentionQKR(num_heads=H, **kw),
                QAttentionQKR(C, H, N, **kw))}[kind]
    v = jit_x64_init(jm, jax.random.key(0), x, np.float64)
    v = perturb(v, np.random.default_rng(7))
    yj, info_j = jit_x64_apply(jm, v, x)
    load_flax_params(tm.double(), v)
    with torch.no_grad():
        yt, info_t = tm(torch.from_numpy(x), info=True)
        assert torch.equal(tm(torch.from_numpy(x)), yt)
    _assert_close(yt, yj, "out")
    assert len(info_t) == len(info_j) == 4
    for i, (a, b) in enumerate(zip(info_t, info_j)):
        _assert_close(a, b, f"info[{i}]")


def test_frozen_qkr_refuses_grams():
    with pytest.raises(ValueError, match="q/k kernels"):
        QAttentionQKR(C, H, N, weight_bits=32, input_bits=2, frozen_wqk=True,
                      qqkkvv=True)


@pytest.mark.parametrize("family", ["deit", "swin"])
def test_model_aux(family):
    """The models' aux: the per-block infos (None for the quantized Swin
    attentions, as JAX's), the token stream after each block."""
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3))
    if family == "deit":
        tel = dict(qqkkvv=True, return_features=True)
        jm = jdeit.deit_model(NAME, _jax_deit_policy(), **tel)
        tm = create_model(NAME, policy=w2a2_deit_policy(2), device="cpu",
                          **tel)
    else:
        from test_torch_swin_model import _jax_policy
        from ofq_tpu_torch.quant import w2a2_swin_policy
        jm = jswin.swin_model("swin_test", _jax_policy((1, 1)), qqkkvv=True)
        tm = create_model("swin_test", policy=w2a2_swin_policy((1, 1)),
                          device="cpu", qqkkvv=True)
    v = perturb(_jitted_init(jm, x), np.random.default_rng(9))
    with x64_jit():
        yj, aux_j = jax.jit(jm.apply)(to_jax_tree(v, np.float64),
                                      jnp.asarray(x))
    load_flax_params(tm.double(), v)
    with torch.no_grad():
        yt, aux_t = tm(torch.from_numpy(x), aux=True)
    _assert_close(yt, yj, "logits")
    infos_j, infos_t = aux_j, aux_t
    if family == "deit":
        assert set(aux_t) == set(aux_j) == {"attn_infos", "features"}
        infos_j, infos_t = aux_j["attn_infos"], aux_t["attn_infos"]
        for i, (a, b) in enumerate(zip(aux_t["features"],
                                       aux_j["features"])):
            _assert_close(a, b, f"features[{i}]")
    assert len(infos_t) == len(infos_j)
    for i, (a, b) in enumerate(zip(infos_t, infos_j)):
        if b is None:
            assert a is None, i
            continue
        for j, (u, w) in enumerate(zip(a, b)):
            _assert_close(u, w, f"block {i} info[{j}]")


# ------------------------------------------------------------ the steps
def _jax_deit_policy(qk_reparam=True, wq_mode="statsq"):
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=qk_reparam,
                            wq_mode=wq_mode,
                            qmodules=default_deit_qmodules(2))


def step_case(jpol, tpol, *, name=NAME, conf=None, tel=None, depths=None,
              loss_kind="kd_soft_hard", dtype=np.float64):
    """One step of the port and of JAX's `make_train_step` (jitted; x64 on
    for fp64) from the same parameters (random shifts and heads), teacher
    and mid-run Adam state, on one seeded batch: (port metrics, JAX
    metrics, port model, JAX params)."""
    conf, tel = conf or {}, tel or {}
    extra = dict(depths=depths) if depths else {}
    swin = name.startswith("swin")
    make = jswin.swin_model if swin else jdeit.deit_model
    jm = make(name, jpol, **conf, **tel, **extra)
    jt = make(name, **tel, **extra)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3))
    variables = (_with_head if swin else _with_heads)(
        _jitted_init(jm, x), np.random.default_rng(3))
    tvars = perturb(_jitted_init(jt, x), np.random.default_rng(4),
                    scale=0.1)
    variables, tvars = (jax.tree.map(lambda a: np.asarray(a, dtype), t)
                        for t in (variables, tvars))
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    port = create_model(name, policy=tpol, device="cpu", **conf, **tel,
                        **extra).to(tdt)
    load_flax_params(port, variables)
    teacher = create_model(name, policy=QuantPolicy(), device="cpu", **tel,
                           **extra).to(tdt)
    load_flax_params(teacher, tvars["params"])
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-3, **LR),
                         weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    kd = dict(token_kd_alpha=0.3, token_kd_type="all") if (
        loss_kind == "kd_token") else {}
    step = make_train_step(port, opt, teacher=teacher, loss_kind=loss_kind,
                           device="cpu", **kd)
    tx = jax_make_optimizer(jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
                            weight_decay=0.05)
    jstep = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                        loss_kind=loss_kind, **kd))
    batch = _batches(1, dtype)[0]
    with x64_jit() if dtype == np.float64 else contextlib.nullcontext():
        jst = _jax_state(tx, variables, mu, nu, dtype)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.key(0),
                          to_jax_tree(tvars, dtype)["params"])
        jmet = {k: float(v) for k, v in jmet.items()}
        jparams = to_numpy_tree(jst.params["params"])
    state, met = step(state, batch)
    return {k: float(v) for k, v in met.items()}, jmet, port, jparams


def assert_step(met, jmet, port, jparams, *, loss=1e-9, norm=1e-6,
                leaf=1e-9):
    """The fp64 step's limits (module docstring)."""
    assert abs(met["loss"] - jmet["loss"]) <= loss * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        norm * jmet["grad_norm"])
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    want = _flat(jparams)
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / max(1.0,
                                                    float(np.abs(w).max()))
        assert err <= leaf, (k, err)


@pytest.mark.parametrize("loss_kind,tel", [
    ("kd_qk", dict(qqkkvv=True)), ("kd_qkv", dict(qqkkvv=True)),
    ("kd_token", dict(return_features=True))])
def test_telemetry_step_fp64(loss_kind, tel):
    met, jmet, port, jparams = step_case(
        _jax_deit_policy(), w2a2_deit_policy(2), tel=tel,
        loss_kind=loss_kind)
    assert_step(met, jmet, port, jparams)
