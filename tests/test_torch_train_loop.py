"""The training layer against `ofq_tpu.train`, in fp64 (x64 on the JAX
side): losses, schedule, the weight-decay mask, AdamW against
`optax.adamw`, the optimizer-state carrier and the float teacher.  The
train step as a whole is in `test_torch_train_slice.py`.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_common import (jit_x64_apply, jit_x64_init,
                                    jitted_init, perturb, to_jax_tree,
                                    to_numpy_tree, x64)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu.train import losses as jlosses
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import optim as joptim
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import (flatten_flax_tree, load_flax_params,
                                   load_optax_adamw_state)
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_policy
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 global_norm, hard_ce, kd_soft_and_hard,
                                 make_optimizer, make_train_step, soft_ce,
                                 wd_mask)

NAME = "deit_test_distilled"
DEPTH, IMG, CLASSES, BATCH = 2, 32, 1000, 4


# ---------------------------------------------------------------- losses
def _logits(seed, shape=(5, 7)):
    return np.random.default_rng(seed).normal(size=shape) * 3


@pytest.mark.parametrize("temperature", [1.0, 2.5])
def test_soft_ce(temperature):
    s, t = _logits(0), _logits(1)
    with x64():
        want = float(jlosses.soft_ce(jnp.asarray(s), jnp.asarray(t),
                                     temperature))
    got = float(soft_ce(torch.from_numpy(s), torch.from_numpy(t),
                        temperature))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("soft_targets", [False, True])
def test_hard_ce(label_smoothing, soft_targets):
    x = _logits(2)
    rng = np.random.default_rng(3)
    y = (rng.dirichlet(np.ones(7), size=5) if soft_targets
         else rng.integers(0, 7, size=5))
    with x64():
        want = float(jlosses.hard_ce(jnp.asarray(x), jnp.asarray(y),
                                     label_smoothing))
    got = float(hard_ce(torch.from_numpy(x), torch.from_numpy(y),
                        label_smoothing))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("distilled", [True, False])
def test_kd_soft_and_hard_and_its_gradient(distilled):
    c, d, t = _logits(4), _logits(5), _logits(6)
    y = np.random.default_rng(7).integers(0, 7, size=5)
    with x64():
        def jf(c, d):
            out = (c, d) if distilled else c
            return jlosses.kd_soft_and_hard(out, jnp.asarray(y),
                                            jnp.asarray(t))
        want, (gc, gd) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(c), jnp.asarray(d))
    tc, td = (torch.from_numpy(a).requires_grad_() for a in (c, d))
    got = kd_soft_and_hard((tc, td) if distilled else tc,
                           torch.from_numpy(y), torch.from_numpy(t))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-12 * abs(float(want))
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), rtol=1e-10,
                               atol=1e-14)
    if distilled:
        np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd),
                                   rtol=1e-10, atol=1e-14)


# ------------------------------------------------- schedule, mask, AdamW
SCHED = dict(epochs=300, warmup_epochs=5, warmup_lr=1e-6, min_lr=1e-5)


def test_schedule_matches_jax():
    """float32 on both sides: the warmup branch is exact; the cosine
    branch's float32 cos may differ by an ulp (rtol 3e-7)."""
    jf = jschedule.cosine_with_warmup_cooldown(5.47e-4, **SCHED)
    tf = cosine_with_warmup_cooldown(5.47e-4, **SCHED)
    assert tf(0) == float(jf(0)) == float(np.float32(1e-6))
    for t in (1, 2, 4, 5, 6, 150, 299, 300, 301, 1000):
        want = float(jf(t))
        if t < SCHED["warmup_epochs"]:
            assert tf(t) == want, t
        else:
            assert abs(tf(t) - want) <= 3e-7 * want, t


@functools.lru_cache(maxsize=None)
def _student_variables_once(seed, dtype):
    x = np.random.default_rng(seed).normal(size=(BATCH, IMG, IMG, 3))
    jm = jax_deit_model(NAME, _jax_policy())
    v = jitted_init(jm)(
        jax.random.key(seed), jnp.asarray(x, jnp.float32))
    return to_numpy_tree(v, dtype)


def _student_variables(seed=0, dtype=np.float64):
    """The JAX student's variables, made by a jitted float32 init (scales
    calibrated on a seeded batch), cast to `dtype`; computed once per seed
    and dtype (a copy each call)."""
    return copy.deepcopy(_student_variables_once(seed, np.dtype(dtype)))


def _jax_policy():
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qmodules=default_deit_qmodules(DEPTH))


def test_wd_mask_matches_jax():
    variables = _student_variables()
    want = {k.replace("/", "."): bool(v) for k, v in flatten_flax_tree(
        joptim.wd_mask(variables["params"])).items()}
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu")
    got = wd_mask(dict(m.named_parameters()))
    assert got == want
    assert any(got.values()) and not all(got.values())
    assert not got["pos_embed"] and not got["patch_embed.move_b4.bias"]
    assert got["blocks_0.attn.q_kernel"]


def _adam_case(seed):
    rng = np.random.default_rng(seed)
    params = {"blocks_0": {"attn": {"q_kernel": rng.normal(size=(4, 4)),
                                    "quant_x": {"s": rng.random(4) + .1}},
                           "mlp": {"fc1": {"bias": rng.normal(size=4)}}},
              "pos_embed": rng.normal(size=(1, 3, 4)),
              "patch_embed": {"move_b4": {"bias": rng.normal(size=(2, 2))}},
              "head": {"kernel": rng.normal(size=(4, 5))}}
    grads = [jax.tree.map(lambda p: rng.normal(size=np.shape(p)) *
                          10.0 ** rng.integers(-9, 1), params)
             for _ in range(4)]
    return params, grads


def _flat(tree):
    return {k.replace("/", "."): v for k, v in
            flatten_flax_tree(tree).items()}


def test_adamw_matches_optax():
    """Four AdamW updates in fp64 (gradients spanning 1e-9 to 1, so eps
    matters): updates, moments and count against `optax.adamw` with the
    JAX package's mask, and the learning rate at step 0."""
    params, grads = _adam_case(0)
    lr_calls = []

    def jlr(count):
        lr_calls.append(int(count))
        return jschedule.cosine_with_warmup_cooldown(5e-2, **SCHED)(count)

    with x64():
        tx = jax_make_optimizer(jlr, weight_decay=0.05)
        jp = to_jax_tree(params, np.float64)
        st = tx.init(jp)
        jupd = []
        for g in grads:
            u, st = tx.update(to_jax_tree(g, np.float64), st, jp)
            jupd.append(_flat(to_numpy_tree(u)))
        adam = st[0][0]
        j_mu, j_nu = _flat(to_numpy_tree(adam.mu)), _flat(
            to_numpy_tree(adam.nu))
        j_count = int(adam.count)
    assert lr_calls[0] == 0

    opt = make_optimizer(cosine_with_warmup_cooldown(5e-2, **SCHED),
                         weight_decay=0.05)
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    state = opt.init(tp)
    for g, want in zip(grads, jupd):
        upd, state = opt.update(
            {k: torch.from_numpy(v) for k, v in _flat(g).items()}, state,
            tp)
        for k in want:
            np.testing.assert_allclose(upd[k].numpy(), want[k], rtol=1e-12,
                                       atol=0, err_msg=k)
    assert state.count == j_count == 4
    for k in j_mu:
        np.testing.assert_allclose(state.mu[k].numpy(), j_mu[k], rtol=1e-13,
                                   atol=0, err_msg=k)
        np.testing.assert_allclose(state.nu[k].numpy(), j_nu[k], rtol=1e-13,
                                   atol=0, err_msg=k)
    # the first update used the schedule's value at count 0
    first = opt.update({k: torch.ones_like(v) for k, v in tp.items()},
                       opt.init(tp), tp)[0]
    np.testing.assert_allclose(first["blocks_0.mlp.fc1.bias"].numpy(),
                               -float(np.float32(1e-6)) * np.ones(4) / (
                                   1 + 1e-8), rtol=1e-12)


def test_global_norm_matches_optax():
    _, grads = _adam_case(1)
    with x64():
        want = float(optax.global_norm(to_jax_tree(grads[0], np.float64)))
    got = float(global_norm(torch.from_numpy(v) for v in
                            _flat(grads[0]).values()))
    assert abs(got - want) <= 1e-13 * want


def test_clipping_and_unported_options_raise():
    """A clipping mode or a loss that JAX does not have raises as JAX's
    does, and an oscillation hook without `bits` raises (the hook, once
    refused, steps: `test_torch_oscillation_hook.py`; the telemetry
    losses: `test_torch_kd_telemetry.py`)."""
    with pytest.raises(ValueError, match="clip_mode"):
        make_optimizer(lambda c: 1e-3, clip_grad=1.0, clip_mode="global")
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu")
    opt = make_optimizer(lambda c: 1e-3)
    with pytest.raises(ValueError, match="bits"):
        make_train_step(m, opt, teacher=m, device="cpu", oscillation={})
    with pytest.raises(ValueError, match="loss_kind"):
        make_train_step(m, opt, teacher=m, device="cpu", loss_kind="kd_x")


@pytest.mark.parametrize("field", ["drop_rate", "attn_drop_rate",
                                   "drop_path_rate"])
def test_dropout_step_takes_a_generator(field):
    """Each dropout rate (once refused, Queue 1 item 1): the step raises
    without a generator and steps with one."""
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                     **{field: 0.1})
    opt = make_optimizer(lambda c: 1e-3)
    step = make_train_step(m, opt, teacher=_port_teacher(
        _teacher_variables()).float(), device="cpu")
    state = TrainState.create(m, opt)
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32), "label": rng.integers(0, CLASSES, size=BATCH)}
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        step(state, batch)
    state, met = step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(met["loss"]))


# ------------------------------------------------------------ the teacher
@functools.lru_cache(maxsize=None)
def _teacher_variables_once(seed):
    x = np.zeros((1, IMG, IMG, 3))
    v = jit_x64_init(jax_deit_model(NAME), jax.random.key(seed), x,
                     np.float64, train=False)
    return perturb(v, np.random.default_rng(seed), scale=0.1)


def _teacher_variables(seed=1):
    """The float teacher's variables (a jitted init under x64, the biases
    drawn from the seed), computed once per seed (a copy each call)."""
    return copy.deepcopy(_teacher_variables_once(seed))


def _port_teacher(variables):
    t = create_model(NAME, policy=QuantPolicy(), device="cpu").double()
    return load_flax_params(t, variables)


def test_float_teacher_logits():
    """deit_test_distilled with the empty policy, fp64, parameters
    carried by load_flax_params; eval returns (cls + dist) / 2, train the
    pair."""
    variables = _teacher_variables()
    x = np.random.default_rng(2).normal(size=(BATCH, IMG, IMG, 3))
    jm = jax_deit_model(NAME)
    ev, _ = jit_x64_apply(jm, variables, x, train=False)
    (cl, dl), _ = jit_x64_apply(jm, variables, x, train=True)
    t = _port_teacher(variables)
    assert not list(t.buffers())
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
        t.train()
        c, d = t(torch.from_numpy(x))
    assert np.abs(np.asarray(ev)).max() > 1e-2
    np.testing.assert_allclose(got, np.asarray(ev), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(cl), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(d.numpy(), np.asarray(dl), rtol=1e-10,
                               atol=1e-12)


START = 2


def _mid_run_adam(params, rng):
    """Seeded moments (nu > 0) for a run that took START steps."""
    mu = jax.tree.map(lambda p: rng.normal(size=np.shape(p)) * 1e-3, params)
    nu = jax.tree.map(lambda p: rng.random(size=np.shape(p)) * 1e-6, params)
    return mu, nu


def test_optax_state_loader_is_strict():
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu")
    state = TrainState.create(m, make_optimizer(lambda c: 1e-3))
    params = _student_variables()["params"]
    mu, nu = _mid_run_adam(params, np.random.default_rng(0))
    load_optax_adamw_state(state, {"count": np.int32(7), "mu": mu,
                                   "nu": nu})
    assert state.opt_state.count == 7
    k = "blocks_1.attn.quan_qkx.s"
    np.testing.assert_array_equal(state.opt_state.nu[k].numpy(),
                                  _flat(nu)[k].astype(np.float32))
    del mu["pos_embed"]
    with pytest.raises(ValueError, match="missing.*pos_embed"):
        load_optax_adamw_state(state, {"count": 1, "mu": mu, "nu": nu})
