"""The Swin train step against `ofq_tpu.train.make_train_step`, on the CPU:
the `swin_test` W2A2 QKR student (`w2a2_qkr_swin_policy`) with its float
Swin teacher and KD soft+hard on non-distilled logits, at depths (1, 1)
and (2, 2) (the second block of each stage shifted: the shift mask's
gradient path), from the same converted parameters, `quant_stats` and
mid-run Adam state in both frameworks.  JAX's steps are jitted (x64 on for
the fp64 ones).

  * composed fp64, 3 steps: the limits of the DeiT trajectory
    (`test_torch_train_slice.py`): the loss within 1e-9 relative, the
    gradient norm 1e-6, every parameter within 1e-9 of max(1, its largest
    magnitude) after the first step and 1e-8 after three, named for the
    relative-position bias tables (their gradient a scatter-add of the
    gathered bias's in both frameworks) and the patch-merging reductions'
    LSQ scales, each of which must have moved.  At (2, 2) one leaf leaves
    1e-8 in steps 2 and 3, and JAX's own step moves it as far from a
    state 3.2e-10 apart in the one fp32-summed leaf that differs most
    (the witness, `test_shifted_trajectory_fp64`); each of those steps
    from JAX's own state agrees within 1e-9;
  * the pallas and int8 steps: `test_torch_swin_train_steps.py`;
  * the CGA finetune step (`cga=dict(..., model_type="swin")`,
    `qk_reparam_type=1`, boundary 0.005, a constant 2e-3 so that the masks
    move), 3 fp64 steps at `test_torch_cga_slice.py`'s limits: the masks
    equal JAX's at every step (the `reduction` kernels among them), no
    frozen entry changes, a frozen entry's first moment only decays; then
    JAX's state after the steps carried across by `convert.py`'s loaders,
    the moments equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dropout import _jitted_init, x64_jit
from test_torch_port_common import perturb, to_jax_tree, to_numpy_tree
from test_torch_swin_model import _jax_policy, _with_head
from test_torch_train_loop import _flat, _mid_run_adam
from test_torch_train_slice import LR, START, _batches, _jax_state

from ofq_tpu.models import swin as jswin
from ofq_tpu.train import cga as jcga
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_swin_policy
from ofq_tpu_torch.train import (TrainState, constant_lr,
                                 cosine_with_warmup_cooldown, freeze_masks,
                                 make_optimizer, make_train_step)

NAME = "swin_test"
CGA_LR = 2e-3
CGA = dict(bits=2, boundary_range=0.005, qk_reparam=True, model_type="swin")


def _jax_models(depths, conf, cga):
    pol = _jax_policy(depths)
    if cga:
        pol = dataclasses.replace(pol, qk_reparam_type=1)
    cd = dict(compute_dtype=conf["compute_dtype"]) if conf.get(
        "compute_dtype") else {}
    return (jswin.swin_model(NAME, pol, depths=depths, **conf),
            jswin.swin_model(NAME, depths=depths, **cd))


@functools.lru_cache(maxsize=None)
def _jax_step(depths, conf_items, cga):
    """JAX's optimizer and jitted step of a configuration, built once per
    module, so each configuration compiles once."""
    jm, jt = _jax_models(depths, dict(conf_items), cga)
    jsched = (jschedule.constant_lr(CGA_LR) if cga
              else jschedule.cosine_with_warmup_cooldown(5e-3, **LR))
    tx = jax_make_optimizer(jsched, weight_decay=0.05)
    return tx, jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                           loss_kind="kd_soft_hard",
                                           cga=CGA if cga else None))


def _case(depths, dtype, conf=None, cga=False):
    """Variables, teacher variables and moments (numpy, `dtype`), the
    port's student, state and step, the JAX models and optimizer."""
    conf = conf or {}
    jm, jt = _jax_models(depths, conf, cga)
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3))
    variables = _with_head(_jitted_init(jm, x), np.random.default_rng(3))
    tvars = perturb(_jitted_init(jt, x), np.random.default_rng(4))
    variables = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
    tvars = jax.tree.map(lambda a: np.asarray(a, dtype), tvars)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    tdt = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    pol = w2a2_qkr_swin_policy(depths)
    if cga:
        pol = dataclasses.replace(pol, qk_reparam_type=1)
    port = create_model(NAME, policy=pol, device="cpu", depths=depths,
                        **conf).to(tdt)
    load_flax_params(port, variables)
    cd = conf.get("compute_dtype")
    teacher = create_model(NAME, policy=QuantPolicy(), device="cpu",
                           depths=depths, compute_dtype=cd).to(tdt)
    load_flax_params(teacher, tvars["params"])
    if cd:
        teacher.to(torch.bfloat16)  # bench.py's bf16 teacher parameters
    sched = (constant_lr(CGA_LR) if cga
             else cosine_with_warmup_cooldown(5e-3, **LR))
    opt = make_optimizer(sched, weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu",
                           cga=CGA if cga else None)
    tx, jstep = _jax_step(depths, tuple(sorted(conf.items())), cga)
    tparams = jax.tree.map(
        lambda p: jnp.asarray(p, jnp.bfloat16 if cd else p.dtype),
        tvars["params"])
    return dict(variables=variables, mu=mu, nu=nu, port=port, state=state,
                step=step, jm=jm, tx=tx, jstep=jstep, tparams=tparams)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _errors(port, jparams):
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    want = _flat(to_numpy_tree(jparams))
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - w).max()) / max(
        1.0, float(np.abs(w).max())) for k, w in want.items()}


def _named(errs):
    """The relative-position bias tables and the reductions' LSQ scales."""
    tables = [k for k in errs if k.endswith("relative_position_bias_table")]
    red = [k for k in errs if ".reduction.input_quant.s" in k]
    return tables, red


# ------------------------------------------------------ composed, fp64
def _composed_steps(depths, *, from_jax_state=False, witness=False):
    """3 composed fp64 steps of both frameworks; with `from_jax_state`
    the port starts steps 2 and 3 from JAX's state (`convert.py`).
    Returns each step's per-leaf errors (and with `witness`, JAX's own
    per-leaf move after step 2 when only the head's weight-LSQ scale
    takes the port's value after step 1)."""
    out, moves = [], None
    with x64_jit():
        c = _case(depths, np.float64)
        jst = _jax_state(c["tx"], c["variables"], c["mu"], c["nu"],
                         np.float64)
        p0 = {k: p.detach().clone() for k, p in c["port"].named_parameters()}
        port, state = c["port"], c["state"]
        batches = _batches(3)
        for i, b in enumerate(batches):
            if from_jax_state and i > 0:
                load_flax_params(port, to_numpy_tree(jst.params))
                load_optax_adamw_state(state, jst.opt_state[0][0],
                                       step=int(jst.step))
            if witness and i == 1:
                s_head = port.head.weight_quant.s.detach().numpy().copy()
                jprev = jst
            jst, jmet = c["jstep"](jst, _jax_batch(b), jax.random.key(i),
                                   c["tparams"])
            state, met = c["step"](state, b)
            jl, tl = float(jmet["loss"]), float(met["loss"])
            assert abs(tl - jl) <= 1e-9 * abs(jl), (i, tl, jl)
            assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])
                       ) <= 1e-6 * float(jmet["grad_norm"])
            assert state.step == int(jst.step) == START + i + 1
            out.append(_errors(port, jst.params["params"]))
            if witness and i == 1:
                params = to_numpy_tree(jprev.params["params"])
                params["head"]["weight_quant"]["s"] = s_head
                swapped = jprev.replace(params={
                    **jprev.params, "params": to_jax_tree(params,
                                                          np.float64)})
                other, _ = c["jstep"](swapped, _jax_batch(b),
                                      jax.random.key(i), c["tparams"])
                moves = _errors_between(other.params["params"],
                                        jst.params["params"])
    moved = {k: not torch.equal(p0[k], p) for k, p in
             port.named_parameters()}
    return out, moves, moved


def _errors_between(a, b):
    fa, fb = (_flat(to_numpy_tree(t)) for t in (a, b))
    return {k: float(np.abs(fa[k] - fb[k]).max()) / max(
        1.0, float(np.abs(fb[k]).max())) for k in fb}


def _assert_named(errs, depths, tol, moved, what):
    tables, red = _named(errs)
    assert len(tables) == sum(depths) and len(red) == 1
    for k in tables + red:
        assert errs[k] <= tol, (what, k, errs[k])
        assert moved[k], k
    bad = {k: e for k, e in errs.items() if e > tol}
    assert not bad, (what, bad)


@pytest.mark.parametrize("depths", [(1, 1), (2, 2)])
def test_composed_steps_fp64(depths):
    """(1, 1): the trajectory, every leaf within 1e-9 after the first step
    and 1e-8 after the next two (measured 7.1e-10, 1.0e-9, 1.4e-9).
    (2, 2): the first step from the common start and the next two each
    from JAX's own state, every leaf within 1e-9 (measured 3.2e-10,
    3.7e-10, 5.3e-10); its trajectory: `test_shifted_trajectory_fp64`."""
    errs, _, moved = _composed_steps(depths,
                                     from_jax_state=depths == (2, 2))
    for i, e in enumerate(errs):
        tol = 1e-9 if i == 0 or depths == (2, 2) else 1e-8
        _assert_named(e, depths, tol, moved, f"step {i}")


def test_shifted_trajectory_fp64():
    """The (2, 2) trajectory: the first step within 1e-9 (the named leaves
    too); after the next two, every leaf within 1e-8 but those that JAX's
    own second step moves by more than 1e-8 when only the head's
    weight-LSQ scale takes the port's first-step value (3.2e-10 relative
    apart: both frameworks sum its gradient in fp32, in other orders),
    which may be at most twice that move away.  Measured: one leaf,
    features_3_0.mlp.fc2.kernel, 1.46e-8 / 1.48e-8 after steps 2 / 3,
    JAX's own move 1.46e-8; every other leaf at most 1.74e-9."""
    errs, moves, moved = _composed_steps((2, 2), witness=True)
    _assert_named(errs[0], (2, 2), 1e-9, moved, "step 0")
    chaotic = {k for k, m in moves.items() if m > 1e-8}
    assert chaotic == {"features_3_0.mlp.fc2.kernel"}, chaotic
    for i, e in enumerate(errs[1:], 1):
        for k, err in e.items():
            limit = 2 * moves[k] if k in chaotic else 1e-8
            assert err <= limit, (i, k, err, limit)


# ------------------------------------------------------------- CGA
def _port_masks(params):
    return {k: m.numpy() for k, m in freeze_masks(
        dict(params), bits=2, boundary_range=0.005, qk_reparam=True,
        model_type="swin").items() if m is not None}


def _jax_masks(params):
    masks = jcga.freeze_masks(params, bits=2, boundary_range=0.005,
                              qk_reparam=True, model_type="swin")
    return {k: v for k, v in _flat(masks).items() if v.dtype != object}


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-300)


def test_cga_trajectory_fp64():
    """3 CGA steps of the Swin student at the limits of
    `test_torch_cga_slice.test_cga_trajectory_fp64`, and JAX's state
    after them loaded through `convert.py` (parameters and moments)."""
    depths = (2, 2)
    with x64_jit():
        c = _case(depths, np.float64, cga=True)
        jst = _jax_state(c["tx"], c["variables"], c["mu"], c["nu"],
                         np.float64)
        port, state = c["port"], c["state"]
        for i, b in enumerate(_batches(3)):
            masks = _port_masks(state.params)
            want_masks = _jax_masks(jst.params["params"])
            assert set(masks) == set(want_masks)
            assert len(masks) == 4 * sum(depths) + 1
            assert "features_2.reduction.kernel" in masks
            for k in want_masks:
                np.testing.assert_array_equal(masks[k], want_masks[k],
                                              err_msg=f"step {i} {k}")
            share = np.mean([(m == 0).mean() for m in masks.values()])
            assert 0 < share < 0.1, share
            before = {k: p.detach().numpy().copy()
                      for k, p in state.params.items()}
            mu_before = {k: state.opt_state.mu[k].numpy().copy()
                         for k in masks}
            jst, jmet = c["jstep"](jst, _jax_batch(b), jax.random.key(i),
                                   c["tparams"])
            state, met = c["step"](state, b)
            after = {k: p.detach().numpy() for k, p in state.params.items()}
            for k, m in masks.items():
                frozen = m > 0.5
                np.testing.assert_array_equal(after[k][frozen],
                                              before[k][frozen], err_msg=k)
                np.testing.assert_array_equal(
                    state.opt_state.mu[k].numpy()[frozen],
                    0.9 * mu_before[k][frozen], err_msg=k)
            jl, tl = float(jmet["loss"]), float(met["loss"])
            assert abs(tl - jl) <= 1e-9 * abs(jl), (i, tl, jl)
            assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])
                       ) <= 1e-6 * float(jmet["grad_norm"])
            errs = _errors(port, jst.params["params"])
            tol = 1e-9 if i == 0 else 1e-8
            assert max(errs.values()) <= tol, (i, max(errs, key=errs.get))
            adam = jst.opt_state[0][0]
            j_mu, j_nu = (_flat(to_numpy_tree(t)) for t in (adam.mu,
                                                            adam.nu))
            for k in j_mu:
                fp32_sums = k.endswith(".s") or "move" in k
                for got_m, want_m in ((state.opt_state.mu[k], j_mu[k]),
                                      (state.opt_state.nu[k], j_nu[k])):
                    e = _rel_err(got_m.numpy(), want_m)
                    assert e <= (1e-12 if i == 0 and not fp32_sums
                                 else 1e-6), (i, k, e)
        assert any(np.any(before[k] != after[k]) for k in masks)
        # JAX's Swin state through the loaders the DeiT CGA tests use
        load_flax_params(port, to_numpy_tree(jst.params))
        load_optax_adamw_state(state, jst.opt_state[0][0],
                               step=int(jst.step))
        assert state.step == int(jst.step) and state.opt_state.count == (
            int(jst.opt_state[0][0].count))
        for k in j_mu:
            np.testing.assert_array_equal(state.opt_state.mu[k].numpy(),
                                          j_mu[k])
            np.testing.assert_array_equal(state.opt_state.nu[k].numpy(),
                                          j_nu[k])
        assert max(_errors(port, jst.params["params"]).values()) == 0
