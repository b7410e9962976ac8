"""The CGA finetune step as a whole against `ofq_tpu.train.make_train_step
(cga=...)`, on the CPU, from the same converted parameters, `quant_stats`
and mid-run Adam state (and EMA) as `test_torch_train_slice.py`: the
`deit_test_distilled` W2A2 QKR student with `qk_reparam_type=1` and the
finetune's `boundary_range=0.005`, its float teacher, KD soft+hard and the
constant learning rate of the finetune window (2e-3 here rather than the
recipe's min_lr of 1e-5, so that the trainable entries move by more than
the frameworks' rounding and the masks change from step to step).

  * fp64, 3 steps: the masks equal JAX's at every step, no frozen entry
    changes, a frozen entry's moments only decay (its gradient is masked),
    the gradient norm is JAX's (that of the masked gradients, 1e-6), the
    parameters agree to 1e-9 of max(1, |p|) after the first step and 1e-8
    after three (the trajectory tests' limits, `ROADMAP.md` Queue 3 item
    3; measured 4.8e-10, 2.6e-9, 3.6e-9).  The moments hold the gradients
    themselves: after the first step each leaf's within 1e-12 of its
    largest entry (measured 1e-15), but for the LSQ scales and shifts,
    whose gradients both frameworks sum in fp32 (3.9e-7), and from the
    second step on every leaf within 1e-6 (9.4e-7): the steps' parameters
    differ by ~1e-9, and the W2A2 forward's gradients move by ~1e-6 at
    parameters that far apart.  The witness: from JAX's own state before
    steps 2 and 3, one port step's moments agree to 1e-12 (measured
    3.1e-15, 7.1e-16), and from that state nudged by 1e-9 they are 2.7e-6
    and 1.3e-6 away;
  * the fused fp32 and fused bf16 steps: `test_torch_cga_slice_fused.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_common import to_jax_tree, to_numpy_tree, x64
from test_torch_train_loop import (DEPTH, NAME, _flat, _mid_run_adam,
                                   _port_teacher, _student_variables,
                                   _teacher_variables)
from test_torch_train_slice import START, _batches, _with_heads

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu.train import TrainState as JaxTrainState
from ofq_tpu.train import cga as jcga
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_policy
from ofq_tpu_torch.train import (TrainState, constant_lr, freeze_masks,
                                 make_optimizer, make_train_step)

LR = 2e-3
CGA = dict(bits=2, boundary_range=0.005, qk_reparam=True, model_type="deit")
FUSED = dict(matmul_impl="fused", attn_impl="fused")
FUSED_BF16 = dict(FUSED, compute_dtype="bfloat16")


def _jax_policy():
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qk_reparam_type=1, boundary_range=0.005,
                            qmodules=default_deit_qmodules(DEPTH))


def _port_policy():
    return dataclasses.replace(w2a2_qkr_policy(DEPTH), qk_reparam_type=1,
                               boundary_range=0.005)


def _jax_masks(params):
    masks = jcga.freeze_masks(params, bits=2, boundary_range=0.005,
                              qk_reparam=True)
    return {k: v for k, v in _flat(masks).items() if v.dtype != object}


def _port_masks(params):
    """The masks of the masters' >= fp32 view, as the step computes them."""
    views = {k: p.float() if p.dtype == torch.bfloat16 else p
             for k, p in params.items()}
    return {k: m.numpy() for k, m in freeze_masks(
        views, bits=2, boundary_range=0.005, qk_reparam=True).items()
        if m is not None}


def _assert_masks_equal(got, want, what):
    assert set(got) == set(want) and len(got) == 4 * DEPTH, what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    share = np.mean([(m == 0).mean() for m in got.values()])
    assert 0 < share < 0.1, share


def _setup(impl, dtype, *, master_dtype=None, ema=False, clip=None):
    """The port's student (in `impl`'s configuration), teacher, state at
    START with the mid-run moments (and the EMA of the initial masters),
    step, and the numbers it was built from."""
    npdt = np.float64 if dtype == "float64" else np.float32
    variables = _with_heads(_student_variables(3, npdt),
                            np.random.default_rng(3))
    tvars = _teacher_variables(4)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    conf = {None: {}, "fused": FUSED, "fused_bf16": FUSED_BF16}[impl]
    port = create_model(NAME, policy=_port_policy(), device="cpu", **conf)
    if dtype == "float64":
        port.double()
    load_flax_params(port, variables)
    bf16 = conf.get("compute_dtype") == "bfloat16"
    if bf16:
        teacher = create_model(NAME, policy=QuantPolicy(), device="cpu",
                               compute_dtype="bfloat16")
        load_flax_params(teacher, tvars["params"])
        teacher.to(torch.bfloat16)
    else:
        teacher = _port_teacher(tvars).to(next(port.parameters()).dtype)
    opt = make_optimizer(constant_lr(LR), weight_decay=0.05,
                         **({} if clip is None else clip))
    state = TrainState.create(port, opt, ema=ema, master_dtype=master_dtype)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu", cga=CGA,
                           ema_decay=0.9999 if ema else None,
                           master_dtype=master_dtype)
    return variables, tvars, mu, nu, port, state, step


def _jax_state(tx, variables, mu, nu, dtype, *, masters=None, ema=False):
    v = to_jax_tree(variables, dtype)
    if masters is not None:
        v = {**v, "params": jax.tree.map(lambda p: p.astype(masters),
                                         v["params"])}
    st = JaxTrainState.create(v, tx, ema=ema)
    count = jnp.asarray(START, jnp.int32)
    chain = list(st.opt_state)
    adam, masked, sched = chain[-1]
    moments = jnp.float64 if dtype == np.float64 else jnp.float32
    adam = adam._replace(count=count, mu=to_jax_tree(mu, moments),
                         nu=to_jax_tree(nu, moments))
    chain[-1] = (adam, masked, sched._replace(count=count))
    return st.replace(opt_state=tuple(chain), step=count)


def _frozen_kept(before, after, masks):
    for k, m in masks.items():
        frozen = m > 0.5
        np.testing.assert_array_equal(after[k][frozen], before[k][frozen],
                                      err_msg=k)


def _port_values(state):
    return {k: p.detach().float().numpy() if p.dtype == torch.bfloat16
            else p.detach().numpy().copy() for k, p in state.params.items()}


def _rel_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-300)


def test_cga_trajectory_fp64():
    variables, tvars, mu, nu, port, state, step = _setup(None, "float64")
    batches = _batches(3)
    with x64():
        tx = jax_make_optimizer(jschedule.constant_lr(LR), weight_decay=0.05)
        jstep = jax_make_train_step(jax_deit_model(NAME, _jax_policy()), tx,
                                    teacher=jax_deit_model(NAME),
                                    loss_kind="kd_soft_hard", cga=CGA)
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        tparams = to_jax_tree(tvars, np.float64)["params"]
        for i, b in enumerate(batches):
            masks = _port_masks(state.params)
            _assert_masks_equal(masks, _jax_masks(jst.params["params"]),
                                f"step {i}")
            before = _port_values(state)
            mu_before = {k: state.opt_state.mu[k].numpy().copy()
                         for k in masks}
            jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(i), tparams)
            state, m = step(state, b)
            after = _port_values(state)
            _frozen_kept(before, after, masks)
            for k, mk in masks.items():
                frozen = mk > 0.5
                np.testing.assert_array_equal(
                    state.opt_state.mu[k].numpy()[frozen],
                    0.9 * mu_before[k][frozen], err_msg=k)
            jl, tl = float(jm["loss"]), float(m["loss"])
            assert abs(tl - jl) <= 1e-9 * abs(jl), (i, tl, jl)
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
                1e-6 * float(jm["grad_norm"]))
            tol = 1e-9 if i == 0 else 1e-8
            want = _flat(to_numpy_tree(jst.params["params"]))
            adam = jst.opt_state[0][0]
            j_mu, j_nu = (_flat(to_numpy_tree(t)) for t in (adam.mu, adam.nu))
            err = 0.0
            for k, w in want.items():
                err = max(err, float(np.abs(after[k] - w).max()) / max(
                    1.0, float(np.abs(w).max())))
                for got_m, want_m in ((state.opt_state.mu[k], j_mu[k]),
                                      (state.opt_state.nu[k], j_nu[k])):
                    e = _rel_err(got_m.numpy(), want_m)
                    fp32_sums = k.endswith(".s") or "move" in k
                    assert e <= (1e-12 if i == 0 and not fp32_sums
                                 else 1e-6), (i, k, e)
            assert err <= tol, (i, err)
            assert state.step == int(jst.step) == START + i + 1
    # the trainable entries moved
    assert any(np.any(before[k] != after[k]) for k in masks)


def _load_jax_state(port, state, jst):
    """The port's model and optimizer state set to JAX's `jst` (parameters,
    quant_stats, moments, count, step), through `convert.py`."""
    load_flax_params(port, to_numpy_tree(jst.params))
    load_optax_adamw_state(state, jst.opt_state[0][0], step=int(jst.step))


def _moment_errs(state, jst):
    """Each moment leaf's error against JAX's, relative to its largest
    entry: (the largest over the leaves summed in fp64, over the LSQ scales
    and shifts whose gradients both frameworks sum in fp32)."""
    adam = jst.opt_state[0][0]
    j_mu, j_nu = (_flat(to_numpy_tree(t)) for t in (adam.mu, adam.nu))
    errs = [0.0, 0.0]
    for k in j_mu:
        fp32_sums = k.endswith(".s") or "move" in k
        for got, want in ((state.opt_state.mu[k], j_mu[k]),
                          (state.opt_state.nu[k], j_nu[k])):
            errs[fp32_sums] = max(errs[fp32_sums],
                                  _rel_err(got.numpy(), want))
    return errs


def test_cga_step_from_jax_state_fp64():
    """The witness for the trajectory test's moment limit from its second
    step on.  From JAX's own state before steps 2 and 3 (carried across by
    `convert.py`), one port step agrees with JAX's as the first step does:
    the moments within 1e-12 of each leaf's largest entry (but the fp32-
    summed LSQ scales and shifts, 1e-6) and the parameters within 1e-9.
    The same step from that state with the parameters nudged by 1e-9 of
    max(1, |p|) (the first step's parameter gap) moves the moments by more
    than 1e-8, a thousand times the steps' own difference: the trajectory's
    moment gap is the W2A2 forward's sensitivity to its parameters, not a
    difference between the frameworks' steps."""
    variables, tvars, mu, nu, port, state, step = _setup(None, "float64")
    batches = _batches(3)
    rng = np.random.default_rng(11)
    with x64():
        tx = jax_make_optimizer(jschedule.constant_lr(LR), weight_decay=0.05)
        jstep = jax_make_train_step(jax_deit_model(NAME, _jax_policy()), tx,
                                    teacher=jax_deit_model(NAME),
                                    loss_kind="kd_soft_hard", cga=CGA)
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        tparams = to_jax_tree(tvars, np.float64)["params"]
        for i, b in enumerate(batches):
            nxt, _ = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.key(i), tparams)
            if i:
                _load_jax_state(port, state, jst)
                state, _ = step(state, b)
                same = _moment_errs(state, nxt)
                want = _flat(to_numpy_tree(nxt.params["params"]))
                p_err = max(float(np.abs(state.params[k].detach().numpy()
                                         - w).max()) / max(
                    1.0, float(np.abs(w).max())) for k, w in want.items())
                _load_jax_state(port, state, jst)
                with torch.no_grad():
                    for p in port.parameters():
                        scale = max(1.0, float(p.abs().max()))
                        p.add_(torch.from_numpy(rng.uniform(
                            -1e-9, 1e-9, p.shape)) * scale)
                state, _ = step(state, b)
                nudged = _moment_errs(state, nxt)
                print(f"step {i + 1} from JAX's state: moments {same}, "
                      f"parameters {p_err:.3g}; nudged by 1e-9: moments "
                      f"{nudged}")
                assert same[0] <= 1e-12 and same[1] <= 1e-6, (i, same)
                assert p_err <= 1e-9, (i, p_err)
                assert nudged[0] > 1e-8 and nudged[0] > 1e3 * same[0], (
                    i, nudged, same)
            jst = nxt
