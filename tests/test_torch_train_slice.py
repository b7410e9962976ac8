"""The train step as a whole against `ofq_tpu.train.make_train_step`.

  * the trajectory: 3 steps of the composed `deit_test_distilled` W2A2 QKR
    student with its float teacher and `kd_soft_hard`, both frameworks
    started from the same converted parameters, `quant_stats` and
    mid-run Adam state.  The losses agree to 1e-9 relative; every
    parameter leaf to 1e-9 of max(1, its largest magnitude) after the
    first step and 1e-8 after the next two.  Both frameworks sum the LSQ
    scale and shift gradients in fp32 (JAX does so under x64 too), in
    other orders; Adam turns those ~1e-7 relative differences into
    ~1e-10 parameter differences at the first step, and the next steps'
    forward and normalised updates grow them (measured on this case:
    2.5e-10, 2.7e-9, 4.1e-9);
  * one step of the fused configuration: `test_torch_train_slice_fused.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_port_common import perturb, to_jax_tree, to_numpy_tree, x64
from test_torch_train_loop import (BATCH, CLASSES, DEPTH, IMG, NAME, _flat,
                                   _jax_policy, _mid_run_adam, _port_teacher,
                                   _student_variables, _teacher_variables)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import TrainState as JaxTrainState
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import w2a2_qkr_policy
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 make_optimizer, make_train_step)

LR = dict(epochs=300, warmup_epochs=8, warmup_lr=1e-4, min_lr=1e-5)
START = 2  # mid-run: Adam count and step


def _with_heads(variables, rng):
    out = perturb(variables, rng)
    for h in ("head", "head_dist"):
        k = out["params"][h]["kernel"]
        out["params"][h]["kernel"] = rng.normal(size=k.shape) * 0.2
    return out


def _batches(n, dtype=np.float64):
    rng = np.random.default_rng(42)
    return [{"image": rng.normal(size=(BATCH, IMG, IMG, 3)).astype(dtype),
             "label": rng.integers(0, CLASSES, size=BATCH)}
            for _ in range(n)]


def _jax_state(tx, variables, mu, nu, dtype):
    st = JaxTrainState.create(to_jax_tree(variables, dtype), tx)
    adam, masked, sched = st.opt_state[0]
    count = jnp.asarray(START, jnp.int32)
    adam = adam._replace(count=count, mu=to_jax_tree(mu, dtype),
                         nu=to_jax_tree(nu, dtype))
    return st.replace(opt_state=((adam, masked, sched._replace(count=count)),),
                      step=count)


def _setup(impl, dtype):
    variables = _with_heads(_student_variables(3, dtype),
                            np.random.default_rng(3))
    tvars = _teacher_variables(4)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    port = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                        matmul_impl=impl, attn_impl=impl).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    load_flax_params(port, variables)
    teacher = _port_teacher(tvars).to(next(port.parameters()).dtype)
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-3, **LR),
                         weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu")
    return variables, tvars, mu, nu, port, state, step


def _assert_leaves(port, want_params, want_stats, tol, what):
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    want = _flat(want_params)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= tol, f"{what}: {k} differs by {err:.3e}"
    for k, w in _flat(want_stats).items():
        assert float(dict(port.named_buffers())[k]) == float(w), k


def test_composed_trajectory_fp64():
    variables, tvars, mu, nu, port, state, step = _setup(None, np.float64)
    batches = _batches(3)
    with x64():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
            weight_decay=0.05)
        jstep = jax_make_train_step(jax_deit_model(NAME, _jax_policy()), tx,
                                    teacher=jax_deit_model(NAME),
                                    loss_kind="kd_soft_hard")
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        tparams = to_jax_tree(tvars, np.float64)["params"]
        for i, b in enumerate(batches):
            jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(i), tparams)
            state, m = step(state, b)
            jl, tl = float(jm["loss"]), float(m["loss"])
            assert abs(tl - jl) <= 1e-9 * abs(jl), (i, tl, jl)
            # the norm takes in the LSQ-scale and shift gradients, which
            # both sides sum in fp32 (in other orders)
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
                1e-6 * float(jm["grad_norm"]))
            assert state.opt_state.count == int(jst.opt_state[0][0].count)
            assert state.step == int(jst.step) == START + i + 1
            _assert_leaves(port, to_numpy_tree(jst.params["params"]),
                           to_numpy_tree(jst.params["quant_stats"]),
                           1e-9 if i == 0 else 1e-8, f"step {i}")
    assert float(port.patch_embed.input_quant.signed) == 1.0
