"""The CGA finetune step in the fused configurations against
`ofq_tpu.train.make_train_step(cga=...)`, on the CPU, from
`test_torch_cga_slice.py`'s start (the `deit_test_distilled` W2A2 QKR
student with `qk_reparam_type=1`, boundary 0.005, its float teacher, KD
soft+hard, the constant learning rate 2e-3, mid-run Adam state):

  * one step of the fused fp32 configuration through the plain versions of
    K1-K3, against JAX's Pallas kernels in interpret mode, at
    `test_torch_train_slice_fused.py`'s limits;
  * one step of the fused bf16 stream with bf16 masters, an EMA and AGC,
    against JAX's compiled step, at the bf16 slice tests' limits
    (`test_torch_fused_bf16_slice.py`) plus one bf16 ulp of the master for
    the rounding of the updated value.

Split from `test_torch_cga_slice.py`, unchanged, so that the two files run
on two test workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_cga_slice import (CGA, FUSED, FUSED_BF16, LR,
                                  _assert_masks_equal, _frozen_kept,
                                  _jax_masks, _jax_policy, _jax_state,
                                  _port_masks, _port_values, _setup)
from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, to_jax_tree, to_numpy_tree)
from test_torch_train_loop import NAME, _flat
from test_torch_train_slice import _batches

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_ema_params


def test_cga_fused_step_fp32(jax_interpret):
    """One step through K1-K3's plain versions against JAX's fused step in
    interpret mode (jitted), fp32: loss and gradient norm within 1e-5 relative, at
    most 1 % of a leaf's elements more than 1e-3 * lr + 1e-6 * |p| apart,
    none more than 2.1 * lr; the masks equal JAX's and no frozen entry
    moves."""
    variables, tvars, mu, nu, port, state, step = _setup("fused", "float32")
    batch = _batches(1, np.float32)[0]
    tx = jax_make_optimizer(jschedule.constant_lr(LR), weight_decay=0.05)
    jstep = jax.jit(jax_make_train_step(
        jax_deit_model(NAME, _jax_policy(), **FUSED), tx,
        teacher=jax_deit_model(NAME), loss_kind="kd_soft_hard", cga=CGA))
    jst = _jax_state(tx, variables, mu, nu, np.float32)
    masks = _port_masks(state.params)
    _assert_masks_equal(masks, _jax_masks(jst.params["params"]), "fused")
    before = _port_values(state)
    jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(0),
                      to_jax_tree(tvars, np.float32)["params"])
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 1e-5 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        1e-5 * float(jmet["grad_norm"]))
    got = _port_values(state)
    _frozen_kept(before, got, masks)
    for k, w in _flat(to_numpy_tree(jst.params["params"])).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * LR, k
        assert np.mean(d > 1e-3 * LR + 1e-6 * np.abs(w)) <= 0.01, k


def test_cga_fused_bf16_step_bf16_masters_ema_agc(jax_interpret):
    """One step of the fused bf16 stream with bf16 masters, EMA 0.9999 and
    AGC 0.01 against JAX's compiled step.  The masters stay bf16, the
    moments and the EMA fp32; the masks (from the same bf16 masters) equal
    JAX's; no frozen entry moves; the loss within 2 %, the gradient norm
    (bf16 sums on both sides) within 20 %; after the step each master at
    most 2.1 * lr plus one bf16 ulp from JAX's, at most 20 % of a leaf's
    (10 % of all) elements more than lr / 4 apart; the EMA is the update
    of the port's own masters, and within 1e-4 of that distance of
    JAX's."""
    variables, tvars, mu, nu, port, state, step = _setup(
        "fused_bf16", "float32", master_dtype="bfloat16", ema=True,
        clip=dict(clip_grad=0.01, clip_mode="agc"))
    batch = _batches(1, np.float32)[0]
    tx = jax_make_optimizer(jschedule.constant_lr(LR), weight_decay=0.05,
                            clip_grad=0.01, clip_mode="agc")
    jst = _jax_state(tx, variables, mu, nu, np.float32, masters=jnp.bfloat16,
                     ema=True)
    load_ema_params(state, to_numpy_tree(jst.ema_params))
    ema0 = {k: v.clone() for k, v in state.ema_params.items()}
    jstep = jax_make_train_step(
        jax_deit_model(NAME, _jax_policy(), **FUSED_BF16), tx,
        teacher=jax_deit_model(NAME, compute_dtype="bfloat16"),
        loss_kind="kd_soft_hard", cga=CGA, ema_decay=0.9999,
        master_dtype="bfloat16")
    masks = _port_masks(state.params)
    _assert_masks_equal(masks, _jax_masks(jst.params["params"]), "bf16")
    before = _port_values(state)
    tparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                           to_jax_tree(tvars, np.float32)["params"])
    jst, jmet = jax.jit(jstep)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), tparams)
    state, met = step(state, batch)
    assert all(p.dtype == torch.bfloat16 for p in state.params.values())
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(state.opt_state.mu[k].dtype == torch.float32 and
               state.ema_params[k].dtype == torch.float32
               for k in state.params)
    jl = float(jmet["loss"])
    assert np.isfinite(float(met["loss"]))
    assert abs(float(met["loss"]) - jl) <= 2e-2 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        0.2 * float(jmet["grad_norm"]))
    got = _port_values(state)
    _frozen_kept(before, got, masks)
    for k, p in port.named_parameters():
        assert torch.equal(p, state.params[k].float()), k
    want = {k: np.asarray(v, np.float32) for k, v in
            _flat(to_numpy_tree(jst.params["params"])).items()}
    assert set(got) == set(want)
    far = n = moved = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        ulp = np.abs(w) * 2.0 ** -7
        assert np.all(d <= 2.1 * LR + ulp), k
        assert np.mean(d > LR / 4) <= 0.2, k
        far += int(np.sum(d > LR / 4))
        n += d.size
        moved += int(np.sum(got[k] != before[k]))
    assert far <= 0.1 * n, far / n
    assert moved > 0
    j_ema = _flat(to_numpy_tree(jst.ema_params))
    for k, e in state.ema_params.items():
        mine = 0.9999 * ema0[k] + (1.0 - 0.9999) * state.params[k].float()
        assert torch.equal(e, mine), k
        d = np.abs(e.numpy() - j_ema[k])
        assert np.all(d <= 1e-4 * (2.1 * LR + np.abs(j_ema[k]) * 2.0 ** -7)
                      + np.spacing(np.abs(j_ema[k]))), k
