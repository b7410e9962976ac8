"""One train step of the fused configuration against
`ofq_tpu.train.make_train_step`, in fp32: the port's plain versions of the
kernels (the CPU path of the wrappers) against JAX's Pallas kernels in
interpret mode (its step jitted), from the same parameters, `quant_stats`
and mid-run Adam state as `test_torch_train_slice.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, to_jax_tree, to_numpy_tree)
from test_torch_train_loop import NAME, _flat, _jax_policy
from test_torch_train_slice import LR, START, _batches, _jax_state, _setup

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.train import cosine_with_warmup_cooldown


def test_fused_step_fp32(jax_interpret):
    """One step of the fused configuration in fp32.  The loss and the
    gradient norm agree to 1e-5 relative (products and sums in other
    orders).  AdamW's first-order update is ~ lr * sign(g), so a
    parameter whose gradient is fp32 noise (a shift whose gradient
    cancels to ~0) may step the other way: at most 1 % of a leaf's
    elements may differ by more than 1e-3 * lr + 1e-6 * |p|, and none by
    more than 2.1 * lr."""
    variables, tvars, mu, nu, port, state, step = _setup("fused",
                                                         np.float32)
    batch = _batches(1, np.float32)[0]
    tx = jax_make_optimizer(jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
                            weight_decay=0.05)
    jm = jax_deit_model(NAME, _jax_policy(), matmul_impl="fused",
                        attn_impl="fused")
    jstep = jax.jit(jax_make_train_step(jm, tx, teacher=jax_deit_model(NAME),
                                        loss_kind="kd_soft_hard"))
    jst = _jax_state(tx, variables, mu, nu, np.float32)
    jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(0),
                      to_jax_tree(tvars, np.float32)["params"])
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert abs(float(met["loss"]) - jl) <= 1e-5 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        1e-5 * float(jmet["grad_norm"]))
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    for k, w in _flat(to_numpy_tree(jst.params["params"])).items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k


