"""The fused bf16 slice as a whole against `ofq_tpu`: the
`deit_test_distilled` W2A2 QKR student with `matmul_impl='fused'`,
`attn_impl='fused'` and `compute_dtype='bfloat16'` (K1 in every quantized
linear, K2 forward and K3 backward in the attention tail, in the bf16
stream with fp32 masters), served and taken through one
`make_train_step` step with its bf16 float teacher, KD soft+hard and
AdamW, from the same converted parameters, `quant_stats` and mid-run
Adam state as `test_torch_train_slice.py`.  The port runs its kernels'
plain versions; JAX runs its Pallas kernels in interpret mode, compiled
(jit) as bench.py runs the step.

Products and sums run in other orders on the two sides and XLA fuses
across the stream's bf16 roundings, so a few LSQ levels move and the
random-weight student carries them on (`test_torch_bf16_layers.py`,
`test_torch_pallas_slice.py`).  The limits are those of the pallas bf16
slice test, counted the same way: the share of LSQ outputs on another
level than JAX's in the eval forward at most 0.2 % in the first block
(the same input on both sides; measured 0) and 5 % in all (measured
1.1 %); the logits within a relative L2 distance of 0.1 (measured
0.036); the loss within 2 % (0.01 %); the gradient norm within 20 %
(4.5 %); after the step at most 10 % of the elements (20 % of any one
leaf) differ by more than lr / 4 (0.04 %), none by more than 2.1 * lr,
and at most 0.5 % of the quantized kernels' StatsQ levels differ (0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_pallas_slice import (_codes_port, _flat_paths,
                                     _statsq_levels)
from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, to_jax_tree, to_numpy_tree)
from test_torch_train_loop import (BATCH, DEPTH, NAME, _flat, _jax_policy,
                                   _mid_run_adam, _student_variables,
                                   _teacher_variables)
from test_torch_train_slice import (LR, START, _batches, _jax_state,
                                    _with_heads)

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.nn import quantizers as jquant
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.ops import fused_attention as t_attn
from ofq_tpu_torch.ops import fused_qlinear as t_fq
from ofq_tpu_torch.quant import QuantPolicy, w2a2_qkr_policy
from ofq_tpu_torch.serve import Predictor
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 make_optimizer, make_train_step)

FUSED_BF16 = dict(matmul_impl="fused", attn_impl="fused",
                  compute_dtype="bfloat16")


def _case():
    variables = _with_heads(_student_variables(3, np.float32),
                            np.random.default_rng(3))
    tvars = _teacher_variables(4)
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    port = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                        **FUSED_BF16)
    load_flax_params(port, variables)
    teacher = create_model(NAME, policy=QuantPolicy(), device="cpu",
                           compute_dtype="bfloat16")
    load_flax_params(teacher, tvars["params"])
    teacher.to(torch.bfloat16)  # bench.py's bf16 teacher parameters
    opt = make_optimizer(cosine_with_warmup_cooldown(5e-3, **LR),
                         weight_decay=0.05)
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": START, "mu": mu, "nu": nu},
                           step=START)
    step = make_train_step(port, opt, teacher=teacher,
                           loss_kind="kd_soft_hard", device="cpu")
    return variables, tvars, mu, nu, port, state, step


def _jax_student():
    return jax_deit_model(NAME, _jax_policy(), **FUSED_BF16)


def test_fused_bf16_forward(jax_interpret):
    """The serving forward (eval): bf16 LSQ outputs, counted level moves,
    the logits' relative L2 distance; the kernels' wrappers take their
    plain versions on the CPU and count no launch."""
    variables, *_, port, _, _ = _case()
    x = _batches(1, np.float32)[0]["image"]
    (want, _), inter = jax.jit(lambda v, xx: _jax_student().apply(
        v, xx, train=False, mutable=["intermediates"],
        capture_intermediates=lambda m, n: isinstance(m, jquant.LsqAct)
        and n == "__call__"))(to_jax_tree(variables, np.float32),
                              jnp.asarray(x))
    codes_j = {k.replace("/", ".").rsplit(".__call__", 1)[0]: np.asarray(
        v, np.float32) for k, v in _flat(to_numpy_tree(
            inter["intermediates"])).items()}
    before = (t_fq.fused_qlinear_fwd.launches,
              t_attn.qkr_attention_fwd.launches)
    logits, codes_t = _codes_port(port, x)
    assert before == (t_fq.fused_qlinear_fwd.launches,
                      t_attn.qkr_attention_fwd.launches)
    assert logits.dtype == torch.float32
    # the fused QLinear keeps its input quantizer's parameters but runs
    # no LsqAct module: the LsqActs are the attention chain's and the
    # head's, on both sides
    assert {k.rsplit(".0", 1)[0] for k in codes_j} == set(codes_t)
    moved = {"blocks_0": [0, 0], "all": [0, 0]}
    for k, v in codes_t.items():
        w = codes_j.get(k, codes_j.get(k + ".0"))
        assert v.dtype == torch.bfloat16 or k.startswith("head"), k
        for part in ("all", "blocks_0"):
            if part == "all" or k.startswith(part + "."):
                moved[part][0] += int(np.sum(v.float().numpy() != w))
                moved[part][1] += v.numel()
    share = {k: m / n for k, (m, n) in moved.items()}
    assert moved["blocks_0"][1] > 0
    assert share["blocks_0"] <= 2e-3 and share["all"] <= 5e-2, share
    want = np.asarray(want)
    l2 = float(np.linalg.norm(logits.numpy() - want) / np.linalg.norm(want))
    assert l2 <= 0.1, l2


def test_fused_bf16_train_step(jax_interpret):
    """One QAT step against JAX's compiled step (limits in the module
    docstring); the masters stay fp32."""
    variables, tvars, mu, nu, port, state, step = _case()
    batch = _batches(1, np.float32)[0]
    tx = jax_make_optimizer(
        jschedule.cosine_with_warmup_cooldown(5e-3, **LR), weight_decay=0.05)
    jst = _jax_state(tx, variables, mu, nu, np.float32)
    tparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                           to_jax_tree(tvars, np.float32)["params"])
    jstep = jax_make_train_step(
        _jax_student(), tx,
        teacher=jax_deit_model(NAME, compute_dtype="bfloat16"),
        loss_kind="kd_soft_hard")
    jst, jmet = jax.jit(jstep)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), tparams)
    state, met = step(state, batch)
    jl = float(jmet["loss"])
    assert np.isfinite(float(met["loss"]))
    assert abs(float(met["loss"]) - jl) <= 2e-2 * abs(jl)
    assert abs(float(met["grad_norm"]) - float(jmet["grad_norm"])) <= (
        0.2 * float(jmet["grad_norm"]))
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    got = {k: p.detach().numpy() for k, p in port.named_parameters()}
    want = _flat(to_numpy_tree(jst.params["params"]))
    assert set(got) == set(want)
    far = n = 0
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > lr / 4) <= 0.2, k
        far += int(np.sum(d > lr / 4))
        n += d.size
    assert far <= 0.1 * n, far / n
    lv_t, lv_j = _statsq_levels(got), _statsq_levels(want)
    flips = sum(int(np.sum(lv_t[k] != lv_j[k])) for k in lv_t)
    assert lv_t and flips <= 0.005 * sum(v.size for v in lv_t.values())


def test_predictor_fused_bf16(tmp_path):
    """Serving: `Predictor.from_flax_npz` builds the fused bf16
    configuration; its probabilities are the model's softmax, and the
    attention tail hands bf16 to the fused proj."""
    variables = _student_variables(3, np.float32)
    path = tmp_path / "w.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in _flat_paths(
        variables).items()})
    pred = Predictor.from_flax_npz(
        str(path), model_name=NAME, policy=w2a2_qkr_policy(DEPTH),
        batch_size=BATCH, device="cpu", **FUSED_BF16)
    assert pred.model.compute_dtype == torch.bfloat16
    seen = []
    attn = pred.model.blocks_0.attn
    hook = attn.proj.register_forward_hook(
        lambda mod, a, y: seen.append((a[0].dtype, y.dtype)))
    x = _batches(1, np.float32)[0]["image"][:3]
    probs = pred.predict(x)
    hook.remove()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert probs.shape == (3, 1000) and np.isfinite(probs).all()
    with torch.no_grad():
        want = torch.softmax(pred.model(torch.from_numpy(
            np.pad(x, ((0, BATCH - 3), (0, 0), (0, 0), (0, 0))))), -1)
    np.testing.assert_allclose(probs, want[:3].numpy(), rtol=0, atol=0)
